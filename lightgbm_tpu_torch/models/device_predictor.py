"""Tree-parallel inference engine (counterpart of
lightgbm_tpu/models/device_predictor.py; gbdt_prediction.cpp role).

The host predictor (`models/tree.py`) is the exactness reference (f64
thresholds, byte-parity with the reference CLI).  This one trades f32
thresholds for device throughput, with the JAX engine's design:

- **Tree-parallel traversal.**  All T trees advance one level per step
  over an `[N, T]` node frontier, every gather batched over the tree
  axis.  The loop runs the packed trees' max leaf depth, not
  num_leaves - 1.
- **Flattened branchless node table.**  Internal nodes and leaves share
  one absolute index space of `(L-1) + L` slots per tree; child pointers
  are resolved to flat ids at pack time and leaves loop onto themselves,
  so a step is gather -> compare -> pick child.
- **Categorical splits** as fixed-width bitset words `[T, S, W]`, held in
  int64 (uint32 has few CUDA ops in torch): `(word >> (v & 31)) & 1` sees
  no sign bit.
- **Index dtype.**  torch's gathers take int64 indices, so the node table
  and the frontier are int64: an `[N, T]` frontier holds twice the bytes
  of the JAX engine's int32 one, and no step casts.
- **Per-class sum in a fixed order.**  Tree t adds to class t % K, one
  iteration at a time from the first (also the order of the prediction
  early-stop scan), so a row's output does not depend on how many rows
  share its batch (a reduction over the tree axis may pick its order by
  the tensor's size).
- **Prediction early stop** (prediction_early_stop.cpp): binary margin
  2|s|, multiclass top-1 - top-2, checked every `early_freq` iterations;
  a row that clears the margin adds nothing more.
- **Optional int8 leaf values** (`leaf_quant="int8"`, staged behind
  `LEAF_QUANT_VALIDATED`, default off): an int8 table with a per-tree f32
  scale, stochastically rounded with a seeded torch generator
  (`ops/quantize.stochastic_round`), so its values differ from the JAX
  engine's (jax.random), within the same grid bound.
- **Row buckets and programs.**  Row counts pad up to powers of two; each
  (bucket, early-stop mode, frequency) is one program with static input
  and output buffers.  On the card a program is captured once as a CUDA
  graph (`runtime/graphs.py`, site `predictor.tree_parallel`; the JAX
  engine's program cache per bucket), and the graphs of one predictor
  share one memory pool; ragged batches pad into the static input and
  replay.  On the CPU the same functions run eagerly.
- **Micro-batching with double buffering** on the card: pinned host
  buffers and a copy stream, so the next batch's upload and the last
  one's download overlap the current batch; one blocking wait per
  micro-batch, for its output (`runtime/syncs.wait_event`,
  `predict_fetch`).

`batch_hook(i, n)` fires before each micro-batch: the batch-boundary seam
that the JAX package's serving faults use (its `resilience` module has no
counterpart in this package yet).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops.quantize import stochastic_round
from ..runtime import graphs, syncs

_K_ZERO_THRESHOLD = 1e-35
MISSING_NONE, MISSING_ZERO, MISSING_NAN = 0, 1, 2

#: staged flag: int8-quantized leaf values in the device predictor.  OFF
#: -> Booster.predict(device=True) runs the f32 leaf table.  ON ->
#: DevicePredictor defaults to leaf_quant="int8" (leaf_quant="none"
#: opts out).
LEAF_QUANT_VALIDATED = False

#: the seed of the int8 table's stochastic rounding
_LEAF_QUANT_SEED = 0


def _tree_depth(t) -> int:
    """Max leaf depth from child pointers.  Node indices are creation
    order, so an internal child always has a larger index than its
    parent (tree.h Split) and one in-order pass settles every depth."""
    ni = t.num_leaves - 1
    if ni <= 0:
        return 0
    depth = np.zeros(ni, np.int64)
    max_leaf = 1
    for node in range(ni):
        d = depth[node] + 1
        for child in (int(t.left_child[node]), int(t.right_child[node])):
            if child >= 0:
                if child <= node:   # malformed pointers: keep the safe bound
                    return ni
                depth[child] = d
            else:
                max_leaf = max(max_leaf, d)
    return int(max_leaf)


def pack_trees(trees, num_leaves_cap: int):
    """Stack tree SoA arrays to [T, L-1] / [T, L] (inert padding), plus
    fixed-width categorical bitset words when the slice has categorical
    splits.  Returns (arrays: Dict[str, np.ndarray], max_depth)."""
    T = len(trees)
    L = max(num_leaves_cap, 2)
    feat = np.zeros((T, L - 1), np.int32)
    thr = np.zeros((T, L - 1), np.float32)
    miss = np.zeros((T, L - 1), np.int32)
    dleft = np.zeros((T, L - 1), bool)
    left = np.full((T, L - 1), -1, np.int32)
    right = np.full((T, L - 1), -1, np.int32)
    leaf = np.zeros((T, L), np.float32)
    is_cat = np.zeros((T, L - 1), bool)
    depth = 0
    W = 0
    for t in trees:
        if t.num_cat > 0:
            for node in range(t.num_leaves - 1):
                if t.decision_type[node] & 1:
                    W = max(W, len(t.cat_words_for_node(node)))
    catw = np.zeros((T, L - 1, W), np.uint32) if W else None
    for i, t in enumerate(trees):
        ni = max(t.num_leaves - 1, 0)
        if ni:
            feat[i, :ni] = t.split_feature[:ni]
            thr[i, :ni] = t.threshold[:ni]
            dt = t.decision_type[:ni]
            miss[i, :ni] = (dt >> 2) & 3
            dleft[i, :ni] = (dt & 2) != 0
            left[i, :ni] = t.left_child[:ni]
            right[i, :ni] = t.right_child[:ni]
            if t.num_cat > 0:
                is_cat[i, :ni] = (dt & 1) != 0
                for node in np.nonzero(is_cat[i, :ni])[0]:
                    words = t.cat_words_for_node(int(node))
                    catw[i, node, :len(words)] = words
        leaf[i, : t.num_leaves] = t.leaf_value[: t.num_leaves]
        depth = max(depth, _tree_depth(t))
    out = {"feat": feat, "thr": thr, "miss": miss, "dleft": dleft,
           "left": left, "right": right, "leaf": leaf}
    if W:
        out["is_cat"] = is_cat
        out["catw"] = catw
    return out, depth


def _flatten_packed(packed, leaf_quant: Optional[str] = None):
    """Flatten [T, L-1]/[T, L] packed trees into one branchless node
    table of S = (L-1) + L slots per tree (internal nodes first, then
    leaves).  Child pointers are resolved to ABSOLUTE flat indices
    (internal child c -> base + c, leaf ~c -> base + NI + c) and every
    leaf slot is a self-loop (left = right = itself, threshold +inf).
    With leaf_quant="int8" the value table is int8 with a per-tree f32
    scale (stochastic rounding, ops/quantize's max-scaling)."""
    feat, thr = packed["feat"], packed["thr"]
    T, NI = feat.shape
    L = packed["leaf"].shape[1]
    S = NI + L
    base = (np.arange(T, dtype=np.int64) * S)[:, None]
    out = {"feat": np.zeros((T, S), np.int64),
           "thr": np.full((T, S), np.inf, np.float32),
           "miss": np.zeros((T, S), np.int8),
           "dleft": np.zeros((T, S), bool)}
    out["feat"][:, :NI] = feat
    out["thr"][:, :NI] = thr
    out["miss"][:, :NI] = packed["miss"]
    out["dleft"][:, :NI] = packed["dleft"]
    self_idx = base + np.arange(S, dtype=np.int64)[None, :]
    for name in ("left", "right"):
        dst = self_idx.copy()
        c = packed[name].astype(np.int64)
        dst[:, :NI] = np.where(c >= 0, c, NI + ~c) + base
        out[name] = dst
    value = np.zeros((T, S), np.float32)
    value[:, NI:] = packed["leaf"]
    if leaf_quant == "int8":
        amax = np.abs(value).max(axis=1)
        # per-tree max-scaling; an all-zero tree gets scale 1 so the
        # division is always finite
        scale = (np.where(amax > 0, amax, 127.0) / 127.0).astype(np.float32)
        gen = torch.Generator().manual_seed(_LEAF_QUANT_SEED)
        q = stochastic_round(torch.from_numpy(value / scale[:, None]), gen,
                             -127.0, 127.0)
        out["value_q"] = q.numpy().astype(np.int8)
        out["scale"] = scale
    else:
        out["value"] = value
    if "catw" in packed:
        W = packed["catw"].shape[-1]
        is_cat = np.zeros((T, S), bool)
        is_cat[:, :NI] = packed["is_cat"]
        catw = np.zeros((T, S, W), np.int64)
        catw[:, :NI] = packed["catw"]
        out["is_cat"], out["catw"] = is_cat, catw
    return out


def _predict_tree_parallel(arrs: Dict[str, torch.Tensor], X: torch.Tensor,
                           margin: torch.Tensor, *, num_class: int,
                           depth_iters: int, early_mode: Optional[str],
                           early_freq: int) -> torch.Tensor:
    """[N, num_class] f32 raw scores of X [N, F] f32.  arrs: the flat
    node table on X's device (`_flatten_packed`'s [T, S] arrays); margin:
    a 0-d f32 tensor.  Reads nothing on the host, so a CUDA graph can
    hold it."""
    N = X.shape[0]
    T, S = arrs["feat"].shape
    K = num_class
    feat = arrs["feat"].reshape(-1)
    thr = arrs["thr"].reshape(-1)
    miss = arrs["miss"].reshape(-1)
    dleft = arrs["dleft"].reshape(-1)
    left = arrs["left"].reshape(-1)
    right = arrs["right"].reshape(-1)
    has_cat = "catw" in arrs
    if has_cat:
        is_cat = arrs["is_cat"].reshape(-1)
        W = arrs["catw"].shape[-1]
        catw = arrs["catw"].reshape(-1)          # [T * S * W]
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    minus_one = torch.full((), -1.0, dtype=X.dtype, device=X.device)

    # roots are each tree's internal slot 0; one trip minimum so a
    # single-leaf tree (root's children point at its leaf 0 slot) still
    # lands on a value slot
    node = (torch.arange(T, dtype=torch.int64, device=X.device) * S)[None, :] \
        .expand(N, T)
    for _ in range(max(depth_iters, 1)):
        fv = torch.gather(X, 1, torch.take(feat, node))     # [N, T]
        mt = torch.take(miss, node)
        is_nan = torch.isnan(fv)
        fv2 = torch.where(is_nan & (mt != MISSING_NAN), zero, fv)
        missing = ((mt == MISSING_ZERO)
                   & (torch.abs(fv2) <= _K_ZERO_THRESHOLD)) \
            | ((mt == MISSING_NAN) & is_nan)
        go_left = torch.where(missing, torch.take(dleft, node),
                              fv2 <= torch.take(thr, node))
        if has_cat:
            # tree.h CategoricalDecision: NaN -> right (missing NaN) or
            # category 0; negative / beyond the node's bitset -> right
            iv = torch.where(is_nan, torch.where(mt == MISSING_NAN,
                                                 minus_one, zero), fv)
            in_range = torch.isfinite(iv) & (iv >= 0) & (iv < W * 32.0)
            v = torch.clamp(iv, 0.0, W * 32.0 - 1.0).to(torch.int64)
            word = torch.take(catw, node * W + (v >> 5))
            bit = (word >> (v & 31)) & 1
            go_left = torch.where(torch.take(is_cat, node),
                                  in_range & (bit == 1), go_left)
        node = torch.where(go_left, torch.take(left, node),
                           torch.take(right, node))
    if "value_q" in arrs:
        # int8 leaves: dequantized at the final gather only
        vals = (torch.take(arrs["value_q"].reshape(-1), node)
                .to(torch.float32) * arrs["scale"][None, :])
    else:
        vals = torch.take(arrs["value"].reshape(-1), node)   # [N, T]

    # per-class sum, trees iteration-major (tree t -> class t % K), one
    # iteration at a time in a fixed order
    vals_k = vals.reshape(N, T // K, K)
    out = torch.zeros((N, K), dtype=torch.float32, device=X.device)
    if early_mode is None:
        for it in range(T // K):
            out += vals_k[:, it]
        return out
    # prediction early stop (prediction_early_stop.cpp, vectorized): add
    # per iteration, check the margin every early_freq iterations, and
    # stop accumulating the rows that cleared it
    active = torch.ones((N, 1), dtype=torch.float32, device=X.device)
    for it in range(T // K):
        out += vals_k[:, it] * active
        if (it + 1) % early_freq == 0:
            if early_mode == "binary":
                m = 2.0 * torch.abs(out[:, :1])
            else:
                top2 = torch.topk(out, 2, dim=1).values
                m = top2[:, :1] - top2[:, 1:]
            active = torch.where(m > margin, zero, active)
    return out


def _predict_packed_scan(arrs: Dict[str, torch.Tensor], X: torch.Tensor, *,
                         num_class: int, depth_iters: int) -> torch.Tensor:
    """The engine before the tree-parallel one (sequential over trees,
    num_leaves - 1 steps each), kept as the A/B reference for the tests.
    Numeric splits only; arrs are `pack_trees`' [T, L-1] / [T, L]."""
    N = X.shape[0]
    K = num_class
    T = arrs["feat"].shape[0]
    score = torch.zeros((N, K), dtype=torch.float32, device=X.device)
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    for t in range(T):
        node = torch.zeros(N, dtype=torch.int64, device=X.device)
        for _ in range(depth_iters):
            active = node >= 0
            nd = torch.clamp(node, min=0)
            f = arrs["feat"][t][nd]
            fv = torch.gather(X, 1, f[:, None])[:, 0]
            mt = arrs["miss"][t][nd]
            is_nan = torch.isnan(fv)
            fv2 = torch.where(is_nan & (mt != MISSING_NAN), zero, fv)
            missing = ((mt == MISSING_ZERO)
                       & (torch.abs(fv2) <= _K_ZERO_THRESHOLD)) \
                | ((mt == MISSING_NAN) & is_nan)
            go_left = torch.where(missing, arrs["dleft"][t][nd],
                                  fv2 <= arrs["thr"][t][nd])
            child = torch.where(go_left, arrs["left"][t][nd],
                                arrs["right"][t][nd])
            node = torch.where(active, child, node)
        leaf_idx = ~torch.clamp(node, max=-1)
        score[:, t % K] += arrs["leaf"][t][leaf_idx]
    return score


def _bucket_rows(n: int) -> int:
    """Pad a row count up to its power-of-two bucket so ragged batches
    share programs (min bucket 16)."""
    return max(16, 1 << (max(n - 1, 1)).bit_length())


def _default_batch_rows(num_trees: int) -> int:
    """Micro-batch so the [N, T] traversal buffers stay device-sized:
    ~2^24 cells per buffer, power-of-two rows, capped at 2^20."""
    rows = max((1 << 24) // max(num_trees, 1), 256)
    return min(1 << (rows.bit_length() - 1), 1 << 20)


class _Program:
    """One (bucket, early-stop mode, frequency): static input, margin and
    output buffers and the traversal that reads and writes them, captured
    as a CUDA graph on the card and run eagerly on the CPU."""

    def __init__(self, pred: "DevicePredictor", bucket: int,
                 early_mode: Optional[str], early_freq: int):
        dev = pred.device
        f32 = dict(dtype=torch.float32, device=dev)
        self.X = torch.zeros((bucket, pred.num_features), **f32)
        self.margin = torch.zeros((), **f32)
        self.out = torch.zeros((bucket, pred.num_class), **f32)

        def run() -> None:
            self.out.copy_(_predict_tree_parallel(
                pred._arrs, self.X, self.margin, num_class=pred.num_class,
                depth_iters=pred.depth_iters, early_mode=early_mode,
                early_freq=early_freq))

        self.site = graphs.Site("predictor.tree_parallel", run,
                                dev.type == "cuda", pool=pred._pool)


class DevicePredictor:
    """Packs a model once; predicts [N, F] matrices on `device` (the card,
    or the CPU when asked)."""

    def __init__(self, model, start_iteration: int = 0,
                 num_iteration: int = -1,
                 batch_rows: Optional[int] = None,
                 leaf_quant: Optional[str] = None, *, device):
        if leaf_quant not in (None, "int8"):
            raise ValueError("leaf_quant must be None or 'int8', got %r"
                             % (leaf_quant,))
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DevicePredictor on %s but no CUDA device is "
                               "available" % self.device)
        k = model.num_tree_per_iteration
        end = model.num_prediction_iterations(start_iteration, num_iteration)
        trees = model.trees[start_iteration * k:
                            (start_iteration + end) * k]
        L = max((t.num_leaves for t in trees), default=2)
        packed, depth = pack_trees(trees, L)
        self.leaf_quant = leaf_quant
        # the per-tree layout for the scan engine (A/B reference); the
        # device holds only the flat table
        self._packed = packed
        flat = _flatten_packed(packed, leaf_quant)
        on_card = self.device.type == "cuda"
        # on the card from pinned memory: the copies do not wait for the
        # stream, so a predictor made inside a call syncs nothing
        self._arrs = {kk: (torch.from_numpy(v).pin_memory() if on_card
                           else torch.from_numpy(v))
                      .to(self.device, non_blocking=True)
                      for kk, v in flat.items()}
        self.num_class = k
        self.depth_iters = depth
        self.num_trees = len(trees)
        self.num_features = model.max_feature_idx + 1
        self.batch_rows = batch_rows or _default_batch_rows(self.num_trees)
        # scan-engine bound: num_leaves - 1 covers any path
        self._scan_depth_iters = max(L - 1, 0)
        self._programs: Dict[tuple, _Program] = {}
        #: micro-batches run since the predictor was made
        self.micro_batches = 0
        self._pool = torch.cuda.graph_pool_handle() if on_card else None
        self._copy_stream = torch.cuda.Stream(self.device) if on_card \
            else None
        self._staging = None

    def capture_count(self) -> int:
        """Programs built: one per (bucket, early-stop mode, frequency)
        met so far, each captured once as a CUDA graph on the card (the
        counterpart of the JAX engine's trace_count)."""
        return len(self._programs)

    # -- internals -----------------------------------------------------------
    def _check_width(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float32)
        if X.ndim != 2 or X.shape[1] < self.num_features:
            # a gather past the matrix would read another row's values,
            # not raise
            raise ValueError("input has %d features, model needs %d"
                             % (X.shape[-1], self.num_features))
        return np.ascontiguousarray(X[:, :self.num_features])

    def _program(self, n: int, early_mode, early_freq) -> _Program:
        key = (_bucket_rows(n), early_mode, early_freq)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = _Program(self, *key)
        return prog

    def _stage_buffers(self, rows: int):
        """Two pinned host and two device slots each for the input and
        the output, kept for the next call."""
        if self._staging is None or self._staging["rows"] < rows:
            f32 = dict(dtype=torch.float32)
            nf, k = self.num_features, self.num_class

            def two(shape, **kw):
                return [torch.empty(shape, **f32, **kw) for _ in range(2)]

            self._staging = dict(
                rows=rows,
                h_in=two((rows, nf), pin_memory=True),
                d_in=two((rows, nf), device=self.device),
                h_out=two((rows, k), pin_memory=True),
                d_out=two((rows, k), device=self.device),
                ev_in=[torch.cuda.Event() for _ in range(2)],
                ev_out=[torch.cuda.Event() for _ in range(2)],
                ev_done=torch.cuda.Event())
        return self._staging

    def _run_cpu(self, X, slices, early, freq, margin, batch_hook, out):
        for i, (s, e) in enumerate(slices):
            if batch_hook is not None:
                batch_hook(i, len(slices))
            prog = self._program(e - s, early, freq)
            prog.X[:e - s].copy_(torch.from_numpy(X[s:e]))
            prog.margin.fill_(margin)
            prog.site()
            self.micro_batches += 1
            out[s:e] = prog.out[:e - s].numpy()

    def _run_card(self, X, slices, early, freq, margin, batch_hook, out):
        """Double-buffered: batch i+1's upload (copy stream) and batch
        i-1's download overlap batch i's graph (current stream); the host
        waits once per batch, for its output."""
        st = self._stage_buffers(max(e - s for s, e in slices))
        compute = torch.cuda.current_stream(self.device)
        copy = self._copy_stream

        def stage(i):
            # the pinned slot was last read by batch i-2's upload, which
            # the copy stream ran before batch i-2's download, waited for
            s, e = slices[i]
            slot = i % 2
            st["h_in"][slot][:e - s].numpy()[:] = X[s:e]
            with torch.cuda.stream(copy):
                st["d_in"][slot][:e - s].copy_(st["h_in"][slot][:e - s],
                                               non_blocking=True)
                st["ev_in"][slot].record(copy)

        def fetch(i):
            s, e = slices[i]
            slot = i % 2
            syncs.wait_event(st["ev_out"][slot], "predict_fetch")
            out[s:e] = st["h_out"][slot][:e - s].numpy()

        stage(0)
        for i, (s, e) in enumerate(slices):
            if batch_hook is not None:
                batch_hook(i, len(slices))
            n, slot = e - s, i % 2
            prog = self._program(n, early, freq)
            compute.wait_event(st["ev_in"][slot])
            prog.X[:n].copy_(st["d_in"][slot][:n])
            prog.margin.fill_(margin)
            prog.site()
            st["d_out"][slot][:n].copy_(prog.out[:n])
            st["ev_done"].record(compute)
            copy.wait_event(st["ev_done"])
            with torch.cuda.stream(copy):
                st["h_out"][slot][:n].copy_(st["d_out"][slot][:n],
                                            non_blocking=True)
                st["ev_out"][slot].record(copy)
            self.micro_batches += 1
            if i > 0:
                fetch(i - 1)
            if i + 1 < len(slices):
                stage(i + 1)
        fetch(len(slices) - 1)

    # -- public --------------------------------------------------------------
    def predict_raw(self, X: np.ndarray, early_stop: Optional[str] = None,
                    early_stop_freq: int = 10,
                    early_stop_margin: float = 10.0,
                    batch_hook: Optional[Callable[[int, int], None]] = None,
                    out_dtype=np.float64) -> np.ndarray:
        """Raw margin scores [N, num_class].  early_stop: None, 'binary'
        or 'multiclass' (the host predictor's truncated sums).

        The engine computes in f32; `out_dtype=np.float32` returns that
        result, and the f64 surface is its exact upcast.  Per-row outputs
        do not depend on the micro-batching or the bucket."""
        X = self._check_width(X)
        N = X.shape[0]
        freq = max(int(early_stop_freq), 1)
        if early_stop not in ("binary", "multiclass"):
            early_stop = None
        out = np.empty((N, self.num_class), out_dtype)
        if N == 0:
            return out
        bs = self.batch_rows
        slices = [(s, min(s + bs, N)) for s in range(0, N, bs)]
        run = self._run_card if self.device.type == "cuda" else self._run_cpu
        run(X, slices, early_stop, freq, float(early_stop_margin),
            batch_hook, out)
        return out

    def predict_raw_scan(self, X: np.ndarray) -> np.ndarray:
        """The scan engine, for A/B checks only (numeric models; no
        buckets, no micro-batching)."""
        if "catw" in self._packed:
            raise ValueError("the scan engine has no categorical support")
        X = torch.from_numpy(self._check_width(X)).to(self.device)
        arrs = {kk: torch.from_numpy(
            self._packed[kk].astype(np.int64) if kk in ("feat", "left",
                                                        "right")
            else self._packed[kk]).to(self.device)
            for kk in ("feat", "thr", "miss", "dleft", "left", "right",
                       "leaf")}
        out = _predict_packed_scan(arrs, X, num_class=self.num_class,
                                   depth_iters=self._scan_depth_iters)
        return out.cpu().numpy().astype(np.float64)
