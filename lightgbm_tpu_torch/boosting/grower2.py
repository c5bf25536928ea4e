"""Partitioned leaf-wise tree grower (counterpart of lightgbm_tpu/boosting/grower2.py).

Rows of every leaf are kept physically contiguous in a payload matrix
(DataPartition, src/treelearner/data_partition.hpp): each split stably
partitions only the split leaf's rows, only the smaller child's histogram
is built from rows, and the sibling comes from subtraction
(serial_tree_learner.cpp:447-544).  Histogram and partition go through
ops/cuda_segment.py: hand-written kernels for CUDA tensors, the plain
PyTorch versions for CPU tensors.

Wide payloads: the f32 histogram and the one-leaf loop's partition go
by width through `cuda_segment.histogram_route` (B1, or the
column-block B7 from 889 features) and `partition_route` (B2, the RMW
B3 from a payload width of 513, the column-block B8 from 1665), the
kernels the JAX grower picks at those widths.  The quantized histogram
(B4) and the frontier rounds (B5, B2's stage and commit) serve every
width, as in the JAX package, whose column-block engine has no int32 or
batched sibling.  `grow.hist_engine` / `grow.part_engine` name the
wrappers chosen.

The port covers the serial path and the JAX grower's mesh modes (the
distributed learners over a torch.distributed group: `mode=` below),
with numerical and categorical splits (the split's bitset rides the leaf
records into every
partition's predicate), in f32 or quantized (int32 histograms,
dequantized at the split search), one leaf per round or
frontier-batched, with the JAX grower's three histogram modes, and
with forced splits (f32 only) and monotone constraints as predicated
per-leaf state of the one-leaf step (`CON_COLS`; either turns the
frontier off, as in the JAX grower).

A tree is one device program, as in the JAX package, whose tree is one
`lax.while_loop`: nothing in it reads the device from the host.  The
state lives on the device in buffers made once per payload: one f32 row
of records per leaf (`LEAF_COLS`: its totals, creation value, depth,
parent and best split; leaf and node ids are exact in f32) and its
int32 segment (`SEG`: the start and count of its rows, exact at any row
count), one f32 row per node (`NODE_COLS`), the bitsets, the histograms
and the leaf count.  Two steps run on it:

- the root (site `grower2.root`): the state's reset, the root histogram
  and its split search;
- the split step, repeated up to L - 1 times: one leaf per round (site
  `grower2.split`, the JAX package's `body`) or a frontier round (site
  `grower2.round`, its `round_body`).  A step whose loop condition fails
  (the JAX `loop_cond`: num_leaves < L and a positive gain) is a no-op:
  every kernel gets count 0 and every write is predicated.

Modes of the one-leaf step (the leaf of the largest gain, argmax on the
device):
- per-leaf state (the default): one `[G, B, 3]` histogram per leaf (G
  storage columns: the features, or their EFB bundles); a
  split builds the smaller child from rows and the sibling by
  subtraction from the parent's;
- the LRU pool (`GrowerConfig.hist_pool_slots`, from
  histogram_pool_size; HistogramPool, feature_histogram.hpp:655-826):
  fewer slots than leaves, the left child takes its parent's slot, the
  right the least recently used one (argmin / evict on the device, the
  JAX package's :666-689), and a split whose parent was evicted rebuilds
  the parent's histogram from its contiguous rows: the rebuild always
  launches, with count 0 when the parent's slot is live;
- merged (`merged_hist`): each split partitions the leaf and takes
  both children's histograms from one kernel (B6,
  `cuda_segment.partition_segment_hist`), so no histogram state, parent
  or subtraction is kept.  Past B6's gate the split partitions through
  the route and walks both children (the JAX package's part_hist_fn).

Frontier-batched (`GrowerConfig.frontier_batch` = K > 1): each round
stages the partitions of the K best frontier leaves, builds the K smaller
children's histograms in ONE batched launch, searches the 2K children at
once, then replays the sequential grower's argmax order on the device
(the JAX package's commit_body: K small steps, each predicated on
whether it commits) and copies back the committed candidates' rows
(count 0 for the others).  Models are byte-identical to K = 1.

The driver (`_drive`): on the card each step is captured once as a CUDA
graph (runtime/graphs.py; `jit=False` runs the same steps eagerly) and
replayed.  Each step writes whether the next one would split into pinned
host memory; the host keeps at most STEPS_AHEAD steps enqueued and stops
once an event recorded after a step has completed with the flag clear
(`Event.query`, never a synchronize), so a tree that stops early runs at
most STEPS_AHEAD no-op steps.  A meshed grower's steps are generators
that yield at each exchange; each piece between exchanges is captured as
its own graph (`graphs.Site`), and the host reads the stop flag after
each step (`_drive_meshed`).  On the CPU the steps run eagerly and the
driver reads the flag (a CPU tensor) after each.  A program built for a
new payload is a build of site ``grower2.program`` in the program ledger
(runtime/graph_obs.py), and each capture a build of its step's site.
"""
from __future__ import annotations

import collections
import functools
import time
from types import SimpleNamespace
from typing import NamedTuple

import torch

from ..ops import cuda_segment
from ..ops.bundle import (BundleMap, expand_histogram, histogram_expansion,
                          identity_bundle_map)
from ..ops.segment import (GUARD, SplitPredicate, cells_to_hist,
                           payload_col_write)
from ..ops.split import (FeatureMeta, K_MIN_SCORE, dequantize_hist,
                         evaluate_split_at, find_best_split_batched,
                         leaf_output, localize_col, pack_split,
                         pad_feature_meta, per_feature_best_gains,
                         pick_winner, slice_feature_meta, unpack_split)
from ..parallel import comm
from ..runtime import graph_obs, graphs


class GrowerConfig(NamedTuple):
    """Static scalars of one grower (the JAX package's GrowerConfig,
    without the knobs of paths this package does not port, plus the
    quantized / qmax arguments of its make_partitioned_grower)."""
    num_leaves: int
    max_depth: int
    lambda_l1: float
    lambda_l2: float
    max_delta_step: float
    min_data_in_leaf: int
    min_sum_hessian_in_leaf: float
    min_gain_to_split: float
    # categorical split knobs (feature_histogram.hpp:112-273); static, so
    # a grower without categorical features runs the numerical search only
    with_categorical: bool = False
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    min_data_per_group: int = 100
    # frontier window (Config.tpu_frontier_batch): > 1 evaluates up to
    # that many frontier leaves per round; models stay byte-identical
    frontier_batch: int = 1
    # quantized gradients (Config.gradient_quantization): integer-valued
    # grad/hess columns on a grid of half-range qmax, int32 histograms
    quantized: bool = False
    qmax: int = 0
    # histogram pool slots (gbdt's _hist_pool_slots): 0 < slots <
    # num_leaves keeps that many histograms with LRU eviction
    hist_pool_slots: int = 0
    # monotone constraints (Config.monotone_constraints): per-leaf output
    # bounds tracked and propagated through monotone splits (LeafSplits
    # min/max_constraint, serial_tree_learner.cpp:765-777)
    with_monotone: bool = False


class PayloadCols(NamedTuple):
    """Column indices of the value columns inside the payload
    (bin columns occupy [0, G): the features, or their EFB bundles)."""
    grad: int
    hess: int
    cnt: int       # 0/1 count-mask (valid & bagged)
    value: int     # per-row current-tree leaf output


#: grower-output fields forming the device half of a finished tree (the
#: gbdt <-> grower2 contract of the JAX package, grower2.py:62)
TREE_DEVICE_FIELDS = ("split_feature", "split_bin", "default_left",
                      "split_is_cat", "split_cat_bitset", "left_child",
                      "right_child")

#: the best split of a leaf: its record columns, and the SplitResult field
#: each is taken from (the gain after the depth gate)
_BEST_FIELDS = (("bgain", "gain"), ("bfeat", "feature"),
                ("bbin", "threshold_bin"), ("bdleft", "default_left"),
                ("blg", "left_sum_g"), ("blh", "left_sum_h"),
                ("blc", "left_count"), ("bcat", "is_cat"),
                ("blo", "left_output"), ("bro", "right_output"))

#: the columns of a leaf's f32 record: what its split gave it, then its
#: best split (its categorical bitset is kept apart, and its segment, the
#: int32 (start, count) of its rows, in the SEG record: row numbers pass
#: f32's exact integers past 2^24 rows)
LEAF_COLS = ("sum_g", "sum_h", "cnt", "leaf_val", "leaf_depth",
             "leaf_parent") + tuple(k for k, _ in _BEST_FIELDS)

#: the columns of a node's f32 record, and each one's dtype in the tree
NODE_COLS = (("split_feature", torch.int32), ("split_bin", torch.int32),
             ("split_gain", torch.float32), ("default_left", torch.bool),
             ("split_is_cat", torch.bool), ("internal_value", torch.float32),
             ("internal_count", torch.float32), ("left_child", torch.int32),
             ("right_child", torch.int32))

_LC = {k: i for i, k in enumerate(LEAF_COLS)}
_NC = {k: i for i, (k, _) in enumerate(NODE_COLS)}

#: the columns of a leaf's constraint record (forced or monotone growers
#: only): its pending forced rank, the real gain of its stored best split
#: (its gain column holds a forced split's priority) and its output bounds
CON_COLS = ("fleaf", "breal", "mincon", "maxcon")
_CC = {k: i for i, k in enumerate(CON_COLS)}

#: steps the card's driver keeps enqueued ahead of the stop flag it has
#: read
STEPS_AHEAD = 4


def propagate_monotone_bounds(blo, bro, is_num, mono_f, pmin, pmax):
    """Children's output bounds after a split (the JAX package's
    grower.propagate_monotone_bounds; serial_tree_learner.cpp:765-777):
    they inherit the parent's, and a numerical split on a monotone
    feature pins the shared boundary at the midpoint of its outputs.
    Tightened (max / min), never replaced, so an out-of-bounds midpoint
    (possible for a forced split) cannot loosen a child's bounds."""
    mid = (blo + bro) * 0.5
    lmin = torch.where(is_num & (mono_f < 0), torch.maximum(mid, pmin), pmin)
    lmax = torch.where(is_num & (mono_f > 0), torch.minimum(mid, pmax), pmax)
    rmin = torch.where(is_num & (mono_f > 0), torch.maximum(mid, pmin), pmin)
    rmax = torch.where(is_num & (mono_f < 0), torch.minimum(mid, pmax), pmax)
    return lmin, lmax, rmin, rmax


def _drive_meshed(step, n: int, flag: torch.Tensor) -> None:
    """The distributed learners' driver: each step writes whether IT
    splits before its first exchange, whose wait makes the flag readable,
    so the host reads it after the step and runs no step ahead; every
    rank reads the same replicated flag and makes the same collectives.
    A tree that stops early pays one no-op step."""
    for _ in range(n):
        step()
        if not flag[0]:
            return


def _drive(step, n: int, flag: torch.Tensor, device) -> None:
    """Run `step` up to n times, stopping once `flag` (written by each
    step: whether the next one would split) is seen clear."""
    if device.type != "cuda":
        for _ in range(n):
            if not flag[0]:
                return
            step()
        return
    pending = collections.deque()
    for _ in range(n):
        while pending and (len(pending) >= STEPS_AHEAD
                           or pending[0].query()):
            done = pending.popleft()
            while not done.query():
                pass
            # pinned host memory, written by a step at least as late as
            # the one this event follows; once clear it stays clear
            if not flag[0]:
                return
        step()
        done = torch.cuda.Event()
        done.record()
        pending.append(done)


def _best_cols(res, gains) -> torch.Tensor:
    """[Q, len(_BEST_FIELDS)] f32: the best-split columns of LEAF_COLS from
    a split search, with `gains` for its gain."""
    return torch.stack([gains] + [getattr(res, f).to(torch.float32)
                                  for _, f in _BEST_FIELDS[1:]], dim=1)


def exact_exchange(dev: torch.device) -> bool:
    """Whether the distributed learners' f32 histograms of a payload on
    dev are the fixed-point kernels' (the card's B1 / B7), whose raw int64
    cells cross and sum exactly; elsewhere the row-order f32 histograms
    cross as f32, as the JAX package's psum."""
    return dev.type == "cuda"


def _take(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """t[i] for a device index i (0-d or [1]): index_select stays on the
    device, where indexing with a 0-d tensor reads it on the host."""
    return t.index_select(0, i.reshape(1).long())[0]


def _put(t: torch.Tensor, mask: torch.Tensor, v) -> None:
    """t[r] = v for every row r where mask[r], in place and elementwise
    (no index write, so nothing waits and nothing sorts)."""
    m = mask.reshape(mask.shape + (1,) * (t.dim() - mask.dim()))
    if isinstance(v, torch.Tensor):
        torch.where(m, v.to(t.dtype), t, out=t)
    else:
        t.masked_fill_(m, v)


def make_partitioned_grower(meta: FeatureMeta, cfg: GrowerConfig,
                            num_bins_max: int, cols: PayloadCols,
                            num_features: int, merged_hist=None,
                            jit: bool = True, forced=None,
                            bundle_map: BundleMap = None,
                            num_columns: int = None, mode: str = None,
                            group=None, top_k: int = 20):
    """Returns grow(payload, aux, feature_mask[, qscale][, hist_scale]) ->
    (tree dict, payload, aux).

    payload/aux: [N_pad + GUARD, P] f32 with a GUARD-row tail whose
    count-mask is 0.  Valid rows are [0, N_pad); the root segment covers
    all of them whatever order previous trees left them in.  payload and
    aux are updated in place, and the grower keeps its state for them:
    calls with the same payload and aux reuse it (and, on the card, its
    captured graphs).

    bundle_map (EFB; the JAX grower's bundle_map / num_columns): the
    payload holds num_columns = G < F bundled bin columns.  Histograms
    are built over the G storage columns, so the histogram state, the
    pool and the merged and frontier stacks stay [.., G, B, 3] (the
    memory win), and every split search (and the forced override) sees
    the [F, B, 3] per-feature view (`ops.bundle.expand_histogram`, after
    dequantization); the partition predicates decode the bundle.  The
    routes and gates take G and the payload width, never F.

    forced (a forced.ForcedSchedule) and cfg.with_monotone: the JAX
    grower's forced splits and monotone bounds, as predicated state of
    the same steps (a [L, 4] record per leaf, CON_COLS): the root's
    search with bounds (-inf, inf) and its forced override, both
    children's constrained searches and overrides at every split, and a
    forced node's real gain in its split_gain.  Either turns frontier
    batching off (the JAX gate, grower2.py:325-350); forced splits are
    f32 only, as in the JAX grower.

    The tree dict's fields are device tensors, num_leaves and
    split_rounds 0-d int32 among them; `host_syncs` is 0, since the
    grower never waits for the device.

    cfg.quantized: the grad/hess columns hold integer-valued quantized
    gradients (ops/quantize.py); histograms, their state and the
    subtraction are int32, and `grow` takes a fourth argument, the [2]
    f32 (gradient, hessian) scales, with which `dequantize_hist` turns a
    histogram into f32 exactly where the split search consumes it.
    Every histogram goes through the int32 kernel, at either grid.

    hist_scale: the int32 [2] fixed-point exponents of the f32 histograms
    on the card (`segment.fixed_scale` over the payload; `gbdt` passes one
    per tree), so every histogram of the tree rounds alike and the trees
    are a function of their input; without it each call derives its own.
    A CPU payload sums in row order and does not read it.

    merged_hist: None takes the merged mode by the JAX package's rule
    (grower2.py:264-275), resolved per call from the payload:
    cuda_segment.PARTITION_HIST_VALIDATED is set, the payload is on a CUDA
    device, the grower is not quantized and `partition_hist_fits` admits
    the width.  True forces the mode on any device; quantized turns it
    off either way.  The merged mode and the pool keep the one-leaf loop
    (the JAX gate, grower2.py:333-334).

    jit (the JAX grower's own switch): on a CUDA payload the root and the
    split step are captured as CUDA graphs and replayed; False runs the
    same steps eagerly, still with no host read.  A CPU payload always
    runs them eagerly.

    mode (the distributed learners; None is serial): this grower is one
    rank of a process group (`group`, parallel/comm.py) of the JAX
    grower's mesh modes (grower2.py:91-160, 384-505), whose collectives
    stand at the histogram boundary:
    - "data": each rank's payload holds its row block; local histograms
      are reduce-scattered over the storage columns, each rank searches
      its owned columns [r * Gloc, (r + 1) * Gloc) and the winner is
      synced (`ops.split.pick_winner`: greatest gain, ties to the lowest
      rank);
    - "voting": histograms stay local; each rank votes its top_k features
      by local gain (min_data_in_leaf / min_sum_hessian_in_leaf divided by
      the world size), the votes are all-gathered and only the 2 top_k
      winners' histograms are summed (in ascending feature order, so
      ties go to the lower feature as in the serial search);
    - "feature": full rows on every rank, the payload's storage columns
      permuted owned-first (the caller lays them out); histograms cover
      the owned leading Gloc columns, the winner is synced and its global
      column translated back (`localize_col`); the root totals are rank
      0's.
    With EFB or forced splits, "data" and "voting" sum the whole
    histogram and search it on every rank (replicated).  On the card the
    f32 histograms that cross are B1's or B7's raw int64 cells
    (`raw=True`, `exact_exchange`), summed exactly and converted once at
    `hist_scale`, so every rank's histogram has the serial grower's bits
    at any world size.  Voting keeps each leaf's local cells (the
    sibling by exact integer subtraction) and the global f32 histograms
    of the features it has summed; a larger child's selected feature
    that its parent and its smaller sibling both hold is the parent's
    less the sibling's, as the serial grower subtracts, so a vote that
    selects every feature is the serial tree bit for bit.  A CPU
    payload's row-order f32 histograms cross as f32 (the JAX
    package's psum), and quantized int32 histograms as they are.  The
    steps yield at each exchange; on the card each piece between two is
    captured as a graph (`graphs.Site`).  A meshed grower is never
    merged or frontier-batched (the JAX gates, grower2.py:269-275 and
    :332)."""
    L = cfg.num_leaves
    B = num_bins_max
    F = num_features
    G = num_columns if num_columns is not None else F
    bundled = bundle_map is not None
    quantized = bool(cfg.quantized)
    if quantized and cfg.qmax < 2:
        raise ValueError("the quantized grower needs the derive_qmax grid "
                         "(qmax >= 2), got %d" % cfg.qmax)
    if quantized and forced is not None:
        # the forced override reads f32 histograms (JAX grower2.py:181-185)
        raise ValueError("the quantized grower is unforced only")
    monotone = bool(cfg.with_monotone)
    constrained = monotone or forced is not None
    meshed = mode is not None
    if meshed and mode not in ("data", "voting", "feature"):
        raise ValueError("tree learner mode must be data|voting|feature, "
                         "got %r" % (mode,))
    replicated = meshed and mode != "feature" and (
        bundled or forced is not None)
    scatter = meshed and not replicated and mode == "data"
    voting = meshed and not replicated and mode == "voting"
    feature_mode = meshed and mode == "feature"
    if feature_mode and bundled:
        raise ValueError("the feature-parallel grower is unbundled (the JAX "
                         "gate, grower2.py:130-137)")
    n_mach = comm.world_size(group) if meshed else 1
    my = comm.rank(group) if meshed else 0
    owned = scatter or feature_mode
    if owned:
        # rank `my` owns storage columns [my * Gloc, (my + 1) * Gloc) of
        # the zero-padded Gp (grower2.py:140-146 of the JAX package)
        Gp = -(-(num_columns if num_columns is not None else num_features)
               // n_mach) * n_mach
        Gloc = Gp // n_mach
        f_offset = my * Gloc
        meta_local = slice_feature_meta(pad_feature_meta(meta, Gp),
                                        slice(f_offset, f_offset + Gloc))
    find_kwargs = dict(
        l1=cfg.lambda_l1, l2=cfg.lambda_l2, max_delta_step=cfg.max_delta_step,
        min_data_in_leaf=cfg.min_data_in_leaf,
        min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
        min_gain_to_split=cfg.min_gain_to_split,
        with_categorical=cfg.with_categorical,
        max_cat_threshold=cfg.max_cat_threshold, cat_l2=cfg.cat_l2,
        cat_smooth=cfg.cat_smooth, max_cat_to_onehot=cfg.max_cat_to_onehot,
        min_data_per_group=cfg.min_data_per_group, monotone=monotone)
    #: the feature learner's synced forced evaluation (`search` of a build)
    forced_synced = {}
    if forced is not None:
        from .forced import PRIORITY_UNIT, make_forced_machinery
        evaluate = None
        if feature_mode:
            def evaluate(*args, **kwargs):
                """A forced split of the feature-parallel grower: the
                owner's evaluation, synced by `search` (the JAX package
                grows these on its masked mesh grower, which drops
                them)."""
                return forced_synced.pop("res")
        # the schedule's tables go up once, here, not inside a tree
        fc_lnext, fc_rnext, forced_override = make_forced_machinery(
            forced, meta, cfg, meta.num_bin.device, monotone, evaluate)
        fc_feat = torch.tensor(forced.feat, dtype=torch.int64,
                               device=meta.num_bin.device)
        fc_bin = torch.tensor(forced.bin, dtype=torch.int64,
                              device=meta.num_bin.device)
    # feature mode's histograms cover the owned leading columns only
    Gh = Gloc if owned else G
    Ghist = Gloc if feature_mode else G
    hist_kwargs = dict(num_features=Ghist, num_bins=B, grad_col=cols.grad,
                       hess_col=cols.hess, cnt_col=cols.cnt)
    # the histogram pool (grower2.py:301-310 of the JAX package)
    slots = int(cfg.hist_pool_slots or 0)
    POOL = slots if 0 < slots < L else L
    if POOL < 2:
        raise ValueError("the histogram pool needs at least 2 slots, got %d"
                         % POOL)
    # the JAX gate (grower2.py:325-350): serial by construction here,
    # unforced and non-monotone read here, unpooled and unmerged per call
    fb = max(int(cfg.frontier_batch or 1), 1)
    KB = min(fb, L - 1) if fb > 1 and L > 2 and not constrained \
        and not meshed else 1
    ni = L - 1
    NL, NN = len(LEAF_COLS), len(NODE_COLS)
    lc, nc = _LC, _NC

    def out_fn(sum_g, sum_h):
        return leaf_output(sum_g, sum_h, cfg.lambda_l1, cfg.lambda_l2,
                           cfg.max_delta_step)

    def depth_gate(gains, child_depth):
        if cfg.max_depth > 0:
            return torch.where(child_depth < cfg.max_depth, gains,
                               torch.full_like(gains, K_MIN_SCORE))
        return gains

    # the f32 histogram of a segment follows the route by width (B1 or
    # B7); the int32 histogram (B4) serves every width
    hist_wrapper = cuda_segment.segment_histogram_quant if quantized \
        else cuda_segment.histogram_route(Ghist)

    def build(payload, aux, merged: bool, fused: bool, pooled: bool,
              frontier: bool, part_fn, scaled: bool) -> SimpleNamespace:
        """The state, static inputs and steps of the trees grown on this
        payload and aux."""
        dev = payload.device
        on_card = dev.type == "cuda"
        n_rows = payload.shape[0] - GUARD
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        if bundled:
            bmap = BundleMap(*(t.to(dev) for t in bundle_map))
            tables = histogram_expansion(bmap, meta.num_bin,
                                         meta.default_bin, B, B)
        else:
            bmap = identity_bundle_map(F, dev)
        # on the card the crossing f32 histograms are raw int64 cells;
        # voting keeps its leaves' local cells (`vote_search`)
        raw = meshed and not quantized and exact_exchange(dev) and (
            scatter or replicated or voting)
        if raw and not scaled:
            raise ValueError("the distributed grower on the card needs the "
                             "tree's hist_scale")
        glob = raw and voting
        hdtype = torch.int32 if quantized else (
            torch.int64 if glob else torch.float32)

        # the kernels' scratch: one workspace for the route's largest call
        wkw = {}
        if on_card:
            if fused:
                wrappers = [cuda_segment.partition_segment_hist]
            elif frontier:
                wrappers = [cuda_segment.partition_segment_stage,
                            cuda_segment.segment_histogram_batched]
            else:
                wrappers = [part_fn]
            wkw["workspace"] = cuda_segment.Workspace.sized(dev, [
                cuda_segment.scratch_need(w, payload.shape[0],
                                          payload.shape[1], G, B, KB)
                for w in wrappers + [hist_wrapper]])

        # static inputs, copied in per tree
        fmask = torch.zeros(F, dtype=torch.bool, device=dev)
        qs = torch.zeros(2, **f32) if quantized else None
        hs = torch.zeros(2, **i32) if scaled else None
        # whether any gradient or hessian of the tree is not finite
        nf = torch.zeros((), dtype=torch.bool, device=dev)
        fixed = {} if quantized else dict(scale=hs)

        # the state
        R0 = torch.zeros((L, NL), **f32)
        R0[:, lc["bgain"]] = K_MIN_SCORE
        R0[:, lc["leaf_parent"]] = -1.0
        R = torch.empty_like(R0)
        SEG = torch.zeros((L, 2), **i32)
        BITS = torch.zeros((L, B), dtype=torch.bool, device=dev)
        NODE = torch.zeros((ni, NN), **f32)
        NBITS = torch.zeros((ni, B), dtype=torch.bool, device=dev)
        if constrained:
            C0 = torch.zeros((L, len(CON_COLS)), **f32)
            C0[:, _CC["fleaf"]] = -1.0
            C0[:, _CC["breal"]] = K_MIN_SCORE
            C0[:, _CC["mincon"]] = float("-inf")
            C0[:, _CC["maxcon"]] = float("inf")
            C = torch.empty_like(C0)
            unbounded = C0[0, _CC["mincon"]:]
        # one slot past the last: where a no-op step's writes go
        HIST = None if merged else torch.empty((POOL + 1, Gh, B, 3),
                                               dtype=hdtype, device=dev)
        if glob:
            # voting's global f32 histograms per slot, and which features
            # each holds
            GH = torch.zeros((POOL + 1, G, B, 3), **f32)
            GV = torch.zeros((POOL + 1, G), dtype=torch.bool, device=dev)
        nleaves = torch.ones((), **i32)
        rounds = torch.zeros((), **i32)
        if pooled:
            slot_of_leaf = torch.empty(L, **i32)
            leaf_of_slot = torch.empty(POOL, **i32)
            slot_use = torch.empty(POOL, **i32)
        # whether the next step splits: host memory the device writes
        flag = torch.zeros(1, dtype=torch.int32, pin_memory=on_card)
        iota_l = torch.arange(L, **i32)
        iota_n = torch.arange(ni, **i32)
        iota_p = torch.arange(POOL, **i32)
        iota_k = torch.arange(KB, **i32)
        zero = torch.zeros((), **i32)
        rows_all = torch.full((), n_rows, **i32)

        if quantized:
            def deq(h):
                return dequantize_hist(h, qs[0], qs[1])
        else:
            def deq(h):
                return h

        def view(h):
            """[.., G, B, 3] storage histograms (dequantized) -> the
            [.., F, B, 3] per-feature views the split search reads (the
            JAX grower's hist_view)."""
            return expand_histogram(h, tables) if bundled else h

        def hist_fn(payload, start, count):
            return hist_wrapper(payload, start, count, **hist_kwargs,
                                **fixed, **wkw)

        def hist_batched_fn(payload, starts, counts):
            return cuda_segment.segment_histogram_batched(
                payload, starts, counts, quantized=quantized, **hist_kwargs,
                **fixed, **wkw)

        def find_split_batched(hists, sgs, shs, cnts, **constraints):
            """The one search routine: root (Q = 1), the two children of a
            split (Q = 2) and the 2K children of a frontier round."""
            return find_best_split_batched(view(deq(hists)), sgs, shs, cnts,
                                           fmask, meta=meta, **find_kwargs,
                                           **constraints)

        # -- the distributed learners' histogram boundary ---------------
        def local_hist(payload, start, count):
            """This rank's histogram of a segment (raw cells where they
            cross the wire on the card)."""
            return hist_wrapper(payload, start, count, **hist_kwargs,
                                **fixed, **wkw, **({"raw": True} if raw
                                                   else {}))

        # each exchange is a yield of (host collective, device tensor):
        # the step's Site (runtime/graphs.py) runs it and sends the
        # result back in
        collectives = dict(
            sum=functools.partial(comm.host_all_reduce, op="sum",
                                  group=group),
            scatter=functools.partial(comm.host_reduce_scatter, group=group),
            gather=functools.partial(comm.host_all_gather, group=group))

        def xchg(op, t):
            out = yield (collectives[op], t)
            return out

        def reduce_hist(h):
            """The global histogram from the ranks' local ones: this
            rank's owned columns (data), the whole (replicated), or h
            itself (voting, feature).  h may carry leading axes."""
            if scatter:
                lead = h.shape[:-3]
                flat = h.reshape((-1,) + h.shape[-3:]).movedim(1, 0)
                h = (yield from xchg("scatter", flat.contiguous())) \
                    .movedim(0, 1).reshape(lead + (Gloc,) + h.shape[-2:])
            elif replicated:
                h = yield from xchg("sum", h)
            if raw and not voting:
                h = cells_to_hist(h, hs)
            return h

        def root_sums(hist_local, hist_root):
            """The root's (grad, hess, count) totals and, in f32 mode, the
            IEEE sums of the grad / hess columns, in one exchange.  Every
            row lands in one bin of storage column 0, so the totals fall
            out of its global histogram: rank 0's (data: it holds that
            column; feature: every rank's are global in value and rank
            0's are the serial grower's bits, JAX :532-542; replicated:
            every rank's are equal), or the ranks' local totals summed
            (voting).  The IEEE sums are the ranks' blocks' summed (data,
            voting) or rank 0's (feature: full rows everywhere)."""
            ieee = torch.stack([payload[:, cols.grad].sum(),
                                payload[:, cols.hess].sum()])
            if glob:
                # voting's local cells: column 0's global cells, converted
                # and summed as the serial grower sums its f32 histogram,
                # then the IEEE sums (another dtype, another exchange)
                h0 = cells_to_hist((yield from xchg("sum", hist_local[0])),
                                   hs)
                t = torch.sum(h0, dim=0, dtype=h0.dtype)
                return t, (yield from xchg("sum", ieee))
            src = hist_local if voting else hist_root
            t = torch.sum(src[0], dim=0, dtype=src.dtype)
            first = torch.full((), my == 0, device=dev)
            if not voting:
                t = torch.where(first, t, torch.zeros_like(t))
            if quantized:
                return (yield from xchg("sum", t)), None
            if feature_mode:
                ieee = torch.where(first, ieee, torch.zeros_like(ieee))
            both = yield from xchg("sum", torch.cat([t, ieee]))
            return both[:3], both[3:]

        def fmask_owned():
            fm = torch.cat([fmask, fmask.new_zeros(Gp - F)]) if Gp > F \
                else fmask
            return fm[f_offset:f_offset + Gloc]

        vote_kwargs = dict(find_kwargs)
        vote_kwargs["min_data_in_leaf"] = cfg.min_data_in_leaf / n_mach
        vote_kwargs["min_sum_hessian_in_leaf"] = \
            cfg.min_sum_hessian_in_leaf / n_mach

        def vote_search(hists, sgs, shs, cnts, settle=None, **constraints):
            """PV-Tree's search (the JAX grower's voting find_split): each
            leaf's top_k features by local gain with the scaled
            constraints, the votes all-gathered (one exchange for every
            leaf), the 2 top_k most voted features' histograms summed (one
            more) and searched.  Ties rank the lower index first, as
            lax.top_k does.  With raw cells (`glob`) hists are the local
            cells, and `settle(hsel, sel)` turns the selected features'
            global f32 histograms, converted from their summed cells, into
            the ones the search reads."""
            Q = hists.shape[0]
            k_vote = min(top_k, F)
            S = min(2 * k_vote, F)
            hf = cells_to_hist(hists, hs) if glob else deq(hists)
            tot = hf[:, 0].sum(dim=1)                             # [Q, 3]
            gains = per_feature_best_gains(
                hf, tot[:, 0], tot[:, 1], tot[:, 2], fmask, meta=meta,
                **vote_kwargs)                                    # [Q, F]
            vals, idx = torch.sort(gains, dim=1, descending=True,
                                   stable=True)
            votes_mine = torch.stack([idx[:, :k_vote].to(torch.int64),
                                      (vals[:, :k_vote] > K_MIN_SCORE)
                                      .to(torch.int64)])          # [2, Q, k]
            allv = yield from xchg("gather", votes_mine)    # [W, 2, Q, k]
            votes = torch.zeros((Q, F), dtype=torch.int64, device=dev)
            votes.scatter_add_(1, allv[:, 0].movedim(0, 1).reshape(Q, -1),
                               allv[:, 1].movedim(0, 1).reshape(Q, -1))
            sel = torch.sort(torch.sort(votes, dim=1, descending=True,
                                        stable=True).indices[:, :S],
                             dim=1).values                        # [Q, S]
            hsel = torch.stack([hists[q].index_select(0, sel[q])
                                for q in range(Q)])
            hsel = yield from xchg("sum", hsel)
            if glob:
                hsel = settle(cells_to_hist(hsel, hs), sel)
            else:
                hsel = deq(hsel)
            out = []
            for q in range(Q):
                cons = {k: v[q:q + 1] for k, v in constraints.items()}
                r = find_best_split_batched(
                    hsel[q:q + 1], sgs[q:q + 1], shs[q:q + 1],
                    cnts[q:q + 1], fmask.index_select(0, sel[q]),
                    meta=slice_feature_meta(meta, sel[q]), **find_kwargs,
                    **cons)
                out.append(r._replace(feature=sel[q].index_select(
                    0, r.feature.long()).to(torch.int32)))
            return type(out[0])(*[torch.cat(f) for f in zip(*out)])

        def search(hists, sgs, shs, cnts, franks=None, settle=None,
                   **constraints):
            """The split search of Q leaves' (global, or local in voting)
            histograms: the serial search, or the owned columns' search
            and the winner sync (data, feature), or the vote.  franks
            (feature mode with forced splits: the leaves' forced ranks):
            the rank that owns each forced feature evaluates it on its
            histogram, and the evaluation crosses in the winner sync's
            exchange, for `forced_override` to read."""
            if voting:
                return (yield from vote_search(hists, sgs, shs, cnts,
                                               settle, **constraints))
            if not owned:
                return find_split_batched(hists, sgs, shs, cnts,
                                          **constraints)
            hd = deq(hists)
            res = find_best_split_batched(
                hd, sgs, shs, cnts, fmask_owned(), meta=meta_local,
                **find_kwargs, **constraints)
            rows = pack_split(res, f_offset)
            Q = rows.shape[0]
            if franks is not None:
                r0 = franks.clamp(min=0)
                feat = fc_feat.index_select(0, r0)
                fres = evaluate_split_at(
                    hd, sgs, shs, cnts, (feat - f_offset).clamp(0, Gloc - 1),
                    fc_bin.index_select(0, r0), meta=meta_local,
                    l1=cfg.lambda_l1, l2=cfg.lambda_l2,
                    max_delta_step=cfg.max_delta_step,
                    min_data_in_leaf=cfg.min_data_in_leaf,
                    min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
                    monotone=monotone, **constraints)
                rows = torch.cat([rows, pack_split(fres, f_offset)])
            got = yield from xchg("gather", rows)
            if franks is not None:
                owner = torch.div(feat, Gloc, rounding_mode="floor")
                q = torch.arange(Q, device=dev)
                forced_synced["res"] = unpack_split(got[owner, Q + q])
            return unpack_split(pick_winner(got[:, :Q]))

        def spread(h, sel):
            """[S, B, 3] histograms of features sel -> the [G, B, 3]
            histogram holding them (zeros elsewhere) and its [G] mask."""
            full = torch.zeros((G,) + h.shape[1:], **f32)
            full.index_copy_(0, sel, h)
            mask = torch.zeros(G, dtype=torch.bool, device=dev)
            mask.index_fill_(0, sel, True)
            return full, mask

        def glob_put(slot, full, mask, do) -> None:
            i = torch.where(do, slot, POOL).reshape(1).long()
            GH.index_copy_(0, i, full[None])
            GV.index_copy_(0, i, mask[None])

        def settle_root(hsel, sel):
            full, mask = spread(hsel[0], sel[0])
            GH[0], GV[0] = full, mask
            return hsel

        def set_flag(go):
            flag.copy_(go.to(torch.int32).reshape(1), non_blocking=True)

        def predicate(r, bits):
            """The split predicate of leaf records r ([NL] or [K, NL])."""
            f = r[..., lc["bfeat"]].long()

            def of_f(t):
                return t.index_select(0, f.reshape(-1)).reshape(f.shape)

            col = of_f(bmap.f_group)
            if feature_mode:
                col = localize_col(col, f_offset, Gloc)
            return SplitPredicate(
                col=col,
                threshold=r[..., lc["bbin"]].to(torch.int32),
                default_left=r[..., lc["bdleft"]].to(torch.bool),
                is_cat=r[..., lc["bcat"]].to(torch.bool), bitset=bits,
                missing_type=of_f(meta.missing_type),
                num_bin=of_f(meta.num_bin), default_bin=of_f(meta.default_bin),
                offset=of_f(bmap.f_offset), identity=of_f(bmap.f_identity))

        def link_parent(parent, leaf_f, node_f, do) -> None:
            """Point the parent node's child pointer that named leaf `leaf`
            at the new node (Tree::Split, tree.h:404-448)."""
            pn = parent.clamp(min=0).long()
            prow = _take(NODE, pn)
            was_left = prow[nc["left_child"]] == -1.0 - leaf_f
            side = torch.stack([was_left, ~was_left])
            mask = ((iota_n == pn) & (parent >= 0) & do)[:, None] & side
            kids = NODE[:, nc["left_child"]:nc["right_child"] + 1]
            torch.where(mask, node_f, kids, out=kids)

        def root():
            """The root step (a generator: it yields at each exchange of
            the distributed learners; a serial grower's never yields)."""
            R.copy_(R0)
            SEG.zero_()
            SEG[:1, 1].copy_(rows_all.reshape(1))
            BITS.zero_()
            NODE.zero_()
            NBITS.zero_()
            nleaves.fill_(1)
            rounds.zero_()
            if pooled:
                # the LRU bookkeeping (grower2.py:574-577)
                slot_of_leaf.fill_(-1)
                leaf_of_slot.fill_(-1)
                slot_use.zero_()
                # a slice's fill: `t[0] = 0` copies a host scalar in
                slot_of_leaf[:1].fill_(0)
                leaf_of_slot[:1].fill_(0)
            if meshed:
                hist_local = local_hist(payload, zero, rows_all)
                hist_root = yield from reduce_hist(hist_local)
                totals, ieee = yield from root_sums(hist_local, hist_root)
                totals = deq(totals)
            else:
                hist_root = hist_fn(payload, zero, rows_all)
                # every row lands in exactly one bin of storage column 0,
                # so the root totals fall out of the histogram (exact
                # integers in the quantized mode, f32 only from the
                # boundary on)
                totals = deq(torch.sum(hist_root[0], dim=0,
                                       dtype=hist_root.dtype))
            if not quantized:
                # a non-finite gradient burst: the root's totals are the
                # IEEE f32 sums of the grad / hess columns, NaN or +-inf as
                # the JAX package's f32 histograms give them (the card's
                # fixed-point cells turn NaN and inf into finite integers),
                # and no split is taken below: a stump with a non-finite
                # leaf value.  Selected, so a finite tree's bits stay.
                if not meshed:
                    ieee = torch.stack([payload[:, cols.grad].sum(),
                                        payload[:, cols.hess].sum()])
                totals = torch.where(nf, torch.cat([ieee, totals[2:]]),
                                     totals)
            bounds = {}
            if monotone:
                bounds = dict(min_constraint=unbounded[0:1],
                              max_constraint=unbounded[1:2])
            franks = zero.reshape(1).long() \
                if feature_mode and forced is not None else None
            res0 = yield from search(hist_root[None], totals[0:1],
                                     totals[1:2], totals[2:3], franks,
                                     settle_root if glob else None,
                                     **bounds)
            if constrained:
                C.copy_(C0)
                real0 = res0.gain
                if forced is not None:
                    # the root's forced override (JAX :523-526), without
                    # bounds as there
                    res0, real0, rank0 = forced_override(
                        zero.reshape(1).long(), view(deq(hist_root[None])),
                        totals[0:1], totals[1:2], totals[2:3], res0)
                    C[0, _CC["fleaf"]] = rank0[0].to(torch.float32)
                C[0, _CC["breal"]] = real0[0]
            res0 = res0._replace(gain=torch.where(
                nf, torch.full_like(res0.gain, K_MIN_SCORE), res0.gain))
            # rows start as one root segment with the root Newton step as
            # the per-row output (covers the unsplittable-stump case)
            payload_col_write(payload, cols.value,
                              out_fn(totals[0], totals[1]))
            R[0, lc["sum_g"]:lc["cnt"] + 1] = totals
            R[0, lc["bgain"]:] = _best_cols(res0, res0.gain)[0]
            BITS[0].copy_(res0.cat_bitset[0])
            if HIST is not None:
                # zeros as in the JAX grower: a frontier round reads the
                # slots of its inactive candidates too
                HIST.zero_()
                HIST[0] = hist_root
            if not meshed:
                set_flag(res0.gain[0] > 0.0)

        def part_hist_fn(start, count, pred, lo, ro):
            """The merged split: the partition and both children's
            histograms."""
            if fused:
                return cuda_segment.partition_segment_hist(
                    payload, aux, start, count, pred, lo, ro, cols.value, B,
                    num_features=G, grad_col=cols.grad, hess_col=cols.hess,
                    cnt_col=cols.cnt, **fixed, **wkw)[2:]
            _, _, nl = part_fn(payload, aux, start, count, pred, lo, ro,
                               cols.value, **wkw)
            return (nl, hist_fn(payload, start, nl),
                    hist_fn(payload, start + nl, count - nl))

        def hist_put(slot, h, do) -> None:
            HIST.index_copy_(0, torch.where(do, slot, POOL).reshape(1).long(),
                             h.reshape((1,) + h.shape[-3:]))

        def pool_store(bl, s, live, pslot, mask_b, mask_s, active):
            """The children's slots (grower2.py:666-689 of the JAX
            package): the left child takes its parent's slot, or the least
            recently used one if the parent's was evicted; the right child
            the least recently used of the others.  Returns both."""
            def evict(victim, do):
                old = _take(leaf_of_slot, victim)
                _put(slot_of_leaf, (iota_l == old) & (old >= 0) & do, -1)

            victim = torch.argmin(slot_use)
            lslot = torch.where(live, pslot.long(), victim)
            evict(victim, ~live & active)
            _put(leaf_of_slot, (iota_p == lslot) & active, bl)
            _put(slot_use, (iota_p == lslot) & active, s)
            prio = torch.where(iota_p == lslot, 1 << 30, slot_use)
            rslot = torch.argmin(prio)
            evict(rslot, active)
            _put(leaf_of_slot, (iota_p == rslot) & active, s)
            _put(slot_use, (iota_p == rslot) & active, s)
            _put(slot_of_leaf, mask_b, lslot)
            _put(slot_of_leaf, mask_s, rslot)
            return lslot, rslot

        def split_step():
            """One leaf per round (the JAX package's body + do_split):
            split the leaf of the largest gain into leaves bl and s, and
            evaluate both children; a no-op unless the loop condition
            holds.  A generator, as `root`."""
            bl = torch.argmax(R[:, lc["bgain"]])
            r = _take(R, bl)
            s = nleaves
            active = (s < L) & (r[lc["bgain"]] > 0.0)
            if meshed:
                # whether THIS step splits, read by the host after the
                # step's first exchange (`_drive`)
                set_flag(active)
            node = s - 1
            mask_b = (iota_l == bl) & active
            mask_s = (iota_l == s) & active
            bits = _take(BITS, bl)
            pred = predicate(r, bits)
            sg = _take(SEG, bl)
            start = sg[0]
            count = torch.where(active, sg[1], 0)
            # child aggregates: left from the stored split, right by diff
            lg, lh, lcnt = r[lc["blg"]], r[lc["blh"]], r[lc["blc"]]
            pg, ph, pc = r[lc["sum_g"]], r[lc["sum_h"]], r[lc["cnt"]]
            rg, rh, rcnt = pg - lg, ph - lh, pc - lcnt
            lo, ro = r[lc["blo"]], r[lc["bro"]]

            if merged:
                nl, new_left, new_right = part_hist_fn(start, count, pred,
                                                       lo, ro)
            elif meshed:
                if pooled:
                    pslot = _take(slot_of_leaf, bl)
                    live = pslot >= 0
                    rebuilt_local = local_hist(payload, start,
                                               torch.where(live, 0, count))
                else:
                    hist_parent = _take(HIST, bl)
                _, _, nl = part_fn(payload, aux, start, count, pred, lo, ro,
                                   cols.value, **wkw)
                left_smaller = lcnt <= rcnt
                small_local = local_hist(
                    payload, torch.where(left_smaller, start, start + nl),
                    torch.where(left_smaller, nl, count - nl))
                if pooled:
                    # one exchange for the rebuilt parent and the child
                    both = yield from reduce_hist(torch.stack(
                        [rebuilt_local, small_local]))
                    hist_parent = torch.where(
                        live, _take(HIST, pslot.clamp(min=0)), both[0])
                    hist_small = both[1]
                else:
                    hist_small = yield from reduce_hist(small_local)
                hist_big = hist_parent - hist_small
                new_left = torch.where(left_smaller, hist_small, hist_big)
                new_right = torch.where(left_smaller, hist_big, hist_small)
                if glob:
                    gslot = pslot.clamp(min=0) if pooled else bl
                    gh_parent = _take(GH, gslot)
                    gv_parent = _take(GV, gslot)
                    if pooled:
                        # an evicted parent holds no global histogram
                        gv_parent = gv_parent & live
            else:
                if pooled:
                    # evicted: rebuild from the parent's contiguous rows,
                    # before the partition reorders them (count 0 when the
                    # slot is live, as lax.cond picks, :641-645)
                    pslot = _take(slot_of_leaf, bl)
                    live = pslot >= 0
                    rebuilt = hist_fn(payload, start,
                                      torch.where(live, 0, count))
                    hist_parent = torch.where(
                        live, _take(HIST, pslot.clamp(min=0)), rebuilt)
                else:
                    hist_parent = _take(HIST, bl)
                _, _, nl = part_fn(payload, aux, start, count, pred, lo, ro,
                                   cols.value, **wkw)
                # build only the smaller child (by masked counts, as the
                # JAX grower does) and derive the sibling by subtraction
                left_smaller = lcnt <= rcnt
                hist_small = hist_fn(
                    payload, torch.where(left_smaller, start, start + nl),
                    torch.where(left_smaller, nl, count - nl))
                hist_big = hist_parent - hist_small
                new_left = torch.where(left_smaller, hist_small, hist_big)
                new_right = torch.where(left_smaller, hist_big, hist_small)

            hists2 = torch.stack([new_left, new_right])
            sums2 = (torch.stack([lg, rg]), torch.stack([lh, rh]),
                     torch.stack([lcnt, rcnt]))
            bounds = {}
            if constrained:
                crow = _take(C, bl)
            if monotone:
                f = r[lc["bfeat"]].long().reshape(1)
                lmin, lmax, rmin, rmax = propagate_monotone_bounds(
                    lo, ro, r[lc["bcat"]] == 0.0,
                    meta.monotone.index_select(0, f)[0],
                    crow[_CC["mincon"]], crow[_CC["maxcon"]])
                bounds = dict(min_constraint=torch.stack([lmin, rmin]),
                              max_constraint=torch.stack([lmax, rmax]))
            franks = None
            if forced is not None:
                # the children's forced ranks, where the parent's own
                # forced split was applied (JAX :729-741)
                jp = crow[_CC["fleaf"]]
                applied = (jp >= 0) & (r[lc["bgain"]] >= 0.5 * PRIORITY_UNIT)
                jp0 = jp.clamp(min=0).long().reshape(1)
                ranks = torch.where(
                    applied, torch.cat([fc_lnext.index_select(0, jp0),
                                        fc_rnext.index_select(0, jp0)]), -1)
                if feature_mode:
                    franks = ranks
            settled = {}

            def settle(hsel, sel):
                """The children's selected global histograms: the
                smaller's converted from its cells; the larger's the
                parent's less the smaller's where both hold the feature
                (the serial grower's subtraction), else converted from its
                own cells.  Keeps both children's [G] histograms."""
                ls = left_smaller
                s_sel, b_sel = (torch.where(ls, sel[0], sel[1]),
                                torch.where(ls, sel[1], sel[0]))
                s_full, s_mask = spread(torch.where(ls, hsel[0], hsel[1]),
                                        s_sel)
                b_own, b_mask = spread(torch.where(ls, hsel[1], hsel[0]),
                                       b_sel)
                derived = gv_parent & s_mask
                b_full = torch.where(derived[:, None, None],
                                     gh_parent - s_full, b_own)
                b_mask = b_mask | derived
                settled["left"] = (torch.where(ls, s_full, b_full),
                                   torch.where(ls, s_mask, b_mask))
                settled["right"] = (torch.where(ls, b_full, s_full),
                                    torch.where(ls, b_mask, s_mask))
                return torch.stack([settled[k][0].index_select(0, sel[q])
                                    for q, k in enumerate(("left",
                                                           "right"))])

            res = yield from search(hists2, *sums2, franks,
                                    settle if glob else None, **bounds)
            if constrained:
                real = res.gain
                jnext = torch.full((2,), -1.0, **f32)
            if forced is not None:
                res, real, jnext = forced_override(ranks, view(deq(hists2)),
                                                   *sums2, res, **bounds)
                jnext = jnext.to(torch.float32)
            depth = r[lc["leaf_depth"]] + 1.0
            gains = depth_gate(res.gain, depth)

            # the internal node, from the pre-split records
            bl_f, s_f = bl.to(torch.float32), s.to(torch.float32)
            node_f = s_f - 1.0
            # a forced node's gain is its split's real gain (JAX :794)
            node_gain = crow[_CC["breal"]] if forced is not None \
                else r[lc["bgain"]]
            _put(NODE, (iota_n == node) & active, torch.stack(
                [r[lc["bfeat"]], r[lc["bbin"]], node_gain,
                 r[lc["bdleft"]], r[lc["bcat"]], r[lc["leaf_val"]], pc,
                 -1.0 - bl_f, -1.0 - s_f]))
            _put(NBITS, (iota_n == node) & active, bits)
            link_parent(r[lc["leaf_parent"]], bl_f, node_f, active)

            # the children's records
            own = torch.stack([
                torch.stack([lg, lh, lcnt, lo, depth, node_f]),
                torch.stack([rg, rh, rcnt, ro, depth, node_f])])
            kids = torch.cat([own, _best_cols(res, gains)], dim=1)
            _put(R, mask_b, kids[0])
            _put(R, mask_s, kids[1])
            nl = nl.to(torch.int32)
            _put(SEG, mask_b, torch.stack([start, nl]))
            _put(SEG, mask_s, torch.stack([start + nl, count - nl]))
            _put(BITS, mask_b, res.cat_bitset[0])
            _put(BITS, mask_s, res.cat_bitset[1])
            if constrained:
                if monotone:
                    mins, maxs = bounds["min_constraint"], \
                        bounds["max_constraint"]
                else:
                    mins = unbounded[0].expand(2)
                    maxs = unbounded[1].expand(2)
                con = torch.stack([jnext, real, mins, maxs], dim=1)
                _put(C, mask_b, con[0])
                _put(C, mask_s, con[1])
            if pooled:
                lslot, rslot = pool_store(bl, s, live, pslot, mask_b,
                                          mask_s, active)
                hist_put(lslot, new_left, active)
                hist_put(rslot, new_right, active)
            elif not merged:
                lslot, rslot = bl, s
                hist_put(bl, new_left, active)
                hist_put(s, new_right, active)
            if glob:
                glob_put(lslot, *settled["left"], active)
                glob_put(rslot, *settled["right"], active)
            nleaves.add_(active.to(torch.int32))
            if not meshed:
                set_flag((nleaves < L) & (R[:, lc["bgain"]].max() > 0.0))

        def round_step() -> None:
            """One round of the frontier-batched grower (the JAX package's
            round_body, grower2.py:840-1038).

            Exactness: segments are disjoint and the partition stable, so
            splitting one leaf changes no other frontier leaf's rows,
            histogram or best split; an evaluation is the same bits
            whenever it runs, and the commit steps below replay the
            sequential order.  The smaller children's histograms are read
            from the STAGED aux rows, which hold each child's rows in the
            order the commit will copy back, and the split search gives
            each child the same bits at any batch size (ops/split.py), so
            the trees are those of K = 1.  A candidate that does not
            commit leaves its payload rows untouched."""
            # selection: the K best leaves; a stable sort keeps the lower
            # index first on ties (lax.top_k's order), so slot 0 is the
            # argmax the sequential grower pops next
            top_gain, cand = torch.sort(R[:, lc["bgain"]], descending=True,
                                        stable=True)
            top_gain, cand = top_gain[:KB], cand[:KB]
            round_on = (nleaves < L) & (top_gain[0] > 0.0)
            active = (top_gain > 0.0) & round_on
            rc = R.index_select(0, cand)

            def col(key):
                return rc[:, lc[key]]

            seg_c = SEG.index_select(0, cand)
            start_c = seg_c[:, 0]
            cnt_c = torch.where(active, seg_c[:, 1], 0)
            bits_c = BITS.index_select(0, cand)
            pred_c = predicate(rc, bits_c)

            # stage every candidate's partition into aux; payload is only
            # read (inactive slots stage count 0: a no-op)
            nl_c = torch.zeros(KB, **i32)
            for j in range(KB):
                cuda_segment.partition_segment_stage(
                    payload, aux, start_c[j], cnt_c[j],
                    SplitPredicate(*[v[j] for v in pred_c]), nl_c, j, **wkw)

            # ONE batched histogram of the K smaller children from the
            # staged rows; siblings by subtraction, with the sequential
            # grower's masked-count choice of the smaller child
            lg_c, lh_c, lc_c = col("blg"), col("blh"), col("blc")
            pg_c, ph_c, pc_c = col("sum_g"), col("sum_h"), col("cnt")
            rg_c, rh_c, rc_c = pg_c - lg_c, ph_c - lh_c, pc_c - lc_c
            left_smaller = lc_c <= rc_c
            hist_small = hist_batched_fn(
                aux, torch.where(left_smaller, start_c, start_c + nl_c),
                torch.where(left_smaller, nl_c, cnt_c - nl_c))
            hist_big = HIST.index_select(0, cand) - hist_small
            ls4 = left_smaller[:, None, None, None]
            new_left = torch.where(ls4, hist_small, hist_big)
            new_right = torch.where(ls4, hist_big, hist_small)

            # ONE split search over the 2K children (lefts, then rights)
            res = find_split_batched(
                torch.cat([new_left, new_right]), torch.cat([lg_c, rg_c]),
                torch.cat([lh_c, rh_c]), torch.cat([lc_c, rc_c]))
            depth_c = col("leaf_depth") + 1.0
            gains = depth_gate(res.gain, torch.cat([depth_c, depth_c]))

            # every candidate's children's records (lefts, then rights;
            # the parent column is set as each commits) and node record
            pad = torch.zeros_like(lg_c)
            own = torch.cat([
                torch.stack([lg_c, lh_c, lc_c, col("blo"), depth_c, pad],
                            dim=1),
                torch.stack([rg_c, rh_c, rc_c, col("bro"), depth_c, pad],
                            dim=1)])
            kids_c = torch.cat([own, _best_cols(res, gains)], dim=1)
            segs_c = torch.cat([torch.stack([start_c, nl_c], dim=1),
                                torch.stack([start_c + nl_c, cnt_c - nl_c],
                                            dim=1)])
            node_c = torch.stack([col("bfeat"), col("bbin"), col("bgain"),
                                  col("bdleft"), col("bcat"),
                                  col("leaf_val"), pc_c, pad, pad], dim=1)

            # commit: replay the sequential argmax order against the
            # window, one predicated step per slot (commit_body,
            # :936-1017); a pop outside the window (a child made this
            # round, an unevaluated or used leaf), exhausted gain or the
            # leaf budget ends the round.  No leaf is written twice.
            used = torch.zeros(KB, dtype=torch.bool, device=dev)
            stopped = torch.zeros((), dtype=torch.bool, device=dev)
            for _ in range(KB):
                bg = R[:, lc["bgain"]]
                best = torch.argmax(bg)
                is_c = (cand == best) & active & ~used
                j = torch.argmax(is_c.to(torch.int32))
                do = (_take(is_c, j) & ~stopped & (nleaves < L)
                      & (_take(bg, best) > 0.0))
                stopped = stopped | ~do
                used = used | ((iota_k == j) & do)
                s = nleaves
                best_f, s_f = best.to(torch.float32), s.to(torch.float32)
                node_f = s_f - 1.0
                parent = _take(R, best)[lc["leaf_parent"]]
                pair = torch.stack([j, j + KB])
                kids = kids_c.index_select(0, pair)
                kids[:, lc["leaf_parent"]] = node_f
                mask_b = (iota_l == best) & do
                mask_s = (iota_l == s) & do
                _put(R, mask_b, kids[0])
                _put(R, mask_s, kids[1])
                segs = segs_c.index_select(0, pair)
                _put(SEG, mask_b, segs[0])
                _put(SEG, mask_s, segs[1])
                cbits = res.cat_bitset.index_select(0, pair)
                _put(BITS, mask_b, cbits[0])
                _put(BITS, mask_s, cbits[1])
                hist_put(best, new_left.index_select(0, j.reshape(1)), do)
                hist_put(s, new_right.index_select(0, j.reshape(1)), do)
                nrow = _take(node_c, j)
                nrow[nc["left_child"]] = -1.0 - best_f
                nrow[nc["right_child"]] = -1.0 - s_f
                mask_n = (iota_n == s - 1) & do
                _put(NODE, mask_n, nrow)
                _put(NBITS, mask_n, _take(bits_c, j))
                link_parent(parent, best_f, node_f, do)
                nleaves.add_(do.to(torch.int32))

            # copy back the committed candidates only (count 0 for the
            # rest, whose payload rows were never touched)
            for j in range(KB):
                cuda_segment.partition_segment_commit(
                    payload, aux, start_c[j],
                    torch.where(used[j], cnt_c[j], 0), nl_c[j],
                    rc[j, lc["blo"]], rc[j, lc["bro"]], cols.value)
            rounds.add_(round_on.to(torch.int32))
            set_flag((nleaves < L) & (R[:, lc["bgain"]].max() > 0.0))

        def load(feature_mask, qscale, hist_scale, nonfinite=None) -> None:
            fmask.copy_(feature_mask)
            if nonfinite is None:
                nf.zero_()
            else:
                nf.copy_(nonfinite)
            if quantized:
                qs.copy_(qscale)
            if scaled:
                hs.copy_(hist_scale)

        def tree() -> dict:
            leaf_value = torch.where(
                (iota_l == 0) & (nleaves == 1),
                out_fn(R[:, lc["sum_g"]], R[:, lc["sum_h"]]),
                R[:, lc["leaf_val"]])
            out = {
                "num_leaves": nleaves.clone(),
                # sequential device rounds this tree paid (== splits for
                # the one-leaf loop)
                "split_rounds": rounds.clone() if frontier
                else nleaves - 1,
                "host_syncs": 0,
                "leaf_value": leaf_value,
                "leaf_count": R[:, lc["cnt"]].clone(),
                "leaf_sum_g": R[:, lc["sum_g"]].clone(),
                "leaf_sum_h": R[:, lc["sum_h"]].clone(),
                "seg_start": SEG[:, 0].clone(),
                "seg_cnt": SEG[:, 1].clone(),
                "split_cat_bitset": NBITS.clone(),
            }
            for key, dtype in NODE_COLS:
                out[key] = NODE[:, nc[key]].to(dtype, copy=True)
            return out

        counted = lambda: [getattr(cuda_segment, n)  # noqa: E731
                           for n in cuda_segment.WRAPPERS]
        capture = bool(jit) and on_card
        sig = lambda: graph_obs.signature(payload, aux, fmask)  # noqa: E731
        # a meshed grower's steps are captured piece by piece between
        # their exchanges; a serial grower's never exchange
        site = functools.partial(graphs.Site, enabled=capture,
                                 counted=counted, signature=sig,
                                 exchange=comm.exchange if meshed else None)
        root_site = site("grower2.root", root)
        step_site = site("grower2.round" if frontier else "grower2.split",
                         round_step if frontier else split_step)
        return SimpleNamespace(
            root=root_site, step=step_site,
            load=load, tree=tree, flag=flag, R=R, SEG=SEG, NODE=NODE,
            BITS=BITS,
            NBITS=NBITS, HIST=HIST, nleaves=nleaves)

    class Grow:
        """The grower: a callable, not a closure over itself, so dropping
        it frees its state and graphs at once.  hist_engine / part_engine
        name the wrappers the last call chose, by wrapper name (the JAX
        grower's hist_engine), from the payload's device and width;
        `program` holds the state and steps of the last call's payload."""

        def __init__(self):
            self.hist_engine = hist_wrapper.__name__
            self.part_engine = None
            self.program = None
            self._key = None

        def __call__(self, payload: torch.Tensor, aux: torch.Tensor,
                     feature_mask: torch.Tensor, qscale: torch.Tensor = None,
                     hist_scale: torch.Tensor = None,
                     nonfinite: torch.Tensor = None):
            dev = payload.device
            width = payload.shape[1]
            fits = cuda_segment.partition_hist_fits(width, G, B)
            if quantized:
                merged = False
                if qscale is None:
                    raise ValueError("the quantized grower needs the [2] "
                                     "scales")
            elif meshed:
                merged = False
            elif merged_hist is None:
                merged = (cuda_segment.PARTITION_HIST_VALIDATED
                          and payload.is_cuda and fits)
            else:
                merged = bool(merged_hist)
            pooled = POOL < L and not merged
            frontier = KB > 1 and not merged and not pooled
            # B6 where its gate admits the width; past it the merged split
            # partitions through the route and walks both children
            fused = merged and fits
            # the one-leaf loop's partition follows the route by payload
            # width (B2, B3 or B8); the frontier rounds stage and commit
            # through B2
            part_fn = cuda_segment.partition_route(width)
            if fused:
                self.hist_engine = "partition_segment_hist"
                self.part_engine = "partition_segment_hist"
            else:
                self.hist_engine = hist_wrapper.__name__
                self.part_engine = "partition_segment_stage" if frontier \
                    else part_fn.__name__
            scaled = hist_scale is not None and not quantized
            key = (str(dev), tuple(payload.shape), payload.data_ptr(),
                   aux.data_ptr(), merged, scaled)
            if key != self._key:
                # a new payload retires the old state and its graphs
                self.program = None
                t0 = time.perf_counter()
                self.program = build(payload, aux, merged, fused, pooled,
                                     frontier, part_fn, scaled)
                graph_obs.record_build(
                    "grower2.program", time.perf_counter() - t0,
                    graph_obs.signature(payload, aux, merged=merged,
                                        frontier=frontier))
                self._key = key
            prog = self.program
            prog.load(feature_mask, qscale, hist_scale, nonfinite)
            prog.root()
            if meshed:
                _drive_meshed(prog.step, L - 1, prog.flag)
            else:
                _drive(prog.step, L - 1, prog.flag, dev)
            return prog.tree(), payload, aux

    return Grow()
