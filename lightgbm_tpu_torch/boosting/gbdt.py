"""GBDT boosting engine (counterpart of lightgbm_tpu/boosting/gbdt.py).

Role parity with the reference src/boosting/gbdt.cpp: Init, TrainOneIter
(:387-482), BoostFromAverage (:363-385), Bagging (:213-295).  This slice
ports the serial partition-ordered fast path for every objective of the
registry: one tree per iteration, or K for the
multiclass objectives (each class's gradients from a snapshot of the
pre-iteration scores), and lambdarank's query-coupled gradients (filled
in original row order through the index column): the
`_FastState` payload, the fused step (gradient fill -> grow -> score
add), `_boost_from_average` and `_finish_tree_host`, in f32 or with
quantized gradients (gradient_quantization: the grad/hess columns hold
integers, histograms are int32), growing one leaf per round or
frontier-batched (tpu_frontier_batch), with the histogram pool
(histogram_pool_size) or the grower's merged mode (its own rule; no
config key reaches it, as in the JAX package), bagging (the host draws
the bag on the JAX package's RNG stream; the count column carries it),
leaf-output renewal (L1, quantile, MAPE: grow without the fused score
add, renew on the host, add the renewed outputs; a second blocking
fetch per tree), a training init_score, and validation sets, scored on
the device after every tree by bin-level traversal (`add_valid`), on
numerical and categorical features.  Continued training replays a loaded
model onto the training scores before the payload is built; a custom
objective's gradients (objective None) go up from pinned memory and are
gathered into partition order through the index column; a rollback
leaves the payload, subtracts the last iteration's trees by negated
traversal, and the next iteration rebuilds the payload in place with
the bag applied again; reset_config moves the shrinkage, bagging and
feature fraction.  The boosting variants (boosting/variants.py: GOSS,
DART, RF) ride the same path through this class's hooks: a sampling
fill (`_fill`, `_FastState.fill_sampled`), score edits by tree replay
over the payload's own bin columns (`_add_tree_to_train_score`,
`_FastState.payload_tree_add`), score scaling (`_multiply_scores`) and
a leaf transform (`_leaf_transform`); forced splits
(forcedsplits_filename) and monotone constraints run inside the
grower's device program.  An EFB-bundled dataset trains on its G
storage columns (the grower's bundle map; the payload, histograms and
replays read the bundles), and past 2^24 rows the payload's row index
splits into radix-4096 halves (`_FastState.wide_idx`), up to 2^31 rows.
What the JAX package trains on its masked grower (GOSS with a
non-rowwise objective, leaf renewal or a custom objective's gradients;
RF with a non-rowwise objective) trains here on the same partitioned
path: gradients of a non-rowwise objective, and a custom objective's,
are computed in original row order and gathered into the payload's
(`_FastState.all_gradients`).
The training runtime's seams ride the same path: `tpu_profile_phases`
times each tree piecewise under the JAX package's phase names (the fill,
the growth, the host assembly, the score adds and the bag each end in a
`profile_sync` wait; the unprofiled tree stays one uninterrupted
dispatch), `sentinel_nonfinite=abort|rollback` screens each tree's one
fetch (`resilience.sentinel_check`; `Booster.update` arbitrates), each
tree's dispatch is a ``tree dispatch`` instant on the trace recorder, and
the grower made per fast state is a hit or a miss of
``gbdt.grower_cache`` in the program ledger.
The distributed learners (tree_learner=data|voting|feature over a
torch.distributed process group, one rank a process: parallel/comm.py)
ride the same path: the learner is chosen as the JAX package chooses it
over its mesh (gbdt.py:946-980, the rank as its unit), each rank's
payload holds its row block (data, voting) or every row with its owned
storage columns first (feature), and the grower's mesh modes exchange
histograms and winners; scores, gradients of a non-rowwise objective,
renewal and metrics gather the blocks in original order, and every rank
holds the same model.
The dispatch pipeline and the boosting window (the JAX package's
pipeline_depth and boost_window, with its defaults 1 and 1) change how
the work is dispatched, never the model: at pipeline_depth >= 1 each
fused tree's packed record is copied into a pinned host slot on the
compute stream and its wait and Tree assembly run on one worker thread
(`boosting/pipeline.TreeAssembler`), so no tree waits for a fetch on the
critical path; boost_window=J dispatches J iterations' trees with no host
read between them and one wait for their stacked records, and an
observation point landing mid-window truncates it by exact snapshot
replay.  `flush()` is the barrier every model read goes through.  The
validation scores move by each tree's device half (leaf_value * f32(lr),
zero for a stump) at every depth and window length, so they, and early
stopping, are the same bits whatever the dispatch.
"""
from __future__ import annotations

import copy
import threading
import time
from contextlib import nullcontext
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..io.binning import BIN_TYPE_CATEGORICAL
from ..io.dataset import BinnedDataset
from ..models.gbdt_model import GBDTModel
from ..models.tree import Tree
from ..ops import segment as seg
from ..ops.quantize import (F32_GH_BYTES, QUANT_GH_BYTES, derive_qmax,
                            quant_seed, quantize_pair)
from ..ops.bundle import (BundleMap, bundle_map_from_info, decode_bin,
                          identity_bundle_map)
from ..ops.split import MISSING_NAN, MISSING_ZERO, FeatureMeta, owned_first
from ..parallel import comm
from ..runtime import graph_obs, resilience, syncs, telemetry, tracing
from ..utils.log import LightGBMError, Log
from ..utils.random import Random, partition_seed
from ..utils.timer import PhaseTimer
from .forced import build_forced_schedule, load_forced_json
from .grower2 import GrowerConfig, PayloadCols, make_partitioned_grower
from .pipeline import TreeAssembler

K_EPSILON = 1e-15

#: row count past which the payload's f32 index column splits into
#: radix-4096 (hi, lo) halves (f32 integers are exact below 2^24; tests
#: lower this to exercise the wide layout at small N), as in the JAX
#: package (gbdt.py:90-95)
_IDX_WIDE_THRESHOLD = 1 << 24

#: radix of the split index
_IDX_RADIX = 4096

#: the assembler worker's first and longest pause between polls of a
#: staged record's event: it backs off while the device runs the tree,
#: so its wake-ups do not take the GIL from the dispatch thread
_POLL_S = (50e-6, 1e-3)


def _construct_bitset(vals) -> list:
    """Common::ConstructBitset — uint32 words spanning [0, max(vals)]."""
    if not vals:
        return []
    words = [0] * (max(vals) // 32 + 1)
    for v in vals:
        words[v // 32] |= 1 << (v % 32)
    return words


def feature_meta(ds: BinnedDataset, device) -> FeatureMeta:
    """Per-feature split metadata of a binned dataset, on `device`."""
    m = ds.bin_mappers

    def t(values, dtype):
        return torch.as_tensor(np.asarray(values), dtype=dtype, device=device)

    return FeatureMeta(
        num_bin=t([mm.num_bin for mm in m], torch.int32),
        missing_type=t([mm.missing_type for mm in m], torch.int32),
        default_bin=t([mm.default_bin for mm in m], torch.int32),
        is_trivial=t([mm.is_trivial for mm in m], torch.bool),
        is_categorical=t([mm.bin_type == BIN_TYPE_CATEGORICAL for mm in m],
                         torch.bool),
        penalty=t(ds.feature_penalty, torch.float32),
        monotone=t(ds.monotone_constraints, torch.int32),
    )


class _FastState:
    """Partition-ordered training state: ONE row-major payload matrix
    [N_pad + GUARD, P] f32 that the grower reorders in place, with the
    JAX package's column layout (gbdt.py:279-305):

        bins 0..G-1 | label | weight | cnt | idx | score x K |
        snapshot x K (K > 1 only) | grad | hess | value | bvalid | gweight
        | idxhi (the wide layout only)

    so P = G + 10 for one tree per iteration (38 at 28 features; the
    snapshot is the score column itself, snap0 == score0) and G + 2K + 9
    for K > 1 (77 at 54 features and K = 7).  G is the storage columns:
    the features, or their EFB bundles.  From _IDX_WIDE_THRESHOLD rows
    (2^24, where f32 stops holding every integer) the row index splits
    into radix-4096 halves, idx (the low) and idxhi (the high), and P
    grows by one (the JAX package's wide_idx layout).  The TPU pads P to
    128 lanes; that padding does not carry over.  Guard rows carry idx ==
    n_pad and stay the last GUARD rows (the grower partitions [0, n_pad)
    only).  The count column starts as the valid-row mask; bagging
    refreshes it (`set_bag`).  Every class's tree of an iteration reads
    its gradients from the snapshot (`snap_scores`), which rides the
    partition like every column."""

    def __init__(self, gbdt: "GBDT", score: torch.Tensor):
        ds = gbdt.train_set
        dev = gbdt.device
        G = ds.bins.shape[0]
        K = int(score.shape[0])
        n_pad = ds.num_data_padded
        # the distributed learners (the JAX package's mesh fast path,
        # gbdt.py:252-273): under data / voting this rank's payload holds
        # its block of n_loc = n_pad / world rows, original rows [row0,
        # row0 + n_loc), and a GUARD-row tail of its own; under feature
        # it holds every row with the storage columns padded to a
        # multiple of the world size and permuted owned-first (`perm`:
        # payload column j holds storage column perm[j]).  Guard rows
        # carry idx == n_pad, a dead slot in every original-order map.
        self.mode = gbdt.parallel_mode
        world, rank = gbdt.world, gbdt.rank
        self.row_sharded = self.mode in ("data", "voting")
        self.n_loc = n_pad // world if self.row_sharded else n_pad
        self.row0 = rank * self.n_loc if self.row_sharded else 0
        perm = np.arange(G)
        if self.mode == "feature":
            Gp = -(-G // world) * world
            gl = Gp // world
            off = rank * gl
            perm = owned_first(Gp, off, gl).numpy()
            G = Gp
        self.perm = perm
        # storage column -> its payload column (identity but in feature
        # mode)
        self.col_of = torch.as_tensor(np.argsort(perm), dtype=torch.int64,
                                      device=dev)
        self.G, self.K, self.n_pad = G, K, n_pad
        self.n_rows = self.n_loc + seg.GUARD
        self.label_col = G
        self.weight_col = G + 1
        self.cnt_col = G + 2
        self.idx_col = G + 3
        self.score0 = G + 4
        self.snap0 = G + 4 + K if K > 1 else self.score0
        self.grad_col = self.snap0 + K
        self.hess_col = self.grad_col + 1
        self.value_col = self.grad_col + 2
        self.bvalid_col = self.value_col + 1
        self.gweight_col = self.bvalid_col + 1
        self.wide_idx = (n_pad + 1) >= _IDX_WIDE_THRESHOLD
        self.idxhi_col = self.gweight_col + 1 if self.wide_idx else None
        self.P = (self.idxhi_col if self.wide_idx else self.gweight_col) + 1
        self.cols = PayloadCols(grad=self.grad_col, hess=self.hess_col,
                                cnt=self.cnt_col, value=self.value_col)
        Log.info("fast path payload: %d rows x %d cols, %.2f GB "
                 "(+%.2f GB partition scratch) on %s", self.n_rows, self.P,
                 self.n_rows * self.P * 4 / 2**30,
                 self.n_rows * self.P * 4 / 2**30, dev)

        #: the last fill's non-finite predicate (`hist_exponents`)
        self.nonfinite = None
        self.payload = torch.empty((self.n_rows, self.P),
                                   dtype=torch.float32, device=dev)
        self.aux = torch.empty_like(self.payload)
        label, weight = self.reset(gbdt, score)
        # a non-rowwise objective (lambdarank) reads label and weight in
        # original row order, where its query boundaries live
        self.rowwise = getattr(gbdt.objective, "is_rowwise", True)
        self.label_orig = None if self.rowwise else label.to(torch.float32)
        self.weight_orig = None if self.rowwise else \
            weight.to(torch.float32)

    def reset(self, gbdt: "GBDT", score: torch.Tensor):
        """(Re)build the payload from ORIGINAL-order [K, n_pad] scores, in
        its existing storage, so the grower's captured graphs stay valid
        (the JAX package's _FastState.reset): on the first entry and when
        training re-enters after a rollback.  The count column holds the
        plain valid mask until the bag is applied again (`bag_dirty`).
        Returns the padded label and weight on the device."""
        ds, pay = gbdt.train_set, self.payload
        dev, G, n_pad = pay.device, self.G, self.n_pad
        n, r0 = self.n_loc, self.row0
        blk = slice(r0, r0 + n)
        md = ds.metadata
        pay.zero_()
        self.aux.zero_()
        bins = gbdt._bins_on_device(ds)
        ncol = bins.shape[0]
        if self.mode == "feature":
            live = self.perm < ncol
            pay[:n, np.nonzero(live)[0]] = \
                bins[torch.as_tensor(self.perm[live], device=dev)].T \
                .to(torch.float32)
        else:
            pay[:n, :ncol] = bins[:, blk].T.to(torch.float32)
        label = torch.as_tensor(ds.padded(md.label), device=dev)
        pay[:n, G] = label[blk]
        weight = md.weight if md.weight is not None \
            else np.ones(ds.num_data, np.float32)
        weight = torch.as_tensor(ds.padded(weight), device=dev)
        pay[:n, G + 1] = weight[blk]
        vmask = torch.as_tensor(ds.valid_row_mask(), device=dev)[blk]
        pay[:n, self.cnt_col] = vmask
        pay[:n, self.bvalid_col] = vmask
        self.write_index(slice(None), torch.full(
            (self.n_rows,), n_pad, dtype=torch.int64, device=dev))
        self.write_index(slice(0, n), torch.arange(
            r0, r0 + n, dtype=torch.int64, device=dev))
        pay[:n, self.score0:self.score0 + self.K] = score[:, blk].T
        self.bag_dirty = True
        return label, weight

    def write_index(self, rows: slice, idx: torch.Tensor) -> None:
        """Store int64 original-row indices into the index column(s) of
        payload rows `rows` (the JAX package's write_idx)."""
        pay = self.payload
        if self.wide_idx:
            pay[rows, self.idxhi_col] = torch.div(
                idx, _IDX_RADIX, rounding_mode="floor").to(torch.float32)
            idx = idx % _IDX_RADIX
        pay[rows, self.idx_col] = idx.to(torch.float32)

    def row_index(self) -> torch.Tensor:
        """[n_rows] int64: the original row of every payload row (n_pad
        on the guard rows), from the index column(s), on the device (the
        JAX package's read_idx)."""
        pay = self.payload
        idx = pay[:, self.idx_col].long()
        if self.wide_idx:
            idx = idx + pay[:, self.idxhi_col].long() * _IDX_RADIX
        return idx

    def to_original(self, x: torch.Tensor) -> torch.Tensor:
        """[K, n_pad] in ORIGINAL row order from [K, n_rows] values in the
        payload's row order, on the device: the index column of the first
        n_loc rows is a permutation of this block's original rows (the
        guard rows stay the last GUARD rows), so it routes a scatter; under
        data / voting the ranks' blocks are then all-gathered (one
        exchange), in rank order, which is row order."""
        n = self.n_loc
        blk = torch.empty((x.shape[0], n), dtype=x.dtype, device=x.device)
        blk[:, self.row_index()[:n] - self.row0] = x[:, :n]
        if not self.row_sharded:
            return blk
        return comm.all_gather(blk).movedim(0, 1).reshape(x.shape[0], -1)

    def from_original(self, x: torch.Tensor) -> torch.Tensor:
        """[K, n_rows] in the payload's row order from [K, n_pad] values in
        original order; guard rows take 0."""
        zero = x.new_zeros((x.shape[0], 1))
        return torch.cat([x, zero], 1)[:, self.row_index()]

    def hist_exponents(self, g: torch.Tensor, h: torch.Tensor):
        """The int32 [2] fixed-point exponents of the tree's f32
        histograms (`seg.fixed_exponents`) over the payload rows' largest
        |grad|, |hess|, and the tree's non-finite predicate
        (`self.nonfinite`, a device bool: whether a gradient or hessian
        is NaN or inf), both on the device with no host read.  Under data
        / voting the maxima and the predicate are the ranks' (one
        all-reduce) and the row bound the serial payload's, n_pad +
        GUARD, so every rank, and the serial learner, rounds alike."""
        amax = torch.stack([g.abs().amax(), h.abs().amax()])
        nf = ~(torch.isfinite(g).all() & torch.isfinite(h).all())
        if not self.row_sharded:
            self.nonfinite = nf
            return seg.fixed_exponents(amax, self.payload.shape[0])
        red = comm.all_reduce(torch.cat([amax, nf.to(amax.dtype)[None]]),
                              "max")
        self.nonfinite = red[2] > 0
        return seg.fixed_exponents(red[:2], self.n_pad + seg.GUARD)

    def original_scores(self) -> torch.Tensor:
        """[K, n_pad] scores in ORIGINAL row order, on the device with no
        host read (the JAX package's _fast_sync_back; all-gathered under
        data / voting)."""
        pay = self.payload
        return self.to_original(pay[:, self.score0:self.score0 + self.K].T)

    def snap_scores(self) -> None:
        """Copy the K score columns to the snapshot columns (K > 1): every
        class's gradients of the iteration come from these pre-iteration
        scores, in whatever order the class trees leave the rows."""
        if self.K > 1:
            pay = self.payload
            pay[:, self.snap0:self.snap0 + self.K] = \
                pay[:, self.score0:self.score0 + self.K]

    def set_bag(self, bag: np.ndarray) -> None:
        """Refresh the count column from an ORIGINAL-order [n_pad] f32 bag
        mask (zero on padded rows; the JAX package's set_bag): the rows
        sit in partition order, so the index column routes the gather.
        Guard rows route to an appended 0 and stay masked out.  The mask
        goes up from pinned memory with no blocking sync."""
        pay = self.payload
        bag = torch.from_numpy(np.concatenate(
            [bag.astype(np.float32), np.zeros(1, np.float32)]))
        if pay.is_cuda:
            bag = bag.pin_memory().to(pay.device, non_blocking=True)
        self.write_bag(bag)

    def write_bag(self, bag: torch.Tensor) -> None:
        """Refresh the count column from an ORIGINAL-order [n_pad + 1]
        f32 mask on the payload's device, whose last entry (0) the guard
        rows route to."""
        seg.payload_col_write(self.payload, self.cnt_col,
                              bag[self.row_index()])

    def all_gradients(self, objective, zero_score: bool = False,
                      custom=None):
        """Every class's unmasked [K, n_rows] (gradient, hessian) of the
        snapshot scores (of all-zero scores with `zero_score`: RF), in the
        payload's current row order (the JAX package's _all_grads).  A
        rowwise objective reads the payload's label and weight columns.  A
        non-rowwise objective (lambdarank) gets the snapshot scattered back
        to original row order through the index column (a permutation of
        [0, n_pad): no two rows write one slot) and computes against the
        original-order label and weight, where its query boundaries live.
        Its gradients, or a custom objective's ORIGINAL-order [K, n_pad]
        pair `custom`, are gathered into partition order; guard rows
        gather an appended 0."""
        pay, K = self.payload, self.K
        snap = pay[:, self.snap0:self.snap0 + K].T
        if custom is None and self.rowwise:
            if zero_score:
                snap = torch.zeros_like(snap)
            return objective.get_gradients_multi(
                snap, pay[:, self.label_col], pay[:, self.weight_col])
        if custom is None:
            # under data / voting the scores of every rank's block (the
            # query groups straddle blocks): each rank computes every
            # row's gradients and keeps its own
            score = torch.zeros((K, self.n_pad), dtype=torch.float32,
                                device=pay.device) if zero_score \
                else self.to_original(snap)
            custom = objective.get_gradients_multi(score, self.label_orig,
                                                   self.weight_orig)
        return self.from_original(custom[0]), self.from_original(custom[1])

    def class_gradients(self, objective, k: int, zero_score: bool = False):
        """Class k's unmasked (gradient, hessian), [n_rows] each, in the
        payload's current row order (the JAX package's _class_grads; a
        non-rowwise objective trains one class)."""
        g, h = self.all_gradients(objective, zero_score)
        return g[k], h[k]

    def gather_custom_gradients(self, custom, k: int):
        """Class k's plane of caller-supplied ORIGINAL-order [K, n_pad]
        (gradient, hessian), gathered into the payload's current row order
        through the index column (guard rows gather an appended 0)."""
        return (self.from_original(custom[0][k:k + 1])[0],
                self.from_original(custom[1][k:k + 1])[0])

    def fill_gradients(self, objective, k: int = 0, qmax: int = 0,
                       generator: Optional[torch.Generator] = None,
                       custom=None, zero_score: bool = False):
        """Write class k's masked gradients of the snapshot scores (or of
        `custom`, a custom objective's [K, n_pad] pair) into the grad/hess
        columns, in the payload's current row order.  With
        qmax > 0 (the quantized mode, gbdt.py:500-511 of the JAX package)
        they are quantized first, after the count mask, with `generator`'s
        draws, and the [2] f32 scales are returned.  Else the int32 [2]
        fixed-point exponents of the tree's f32 histograms are returned
        (`seg.fixed_exponents` of the largest |grad|, |hess| over every
        payload row), computed on the device with no host read.
        zero_score: the gradients of all-zero scores (RF, the JAX
        package's step_rf)."""
        pay = self.payload
        g, h = self.class_gradients(objective, k, zero_score) \
            if custom is None else self.gather_custom_gradients(custom, k)
        # masked rows (padding, guards, out of the bag) are selected to 0,
        # not multiplied: a NaN there (NaN * 0 is NaN) would reach the
        # histogram scale below
        valid = pay[:, self.cnt_col] > 0
        g = torch.where(valid, g, 0.0)
        h = torch.where(valid, h, 0.0)
        if qmax:
            self.nonfinite = ~(torch.isfinite(g).all()
                               & torch.isfinite(h).all())

        def global_max(m):
            # the ranks' maxima and predicate, in one exchange
            red = comm.all_reduce(torch.cat([m, self.nonfinite.to(
                m.dtype)[None]]), "max")
            self.nonfinite = red[2] > 0
            return red[:2]

        if qmax and self.mode is not None:
            # every rank rounds a row by its original row's draw, at the
            # global maxima
            g, h, scale = quantize_pair(
                g, h, generator, float(qmax), rows=self.row_index(),
                n_draw=self.n_pad,
                reduce_max=global_max if self.row_sharded else None)
        elif qmax:
            g, h, scale = quantize_pair(g, h, generator, float(qmax))
        else:
            scale = self.hist_exponents(g, h)
        seg.payload_col_write(pay, self.grad_col, g)
        seg.payload_col_write(pay, self.hess_col, h)
        return scale

    def fill_sampled(self, objective, k: int, hook=None, custom=None):
        """Class k's gradients under a row-sampling hook (GOSS; the JAX
        package's step_sampled for K = 1, apply_sample_masks +
        step_masked for K > 1): every class's gradients of the snapshot
        (or of `custom`, as all_gradients takes them),
        masked by the pristine valid column, give the hook its
        (gradient weight, count mask) = hook(g * valid, h * valid, valid),
        or (valid, valid) without a hook (GOSS's warm-up).  The weight
        goes to the gweight column and the mask to the count column, for
        K > 1 once an iteration (k == 0: the selection is the same for
        every class tree, and the columns ride each tree's partition);
        class k's g * weight and h * weight go to the grad / hess columns.
        Returns the f32 histograms' fixed-point exponents, as
        fill_gradients does.  No host read."""
        pay = self.payload
        g, h = self.all_gradients(objective, custom=custom)
        if k == 0 or self.K == 1:
            valid = pay[:, self.bvalid_col]
            gw, cm = (valid, valid) if hook is None \
                else hook(g * valid, h * valid, valid)
            seg.payload_col_write(pay, self.gweight_col, gw)
            seg.payload_col_write(pay, self.cnt_col, cm)
        gw = pay[:, self.gweight_col]
        # unsampled rows are selected to 0, not multiplied: a NaN there
        # would reach the histogram scale
        keep = gw > 0
        g = torch.where(keep, g[k] * gw, 0.0)
        h = torch.where(keep, h[k] * gw, 0.0)
        scale = self.hist_exponents(g, h)
        seg.payload_col_write(pay, self.grad_col, g)
        seg.payload_col_write(pay, self.hess_col, h)
        return scale

    def payload_tree_add(self, tree_dev: Dict[str, torch.Tensor],
                         leaf_scaled: torch.Tensor, k: int,
                         meta: FeatureMeta, bmap: BundleMap,
                         depth_iters: int) -> None:
        """score[k] += leaf_scaled[leaf of each row], each row routed by
        the payload's OWN bin columns (the JAX package's _tree_add_body):
        the bins ride the partition, so a tree replay (DART's drop and
        normalize, RF's fold) needs no original row order and no host
        read.  Guard rows route too; their scores are never read."""
        pay = self.payload

        def raw(f):
            col = self.col_of[bmap.f_group[f].long()]
            return pay.gather(1, col[:, None])[:, 0]

        nd = _leaf_of_rows(raw, pay.shape[0], tree_dev, meta, bmap,
                           depth_iters)
        seg.payload_col_write(pay, self.score0 + k, leaf_scaled[~nd], "add")

    def apply_const_score(self, delta, k: int) -> None:
        """score[k] += delta on every payload row (a stump's replay)."""
        seg.payload_col_write(self.payload, self.score0 + k, delta, "add")

    def scale_score(self, factor, k: int) -> None:
        """score[k] *= factor on every payload row."""
        seg.payload_col_write(self.payload, self.score0 + k, factor, "mul")

    def add_leaf_outputs(self, seg_start: np.ndarray, seg_cnt: np.ndarray,
                         leaf_out: np.ndarray, k: int = 0) -> None:
        """score[k] += leaf_out[leaf of each row], in place, for a tree whose
        leaves hold the payload rows [seg_start, seg_start + seg_cnt) in
        partition order: each row finds its segment by a search over the
        leaves' starts (a gather of each row's segment; the same f32 adds
        as the JAX package's bin-level payload_tree_add).  Guard rows, in
        no segment, add 0."""
        pay = self.payload
        keep = seg_cnt > 0
        order = np.argsort(seg_start[keep], kind="stable")
        table = np.stack([seg_start[keep][order],
                          (seg_start + seg_cnt)[keep][order]]
                         ).astype(np.int64)
        vals = torch.from_numpy(
            np.ascontiguousarray(leaf_out[keep][order], np.float32))
        table = torch.from_numpy(table)
        if pay.is_cuda:
            table = table.pin_memory().to(pay.device, non_blocking=True)
            vals = vals.pin_memory().to(pay.device, non_blocking=True)
        rows = torch.arange(pay.shape[0], device=pay.device)
        pos = torch.searchsorted(table[0], rows, right=True) - 1
        at = pos.clamp(min=0)
        inside = (pos >= 0) & (rows < table[1][at])
        seg.payload_col_write(pay, self.score0 + k,
                              pay[:, self.score0 + k]
                              + torch.where(inside, vals[at], 0.0))

    def renew_inputs(self, host: Dict[str, np.ndarray], k: int = 0):
        """What renewal reads, in ORIGINAL row order (the JAX package's
        _renew_leaf_values_fast): each row's leaf from the fetched segment
        table, and from one labelled blocking fetch (`renew_fetch`) of the
        count / index / score columns, its pre-tree score and whether it
        is in the bag; class k's score column.  Returns (leaf_ids, pred,
        in_bag), each [n_pad]."""
        nl = int(host["num_leaves"])
        pay = self.payload
        # f64 holds the f32 columns and the int64 row index exactly
        h = syncs.device_get(torch.stack(
            [pay[:, self.cnt_col].double(), pay[:, self.score0 + k].double(),
             self.row_index().double()], 1), label="renew_fetch")
        cnt = h[:, 0]
        idx = h[:, 2].astype(np.int64)
        lid_part = np.full(self.n_rows, nl, np.int64)
        for leaf in range(nl):
            s = int(host["seg_start"][leaf])
            lid_part[s:s + int(host["seg_cnt"][leaf])] = leaf
        if self.row_sharded:
            # every rank's rows (its own segment table places them), so
            # each renews over all the rows alike
            parts = comm.all_gather_object((idx, lid_part, h))
            idx = np.concatenate([p[0] for p in parts])
            lid_part = np.concatenate([p[1] for p in parts])
            h = np.concatenate([p[2] for p in parts])
            cnt = h[:, 0]
        keep = idx < self.n_pad
        lid = np.full(self.n_pad, nl, np.int64)
        lid[idx[keep]] = lid_part[keep]
        pred = np.zeros(self.n_pad, np.float64)
        pred[idx[keep]] = h[keep, 1]
        in_bag = np.zeros(self.n_pad, bool)
        in_bag[idx[keep]] = cnt[keep] > 0
        return lid, pred, in_bag

    def raw_scores(self, label: str = "eval_fetch") -> np.ndarray:
        """[K, n_pad] scores in ORIGINAL row order (host; one blocking
        fetch under `label`)."""
        return syncs.device_get(self.original_scores(), label=label)


def _go_left(raw: torch.Tensor, nd: torch.Tensor,
             tree_dev: Dict[str, torch.Tensor], meta: FeatureMeta,
             bmap: BundleMap) -> torch.Tensor:
    """Tree::DecisionInner (tree.h:234-249 / 288-295): whether rows whose
    node is nd (an index tensor broadcast against raw) go left, raw being
    each row's stored bin of its node's feature."""
    f = tree_dev["split_feature"][nd]
    num_bin, default_bin = meta.num_bin[f], meta.default_bin[f]
    fbin = decode_bin(raw, bmap.f_identity[f], bmap.f_offset[f], num_bin,
                      default_bin)
    mt = meta.missing_type[f]
    is_missing = ((mt == MISSING_NAN) & (fbin == num_bin - 1)) | \
                 ((mt == MISSING_ZERO) & (fbin == default_bin))
    go_left = torch.where(is_missing, tree_dev["default_left"][nd],
                          fbin <= tree_dev["split_bin"][nd])
    cat_bitset = tree_dev["split_cat_bitset"]
    return torch.where(
        tree_dev["split_is_cat"][nd],
        cat_bitset[nd, fbin.clamp(0, cat_bitset.shape[1] - 1).long()],
        go_left)


def _leaf_of_rows(gather_raw, M: int, tree_dev: Dict[str, torch.Tensor],
                  meta: FeatureMeta, bmap: BundleMap,
                  depth_iters: int) -> torch.Tensor:
    """The leaf of each of M rows as a negative node id (~leaf): one
    tree's bin-level traversal, `depth_iters` steps of `_go_left`, where
    gather_raw(f) gives each row's stored bin of its node's feature f
    ([M]).  The JAX package's _make_decision_body, eager."""
    sf = tree_dev["split_feature"]
    lc, rc = tree_dev["left_child"], tree_dev["right_child"]
    nd = torch.zeros(M, dtype=torch.int64, device=sf.device)
    for _ in range(depth_iters):
        is_leaf = nd < 0
        ndc = nd.clamp(min=0)
        go_left = _go_left(gather_raw(sf[ndc]), ndc, tree_dev, meta, bmap)
        child = torch.where(go_left, lc[ndc], rc[ndc]).long()
        nd = torch.where(is_leaf, nd, child)
    return nd


#: rows a chunk of `_leaf_of_rows_jump` takes: its [2N + 1, rows] int64
#: table is 67 MB at N = 254 internal nodes
_JUMP_ROWS = 1 << 14


def _leaf_of_rows_jump(bins_v: torch.Tensor,
                       tree_dev: Dict[str, torch.Tensor], meta: FeatureMeta,
                       bmap: BundleMap) -> torch.Tensor:
    """`_leaf_of_rows` over a [G, M] binned matrix for a tree whose depth
    the host does not know (a tree still on the device): every internal
    node's decision for every row at once, then pointer jumping over the
    rows' [node or leaf] successor table, log2 of the N internal nodes
    gathers (a path is at most N steps long) where the walk would take N
    steps.  The same leaves, so the same bits of any add they route."""
    sf = tree_dev["split_feature"]
    N, M = sf.shape[0], bins_v.shape[1]
    dev = bins_v.device
    nd = torch.arange(N, device=dev)[:, None]
    lc = tree_dev["left_child"].long()[:, None]
    rc = tree_dev["right_child"].long()[:, None]
    cols = bmap.f_group[sf].long()
    # positions: internal node n at n, leaf l at N + l (a fixed point)
    leaves = (N + torch.arange(N + 1, device=dev))[:, None]
    out = torch.empty(M, dtype=torch.int64, device=dev)
    for r0 in range(0, M, _JUMP_ROWS):
        r1 = min(r0 + _JUMP_ROWS, M)
        child = torch.where(_go_left(bins_v[cols, r0:r1], nd, tree_dev,
                                     meta, bmap), lc, rc)
        # the clamp keeps the unused nodes' children (never reached from
        # the root) inside the table
        T = torch.cat([torch.where(child >= 0, child, N + ~child),
                       leaves.expand(N + 1, r1 - r0)]).clamp_(0, 2 * N)
        for _ in range(N.bit_length()):
            T = torch.gather(T, 0, T)
        p = T[0]
        # a stump's root never resolves: leaf 0, whose output is 0
        out[r0:r1] = torch.where(p >= N, ~(p - N), -1)
    return out


def _traverse_add(bins_v: torch.Tensor, score_v: torch.Tensor,
                  leaf_out: torch.Tensor, tree_dev: Dict[str, torch.Tensor],
                  meta: FeatureMeta, bmap: BundleMap,
                  depth_iters: Optional[int], k: int = 0) -> None:
    """score_v[k] += leaf_out[leaf of each row], in place: one tree's
    traversal over a [G, M] binned matrix (the JAX package's
    _traverse_update, gbdt.py:899-911), `depth_iters` steps, or by
    pointer jumping where the host does not know the depth (None)."""
    M = bins_v.shape[1]
    if depth_iters is None:
        nd = _leaf_of_rows_jump(bins_v, tree_dev, meta, bmap)
    else:
        rows = torch.arange(M, device=bins_v.device)
        nd = _leaf_of_rows(lambda f: bins_v[bmap.f_group[f].long(), rows],
                           M, tree_dev, meta, bmap, depth_iters)
    score_v[k] += leaf_out[~nd]


def _depth_iters(tree: Tree) -> int:
    """Traversal steps that take every row to its leaf: the tree's depth.
    The JAX package runs num_leaves - 1 steps (a static trip count for
    jit); the steps past the depth leave every row where it is."""
    depth, stack = 0, [(0, 1)]
    while stack:
        node, d = stack.pop()
        for child in (int(tree.left_child[node]), int(tree.right_child[node])):
            if child < 0:
                depth = max(depth, d)
            else:
                stack.append((child, d + 1))
    return depth


def _pack_layout(out: Dict):
    """The layout of a grower output's tensor fields: (keys, shapes,
    dtypes, offsets in the flat vector)."""
    spec = sorted((k, tuple(v.shape), v.dtype) for k, v in out.items()
                  if isinstance(v, torch.Tensor))
    sizes = [int(np.prod(s, dtype=np.int64)) for _, s, _ in spec]
    return ([k for k, _, _ in spec], [s for _, s, _ in spec],
            [d for _, _, d in spec],
            np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64))


def _pack(out: Dict):
    """(flat, layout): the grower's small outputs flattened into ONE f32
    vector on their device, and its layout.  int32 fields travel as their
    bits (segment starts and counts pass f32's exact integers past 2^24
    rows); flags go as 0/1."""
    layout = _pack_layout(out)

    def flat_f32(t):
        t = t.reshape(-1)
        return t.view(torch.float32) if t.dtype == torch.int32 \
            else t.to(torch.float32)

    return torch.cat([flat_f32(out[k]) for k in layout[0]]), layout


def _unpack(flat: np.ndarray, layout, out: Dict) -> Dict[str, np.ndarray]:
    """The host dict of one packed record: each tensor field of `out` as
    a numpy array of its dtype, every other field as it is."""
    keys, shapes, dtypes, offs = layout
    host = {k: v for k, v in out.items() if not isinstance(v, torch.Tensor)}
    for i, k in enumerate(keys):
        a = flat[offs[i]:offs[i + 1]].reshape(shapes[i])
        if dtypes[i] == torch.int32:
            a = a.view(np.int32)
        elif dtypes[i] != torch.float32:
            a = a.astype(str(dtypes[i]).replace("torch.", ""))
        host[k] = a
    return host


def _fetch_packed(out: Dict) -> Dict[str, np.ndarray]:
    """The grower's small outputs in ONE device-to-host transfer through
    the sync seam (`tree_fetch`): flattened on the device, fetched once
    and split on the host (`_pack` / `_unpack`)."""
    flat, layout = _pack(out)
    return _unpack(syncs.device_get(flat, label="tree_fetch"), layout, out)


def _device_half(out: Dict, lr: float):
    """The half of a finished tree that later device work may read,
    derived from the grower's outputs with no host read (the JAX
    package's _tree_device_half, masked): the traversal arrays and the
    shrunk leaf outputs leaf_value * f32(lr), zero for a stump, so a
    replay adds +0.0 instead of needing the host's leaf count."""
    tree_dev = {k: out[k] for k in (
        "split_feature", "split_bin", "default_left", "split_is_cat",
        "split_cat_bitset", "left_child", "right_child")}
    leaf_out = torch.where(out["num_leaves"] > 1,
                           out["leaf_value"] * np.float32(lr), 0.0)
    return tree_dev, leaf_out


class GBDT:
    """The boosting engine behind Booster (plain gradient boosting; the
    variants of boosting/variants.py subclass it)."""

    #: whether each tree's shrunk outputs are added to the training
    #: scores inside its step (RF folds a running average instead)
    _fused_score_add = True
    #: whether a profiled tree runs piecewise under the phase timers (the
    #: JAX package's RF step times its bag only)
    _piecewise_profile = True
    #: whether the gradient fill samples rows (GOSS): a profiled tree
    #: times it with the growth, as the JAX package's fused sampled step
    _sampled_fill = False

    def __init__(self, config, train_set: BinnedDataset, objective,
                 metrics: List, device: torch.device,
                 init_model: Optional[GBDTModel] = None):
        """objective None is a custom objective (objective="none"): K =
        num_class trees an iteration from the caller's gradients
        (`train_one_iter(grad, hess)`).  `init_model` continues training:
        its trees are mapped onto this dataset's bins and replayed onto
        the training scores (gbdt.cpp:64-169, num_init_iteration_ > 0)."""
        self.config = config
        self.train_set = train_set
        self.objective = objective
        self.train_metrics = metrics
        self.device = device
        self.iter = 0
        self._check_supported()
        self._select_learner()
        self.timer = PhaseTimer(bool(getattr(config, "tpu_profile_phases",
                                             False)))
        # the non-finite sentinel: every tree's fetched outputs screened
        # for NaN / inf under abort | rollback; 'off' costs nothing
        self._sentinel_policy = str(getattr(config, "sentinel_nonfinite",
                                            "off") or "off").lower()
        if self._sentinel_policy not in ("off", "abort", "rollback"):
            Log.warning("sentinel_nonfinite=%s is not off|abort|rollback; "
                        "using abort", self._sentinel_policy)
            self._sentinel_policy = "abort"
        # the dispatch pipeline (pipeline_depth; the JAX package's
        # gbdt.py:1131-1154): how many trees the device may run ahead of
        # the host's Tree assembly on the fused steps.  0 is the
        # synchronous loop; 1 (the default) overlaps tree t's record
        # wait and assembly with tree t+1's dispatch; up to 8.  Leaf
        # renewal, the phase timers, RF and a custom objective's trees
        # stay synchronous, and an armed sentinel disables the pipeline:
        # it screens every iteration's outputs before the next dispatch
        self._pipeline_depth = max(0, min(
            int(getattr(config, "pipeline_depth", 1) or 0), 8))
        if self._sentinel_policy != "off" and self._pipeline_depth > 0:
            Log.info("sentinel_nonfinite=%s: the dispatch pipeline is "
                     "disabled so each iteration's tree outputs are "
                     "screened before the next dispatch",
                     self._sentinel_policy)
        self._assembler: Optional[TreeAssembler] = None
        #: pinned host slots the deferred records land in, depth + 1 of
        #: them, reused round robin (`_stage`)
        self._slots: List[Optional[torch.Tensor]] = \
            [None] * (self._pipeline_depth + 1)
        self._slot_next = 0
        #: the run's iteration whose trees ALL failed to split, found by
        #: the worker after later iterations were dispatched; flush()
        #: rolls the over-dispatch back
        self._pipe_stop_iter: Optional[int] = None
        self._pipe_k_seen = 0
        self._pipe_any_split = False
        self._in_flush = False
        # the boosting window (boost_window=J; the JAX package's
        # gbdt.py:1156-1176): J iterations dispatched at once, consumed
        # one update() at a time, truncated by exact snapshot replay
        # when an observation point lands mid-window
        self._boost_window = max(1, int(getattr(config, "boost_window", 1)
                                        or 1))
        #: the open (still being consumed) window, or None
        self._win: Optional[Dict] = None
        #: consumed windows whose trees have not all been appended (their
        #: drain is in flight), in order
        self._win_unappended: List[Dict] = []
        #: the adaptive window length: shrinks to a truncation point,
        #: grows back toward boost_window after clean windows
        self._win_adapt = self._boost_window
        self._win_clean = 0
        #: the (J, bagging) window shapes dispatched so far
        self._win_shapes: set = set()
        #: engine.train's look-ahead: iterations until the next
        #: observation point (None: unknown; the adaptive length governs)
        self._win_horizon: Optional[int] = None
        # forced splits: the JSON compiled into a static BFS schedule
        # for the grower (serial_tree_learner.cpp:546-701)
        self.forced_schedule = None
        fs_path = str(getattr(config, "forcedsplits_filename", "") or "")
        if fs_path:
            self.forced_schedule = build_forced_schedule(
                load_forced_json(fs_path), train_set.bin_mappers,
                int(config.num_leaves))
            if self.forced_schedule is not None:
                Log.info("Loaded forced splits from %s (%d nodes)",
                         fs_path, len(self.forced_schedule.feat))
        self.shrinkage_rate = float(config.learning_rate)
        self.num_class = int(config.num_class)
        self.num_tree_per_iteration = objective.num_model_per_iteration \
            if objective is not None else self.num_class
        #: blocking host syncs of every finished tree: its fetch (the
        #: tree_fetch, or the pipeline_drain its worker waited on; a
        #: window's one window_drain counts with the window's first
        #: tree) and any sync its dispatch made
        self.host_syncs: List[int] = []
        #: of those, the ones on the tree-to-tree critical path: 1 a tree
        #: at pipeline_depth=0, 0 at depth >= 1
        self.critical_syncs: List[int] = []
        #: sequential grower rounds paid by the finished trees (== splits
        #: unless the frontier-batched grower committed several per round)
        self.split_rounds: List[int] = []
        #: [name, dataset, bins on the device, [K, n_pad] scores, metrics]
        self.valid_sets: List[list] = []

        # quantized-gradient training (the JAX package's gate,
        # gbdt.py:994-1026): the grid is capped by the int32 overflow
        # bound, which raises when no grid is left.  Plain gbdt boosting
        # without forced splits only (the variants fill their own
        # gradients, the forced override reads f32 histograms): anything
        # else trains f32 with the JAX package's warning
        self._qmax = 0
        self.quant_report = None
        if bool(config.gradient_quantization) and (
                type(self) is not GBDT or self.forced_schedule is not None):
            Log.warning("gradient_quantization supports plain gbdt boosting "
                        "without forced splits; training with f32 gradients")
        elif bool(config.gradient_quantization):
            qdtype = str(config.gradient_quant_dtype or "int16")
            self._qmax = derive_qmax(train_set.num_data_padded, qdtype)
            gh_bytes = QUANT_GH_BYTES[qdtype]
            self.quant_report = {
                "dtype": qdtype, "qmax": self._qmax,
                "hist_gh_bytes_per_row": gh_bytes,
                "hist_bytes_reduction_vs_f32": F32_GH_BYTES / gh_bytes,
            }
            Log.info("gradient quantization on: %s grid (qmax=%d)", qdtype,
                     self._qmax)

        self.model = init_model if init_model is not None else GBDTModel()
        self.model.num_class = self.num_class
        self.model.num_tree_per_iteration = self.num_tree_per_iteration
        self.model.max_feature_idx = train_set.num_features - 1
        self.model.feature_names = list(train_set.feature_names)
        self.model.feature_infos = train_set.feature_infos()
        if objective is not None:
            self.model.objective_str = objective.to_string()
        self.num_init_iteration = self.model.current_iteration

        self.meta = feature_meta(train_set, device)
        # the EFB decode map (JAX gbdt.py:1028-1046; identity when the
        # dataset is unbundled): the grower's predicates and views, the
        # replays over the payload and the validation traversal read it
        self._bundled = train_set.bundle_info is not None
        self._bmap = bundle_map_from_info(train_set.bundle_info, device) \
            if self._bundled \
            else identity_bundle_map(train_set.num_features, device)
        has_cat = any(m.bin_type == BIN_TYPE_CATEGORICAL and not m.is_trivial
                      for m in train_set.bin_mappers)
        self.grower_cfg = GrowerConfig(
            num_leaves=int(config.num_leaves),
            max_depth=int(config.max_depth),
            lambda_l1=float(config.lambda_l1),
            lambda_l2=float(config.lambda_l2),
            max_delta_step=float(config.max_delta_step),
            min_data_in_leaf=int(config.min_data_in_leaf),
            min_sum_hessian_in_leaf=float(config.min_sum_hessian_in_leaf),
            min_gain_to_split=float(config.min_gain_to_split),
            with_categorical=has_cat,
            max_cat_threshold=int(config.max_cat_threshold),
            cat_l2=float(config.cat_l2),
            cat_smooth=float(config.cat_smooth),
            max_cat_to_onehot=int(config.max_cat_to_onehot),
            min_data_per_group=int(config.min_data_per_group),
            frontier_batch=max(1, int(config.tpu_frontier_batch or 1)),
            quantized=self._qmax > 0, qmax=self._qmax,
            hist_pool_slots=self._hist_pool_slots(config, train_set),
            with_monotone=bool(np.any(train_set.monotone_constraints)))

        md = train_set.metadata
        n_pad = train_set.num_data_padded
        # pre-payload scores, from the training init_score if it has one
        # (a length-N init score starts every class plane); the payload's
        # score columns take over at the first iteration
        K = self.num_tree_per_iteration
        self.score = torch.zeros((K, n_pad), dtype=torch.float32,
                                 device=device)
        if md.init_score is not None:
            self.score += torch.as_tensor(train_set.padded(
                md.init_score.astype(np.float32)), device=device)
        if objective is not None:
            objective.init(md.label, md.weight, md.query_boundaries)
        self._fast: Optional[_FastState] = None
        # False once a rollback has synced the payload's scores back to
        # self.score; the next iteration rebuilds the payload from them
        self._fast_active = False
        self.grower = None
        # the f32 grower of custom-gradient trees under
        # gradient_quantization (made on first use)
        self._grower_f32 = None
        # the sync snapshot taken before a custom objective's score fetch,
        # counted with the iteration's first tree
        self._iter_before = None
        self._warned_quant_custom = False

        # the JAX package's per-subsystem host RNG streams (bagging,
        # feature sampling), so both packages draw the same bags and
        # feature masks
        seed = int(getattr(config, "seed", 0) or 0)
        self.bagging_rng = Random(partition_seed(
            seed + int(config.bagging_seed), 1))
        self.feature_rng = Random(partition_seed(
            seed + int(config.feature_fraction_seed), 2))
        self.bag_mask_host = train_set.valid_row_mask()
        self._boosted_from_average = False
        #: f32 of the boost-from-average score added to the training and
        #: validation scores before the first tree (None: not added)
        self._init32: Optional[np.float32] = None
        # RF converts each tree's leaf outputs through the objective
        # (rf.hpp ConvertTreeOutput) and evaluates its metrics on the
        # converted scores (objective None)
        self._leaf_transform = None
        self._metric_objective = objective

        if self.num_init_iteration > 0:
            # continued training: every loaded tree's thresholds mapped
            # onto this dataset's bins, tree i replayed onto plane i % K
            # over the training bins on the device, before the payload is
            # built from self.score (no blocking host read)
            bins = self._bins_on_device(self.train_set)
            for i, tree in enumerate(self.model.trees):
                tree.set_bin_thresholds(train_set.bin_mappers)
                self._add_tree_to_train_score(tree, i % K, 1.0, bins)

    @staticmethod
    def _hist_pool_slots(config, train_set: BinnedDataset) -> int:
        """histogram_pool_size (MB, the reference's HistogramPool) -> pool
        slots of the grower, at least 2 (the JAX package's
        gbdt.py:1207-1227).  -1 keeps one histogram per leaf (0) unless
        that alone would pass 4 GB of device memory, where the pool caps
        itself with a warning."""
        L = int(config.num_leaves)
        slot_bytes = train_set.bins.shape[0] * train_set.max_num_bin * 3 * 4
        pool_mb = float(getattr(config, "histogram_pool_size", -1.0) or -1.0)
        if pool_mb > 0:
            return max(2, min(L, int(pool_mb * 1024 * 1024
                                     // max(slot_bytes, 1))))
        budget = 4 << 30
        if L * slot_bytes > budget:
            slots = max(2, int(budget // max(slot_bytes, 1)))
            Log.warning(
                "histogram memory for %d leaves would be %.1f GB; capping "
                "the histogram pool at %d slots (set histogram_pool_size "
                "to control this)", L, L * slot_bytes / 2**30, slots)
            return slots
        return 0

    def _select_learner(self) -> None:
        """The tree learner (the JAX package's gbdt.py:946-980 and its EFB
        rule, :1028-1045, with a rank of the process group as the unit):
        tree_learner=data|voting|feature trains over every rank; with no
        group, a group of one rank, or (data, voting) a padded row count
        the ranks do not divide, the serial learner trains, with the JAX
        package's warning; an EFB-bundled dataset trains feature-parallel
        serially.  A num_machines > 1 other than the world size raises."""
        cfg, ds = self.config, self.train_set
        self.parallel_mode: Optional[str] = None
        self.world, self.rank = 1, 0
        tl = str(getattr(cfg, "tree_learner", "serial") or "serial")
        if tl == "serial":
            return
        world = comm.world_size()
        nm = int(getattr(cfg, "num_machines", 1) or 1)
        if nm > 1 and nm != world:
            raise LightGBMError(
                "num_machines=%d but the process group has %d ranks; bring "
                "the group up with init_distributed (or a machine list) "
                "first" % (nm, world))
        if world <= 1:
            Log.warning("tree_learner=%s requested but only one process "
                        "is running; training with the serial learner", tl)
        elif tl in ("data", "voting") and ds.num_data_padded % world:
            Log.warning("tree_learner=%s: padded row count %d is not "
                        "divisible by %d ranks; training with the serial "
                        "learner", tl, ds.num_data_padded, world)
        elif tl == "feature" and ds.bundle_info is not None:
            Log.warning("EFB-bundled dataset: feature-parallel is not "
                        "supported with bundling; training with the serial "
                        "learner")
        else:
            self.parallel_mode = tl
            self.world, self.rank = world, comm.rank()
            Log.info("Using %s-parallel tree learner over %d ranks (rank "
                     "%d)", tl, world, self.rank)

    def _check_supported(self) -> None:
        cfg, ds = self.config, self.train_set
        unsupported = [
            (ds.num_data_padded >= 1 << 31,
             "%d rows (the segment engine's row positions are int32)"
             % ds.num_data_padded),
        ]
        if str(cfg.tpu_histogram_impl) not in ("auto", "pallas", "lax"):
            raise ValueError("tpu_histogram_impl must be one of "
                             "auto|pallas|lax, got %r"
                             % (cfg.tpu_histogram_impl,))
        for bad, what in unsupported:
            if bad:
                raise NotImplementedError(
                    "%s is not ported to the PyTorch package yet" % what)

    # -- validation (the JAX package's gbdt.py:1299-1319, 2076-2122) ----------
    def add_valid(self, name: str, valid: BinnedDataset, metrics: List) -> None:
        """Score `valid` (binned with the training mappers) after every
        tree: its bins go to the device, every existing tree is replayed
        onto its class plane (tree i onto plane i % K), and the metrics
        are initialised on its labels, weights and query groups.  This
        run's trees replay the f32 outputs their live update added
        (`Tree.valid_out`, after the boost-from-average score), so a set
        added late holds the bits of one added first.  An observation
        point: the pipeline drains and an open window is settled first,
        so the replay sees the reported trees."""
        self.flush(sync_scores=True)
        bins_v = self._bins_on_device(valid)
        K = self.num_tree_per_iteration
        score_v = torch.zeros((K, valid.num_data_padded), dtype=torch.float32,
                              device=self.device)
        if valid.metadata.init_score is not None:
            score_v += torch.as_tensor(valid.padded(
                valid.metadata.init_score.astype(np.float32)),
                device=self.device)
        if self._init32 is not None:
            score_v += self._init32
        n_init = self.num_init_iteration * K
        for i, tree in enumerate(self.model.trees):
            if i < n_init or tree.valid_out is None:
                # a loaded tree (its valid_out, if any, is another run's)
                self._add_tree_to_score(bins_v, score_v, tree, i % K)
            elif tree.num_leaves > 1:
                # this run's tree: the bits its live update added
                tree_dev, _ = self._tree_to_device(tree)
                _traverse_add(bins_v, score_v, self._upload(tree.valid_out),
                              tree_dev, self.meta, self._bmap,
                              _depth_iters(tree), i % K)
        for m in metrics:
            m.init(valid.metadata.label, valid.metadata.weight,
                   valid.metadata.query_boundaries)
        self.valid_sets.append([name, valid, bins_v, score_v, metrics])

    def _bins_on_device(self, ds: BinnedDataset) -> torch.Tensor:
        """A binned set's [G, n_pad] bins on the device, in original row
        order: the payload's bin columns, and the traversal's (a
        validation set's, or the training set's for a replay: the
        payload's bin columns ride the partition)."""
        return torch.as_tensor(ds.bins if ds.bins.dtype == np.uint8
                               else ds.bins.astype(np.int32),
                               device=self.device)

    def _add_tree_to_score(self, bins_v: torch.Tensor, score_v: torch.Tensor,
                           tree: Tree, k: int = 0,
                           scale: float = 1.0) -> None:
        """score_v[k] += scale * tree(bins_v) (scale -1: rollback)."""
        if tree.num_leaves <= 1:
            score_v[k] += np.float32(scale * tree.leaf_value[0])
            return
        tree_dev, leaf_out = self._tree_to_device(tree, scale)
        _traverse_add(bins_v, score_v, leaf_out, tree_dev, self.meta,
                      self._bmap, _depth_iters(tree), k)

    # -- score edits of the variants (the JAX package's gbdt.py:2046-2092) --
    def _leave_fast(self) -> None:
        """Leave the payload: its scores, scattered back to original row
        order on the device, become self.score; the next iteration
        rebuilds the payload in its storage (the JAX package's
        _fast_sync_back, with no host read)."""
        if self._fast_active:
            self.score = self._fast.original_scores()
            self._fast_active = False

    def _add_tree_to_train_score(self, tree: Tree, k: int, scale: float,
                                 bins: Optional[torch.Tensor] = None) -> None:
        """score[k] += scale * tree(x) over the training rows (DART's drop
        and normalize, a continued model's replay).  On the fast path the
        edit lands in the payload's score column, each row routed by the
        payload's own bin columns; a tree larger than this run's grower
        can grow leaves the payload first, as the JAX package does.
        Before the payload exists the training bins (`bins`, or uploaded
        here) route the rows of self.score.  No host read."""
        if self._fast_active and tree.num_leaves > self.grower_cfg.num_leaves:
            self._leave_fast()
        if not self._fast_active:
            if bins is None:
                bins = self._bins_on_device(self.train_set)
            self._add_tree_to_score(bins, self.score, tree, k, scale)
        elif tree.num_leaves <= 1:
            self._fast.apply_const_score(
                np.float32(scale * tree.leaf_value[0]), k)
        else:
            tree_dev, leaf_out = self._tree_to_device(tree, scale)
            self._fast.payload_tree_add(tree_dev, leaf_out, k, self.meta,
                                        self._bmap, _depth_iters(tree))

    def _add_tree_to_valid_scores(self, tree: Tree, k: int,
                                  scale: float) -> None:
        """Every validation set's score[k] += scale * tree(x)."""
        for vs in self.valid_sets:
            self._add_tree_to_score(vs[2], vs[3], tree, k, scale)

    def _multiply_scores(self, k: int, factor: float) -> None:
        """ScoreUpdater::MultiplyScore on plane k of the training scores
        (the payload's column on the fast path) and of every validation
        set (rf.hpp)."""
        f = np.float32(factor)
        if self._fast_active:
            self._fast.scale_score(f, k)
        else:
            self.score[k] *= f
        for vs in self.valid_sets:
            vs[3][k] *= f

    def _tree_to_device(self, tree: Tree, scale: float = 1.0):
        """Device arrays for the bin-level traversal of a host tree (the
        JAX package's _tree_to_device): bin thresholds and the inner
        categorical bitsets, and the leaf outputs as f32, times f32(scale)
        (rounded as the JAX package's device multiply rounds).  On the
        card they go up from pinned memory with no blocking sync."""
        ni = max(tree.num_leaves - 1, 1)
        B = self.train_set.max_num_bin
        is_cat = (tree.decision_type[:ni] & 1) != 0
        bitset = np.zeros((ni, B), dtype=bool)
        for node in np.nonzero(is_cat)[0]:
            ci = int(tree.threshold_in_bin[node])
            lo = tree.cat_boundaries_inner[ci]
            hi = tree.cat_boundaries_inner[ci + 1]
            for wi in range(lo, hi):
                word = tree.cat_threshold_inner[wi]
                for bit in range(32):
                    b = (wi - lo) * 32 + bit
                    if b < B and (word >> bit) & 1:
                        bitset[node, b] = True

        def t(a, dtype):
            a = torch.as_tensor(np.asarray(a), dtype=dtype)
            if self.device.type == "cuda":
                return a.pin_memory().to(self.device, non_blocking=True)
            return a.to(self.device)

        tree_dev = {
            "split_feature": t(tree.split_feature[:ni], torch.int64),
            "split_bin": t(np.where(is_cat, 0, tree.threshold_in_bin[:ni]),
                           torch.int32),
            "default_left": t((tree.decision_type[:ni] & 2) != 0, torch.bool),
            "split_is_cat": t(is_cat, torch.bool),
            "split_cat_bitset": t(bitset, torch.bool),
            "left_child": t(tree.left_child[:ni], torch.int64),
            "right_child": t(tree.right_child[:ni], torch.int64),
        }
        lv = tree.leaf_value[:max(tree.num_leaves, 1)].astype(np.float32)
        if scale != 1.0:
            lv = lv * np.float32(scale)
        leaf_out = t(lv, torch.float32)
        return tree_dev, leaf_out

    # -- one boosting iteration (gbdt.cpp:387-482) ---------------------------
    def train_one_iter(self, grad=None, hess=None) -> bool:
        """One iteration: K trees (one per class, in order), each from the
        snapshot of the pre-iteration scores, or from a custom objective's
        class-major [K * num_data] `grad` / `hess` (the JAX package's
        _pad_custom_gradients layout).  Training stops once every
        class's tree of an iteration is a stump (the JAX package's
        should_continue); a stump is kept in the model and moves no score
        plane.

        Where `_pipelined` holds, each tree's host half goes to the
        assembler's worker (`_defer_finish`) and the iteration reports
        continue; a no-split stop the worker finds is reported by the
        next call, once flush() has rolled back what was dispatched past
        it (the JAX package's _train_one_iter_fast, :1753-1801).  An open
        boosting window reports its next iteration, and a new window is
        dispatched where `_window_len` allows one."""
        if self._pipe_stop_iter is not None \
                and self.iter > self._pipe_stop_iter:
            self.flush()
            self._pipe_stop_iter = None
            return True
        custom = None
        if grad is not None or hess is not None:
            self.flush(sync_scores=True)
            custom = self._upload_custom_gradients(grad, hess)
            init_score = 0.0
        elif self.objective is None:
            raise LightGBMError("objective=none trains on the gradients of "
                                "a custom objective (update(fobj=...))")
        else:
            if self._win is not None:
                # the open window trained this iteration already
                return self._window_consume_one()
            J = self._window_len()
            if J >= 2:
                return self._window_dispatch(J)
            init_score = self._boost_from_average()
        defer = self._pipelined(custom)
        if not defer or self._win_unappended:
            # earlier iterations' deferred trees land before this one's:
            # a deferred tree appends itself on the worker, so a window's
            # trees still parked for the dispatch thread land first
            self.flush()
        fs = self._enter_fast()
        fmask = self._feature_sample()
        self._refresh_bag(fs)
        fs.snap_scores()
        should_continue = False
        before, self._iter_before = self._iter_before, None
        for k in range(self.num_tree_per_iteration):
            tree = self._train_tree(fs, fmask, init_score, k, custom,
                                    before if k == 0 else None, defer)
            if tree is None:
                # deferred: the worker appends it and notes a stop
                should_continue = True
                continue
            self.model.trees.append(tree)
            should_continue |= tree.num_leaves > 1
        self.iter += 1
        if not should_continue:
            Log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            return True
        return False

    def _renews(self) -> bool:
        """Whether this run's trees renew their leaf outputs (L1,
        quantile, MAPE): grown without the fused score add."""
        return self._fused_score_add and self.objective is not None \
            and self.objective.renew_tree_output_required()

    def _pipelined(self, custom=None) -> bool:
        """Whether this iteration's trees defer their host half (the JAX
        package's use_pipe, :1791-1801): the fused steps at
        pipeline_depth >= 1.  Leaf renewal and the phase timers read each
        tree on the host by construction, the sentinel screens each
        iteration before the next, RF's fold replays the host tree, and a
        custom objective's gradients come from scores the host fetched:
        those stay synchronous."""
        return (self._pipeline_depth > 0 and custom is None
                and self._fused_score_add and not self._renews()
                and not self.timer.enabled
                and self._sentinel_policy == "off")

    def _enter_fast(self) -> _FastState:
        """The payload (built on the first iteration, with the grower;
        rebuilt in its storage after the engine left it), active."""
        if self._fast is None:
            self._fast = _FastState(self, self.score)
            graph_obs.cache_event("gbdt.grower_cache", "miss")
            self.grower = make_partitioned_grower(
                self.meta, self.grower_cfg, self.train_set.max_num_bin,
                self._fast.cols, self.train_set.num_features,
                **self._grower_kwargs())
        else:
            graph_obs.cache_event("gbdt.grower_cache", "hit")
            if not self._fast_active:
                self._fast.reset(self, self.score)
        self._fast_active = True
        return self._fast

    def _upload_custom_gradients(self, grad, hess):
        """A custom objective's class-major gradients -> [K, n_pad] f32 on
        the device (padded rows 0), up from pinned memory with no blocking
        sync.  Under gradient_quantization the trees train in f32, with the
        JAX package's warning (its masked grower, which trains custom
        gradients, does not quantize)."""
        K, n = self.num_tree_per_iteration, self.train_set.num_data
        if self._qmax and not self._warned_quant_custom:
            Log.warning("gradient_quantization rides the fast path only; "
                        "this iteration trains with f32 gradients")
            self._warned_quant_custom = True
        out = []
        for a in (grad, hess):
            t = torch.zeros((K, self.train_set.num_data_padded),
                            dtype=torch.float32)
            t[:, :n] = torch.from_numpy(
                np.asarray(a, np.float32).reshape(K, n))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out.append(t)
        return tuple(out)

    def _f32_grower(self):
        """The grower of custom-gradient trees: the training grower, or
        under gradient_quantization an f32 one of the same shape."""
        if not self._qmax:
            return self.grower
        if self._grower_f32 is None:
            graph_obs.cache_event("gbdt.grower_cache", "miss")
            self._grower_f32 = make_partitioned_grower(
                self.meta, self.grower_cfg._replace(quantized=False, qmax=0),
                self.train_set.max_num_bin, self._fast.cols,
                self.train_set.num_features, **self._grower_kwargs())
        return self._grower_f32

    def _grower_kwargs(self) -> Dict:
        """The grower's forced schedule, its tree learner mode and, on a
        bundled dataset, its bundle map over the G storage columns."""
        kw = dict(forced=self.forced_schedule, mode=self.parallel_mode,
                  top_k=int(getattr(self.config, "top_k", 20) or 20))
        if self._bundled:
            kw.update(bundle_map=self._bmap,
                      num_columns=self.train_set.bins.shape[0])
        return kw

    def _train_tree(self, fs: _FastState, fmask: torch.Tensor,
                    init_score: float, k: int, custom=None,
                    before=None, defer: bool = False) -> Optional[Tree]:
        """Class k's tree: the fused step (gradients -> grow -> score
        add, with no host read until the tree's one fetch), the
        validation scores' update from the tree's device half
        (`_valid_add`), then the host's Tree.  `before` is the thread's
        sync counts taken earlier (before a custom objective's score
        fetch), counted with this tree.  With `defer` the fetch and the
        assembly go to the assembler's worker (`_defer_finish`) and None
        is returned.

        Under tpu_profile_phases the same work is timed under the JAX
        package's phase names (its _run_iter_trees with the timers on),
        each phase ending in a `profile_sync` wait: the fill ("boosting
        (gradients)"; GOSS's sampled fill is timed with the growth), the
        growth ("tree (hist+split+partition)"), the fetch and renewal
        ("leaf renewal (host)"), the fetch or assembly ("tree assemble
        (host)"), the score add ("train score update", after the
        assembly) and the validation update ("valid score update").  RF
        times its bag only.  The arithmetic is the same, so is the model
        text."""
        if before is None:
            before = syncs.thread_counts()
        lr = self.shrinkage_rate
        timer = self.timer
        timed = timer.enabled and self._piecewise_profile
        sampled = self._sampled_fill

        def phase(name, on=True):
            return timer.phase(name) if timed and on else nullcontext()

        def wait(on=True, x=None):
            if timed and on:
                timer.sync(fs.payload if x is None else x)

        # leaf-output renewal (RenewTreeOutput, serial_tree_learner.cpp
        # :780-818) needs the pre-update scores: its trees grow without
        # the fused score add
        # RF's trees are not renewed (the JAX package's step_rf)
        renew = self._renews()
        late_add = renew or (self._fused_score_add and timed and not sampled)
        with phase("tree (hist+split+partition)", sampled):
            with phase("boosting (gradients)", not sampled):
                grower, args, kw = self._fill_tree(fs, k, custom)
                wait(not sampled)
            with phase("tree (hist+split+partition)", not sampled):
                out, fs.payload, fs.aux = grower(fs.payload, fs.aux, fmask,
                                                 *args, **kw)
                if self._fused_score_add and not late_add:
                    self._add_tree_scores(fs, out, k, lr)
                wait()
        self._flag_nonfinite(fs, out)
        tracing.instant("tree dispatch", it=self.iter, k=k)
        if defer:
            self._valid_add(out, lr, k, None)
            self._defer_finish(out, init_score, lr, before)
            return None
        # the tree-to-tree critical path: the next tree waits for this
        # fetch (the JAX package's pipeline_depth=0 dispatch)
        with syncs.critical_path():
            with phase("leaf renewal (host)", renew):
                if renew:
                    host = _fetch_packed(out)
                    resilience.sentinel_check(self, host)
                    if int(host["num_leaves"]) > 1:
                        self._renew_leaf_values(fs, host, k)
            with phase("tree assemble (host)"):
                if not renew:
                    host = _fetch_packed(out)
                    resilience.sentinel_check(self, host)
                tree = self._finish_tree_host(host, init_score, lr)
        nl = int(host["num_leaves"])
        if late_add and nl > 1:
            with phase("train score update"):
                if renew:
                    fs.add_leaf_outputs(host["seg_start"][:nl],
                                        host["seg_cnt"][:nl],
                                        host["leaf_value"][:nl]
                                        * np.float32(lr), k)
                else:
                    self._add_tree_scores(fs, out, k, lr)
                wait()
        if self._fused_score_add and nl > 1:
            # a stump adds nothing (the deferred update adds its +0.0)
            with phase("valid score update"):
                self._valid_add(out, lr, k, _depth_iters(tree),
                                host["leaf_value"] if renew else None)
                if self.valid_sets:
                    wait(True, self.valid_sets[-1][3])
        t, c = syncs.thread_counts()
        self._count_tree(t - before[0], c - before[1], host)
        return tree

    def _count_tree(self, n_syncs: int, n_critical: int,
                    host: Dict[str, np.ndarray]) -> None:
        """A finished tree's blocking syncs (of them, those on the
        critical path) and its grower rounds."""
        self.host_syncs.append(n_syncs)
        self.critical_syncs.append(n_critical)
        self.split_rounds.append(int(host["split_rounds"]))

    def _valid_add(self, out: Dict, lr: float, k: int,
                   steps: Optional[int],
                   leaf_value: Optional[np.ndarray] = None) -> None:
        """Every validation set's score[k] += the tree's shrunk leaf
        outputs, routed by the tree's device half (`_device_half`, the
        JAX package's deferred valid update, gbdt.py:1703-1709): f32
        leaf_value * f32(lr), zero for a stump, at every pipeline depth
        and window length, so the validation scores are the same bits
        whatever the dispatch.  `steps` traversal steps: the host tree's
        depth where it is known; None (pointer jumping) where it is not
        yet.  `leaf_value` replaces the device's values with the host's
        renewed ones."""
        if not self.valid_sets:
            return
        tree_dev, leaf_out = _device_half(out, lr)
        if leaf_value is not None:
            lv = np.asarray(leaf_value, np.float32) * np.float32(lr)
            leaf_out = torch.from_numpy(lv)
            if self.device.type == "cuda":
                leaf_out = leaf_out.pin_memory().to(self.device,
                                                    non_blocking=True)
        for vs in self.valid_sets:
            _traverse_add(vs[2], vs[3], leaf_out, tree_dev, self.meta,
                          self._bmap, steps, k)

    # -- the dispatch pipeline (the JAX package's gbdt.py:1360-1423,
    # 1659-1714) ----------------------------------------------------------
    def _stage(self, flats: List[torch.Tensor]):
        """Copy a record (one tree's packed outputs, or a window's, in
        order) into the next pinned host slot, on the compute stream and
        before the next tree: a graph site's outputs are overwritten at
        its next replay, and the copy is enqueued ahead of it.  Returns
        (slot view, event recorded after the copy; None on the CPU,
        where the copy is done).  The slots are pipeline_depth + 1, used
        round robin: the assembler's bound keeps at most pipeline_depth
        units pending, so a slot's unit has finished before the slot
        comes round again."""
        flat = torch.cat(flats) if len(flats) > 1 else flats[0]
        n = flat.numel()
        i = self._slot_next
        self._slot_next = (i + 1) % len(self._slots)
        buf = self._slots[i]
        if buf is None or buf.numel() < n:
            buf = torch.empty(n, dtype=torch.float32,
                              pin_memory=flat.is_cuda)
            self._slots[i] = buf
        view = buf[:n]
        view.copy_(flat, non_blocking=flat.is_cuda)
        event = None
        if flat.is_cuda:
            event = torch.cuda.Event()
            event.record()
        return view, event

    @staticmethod
    def _wait_record(slot, label: str) -> np.ndarray:
        """The worker's blocking wait for a staged record, counted under
        `label` (off the critical path): the slot's event is polled, so
        the wait launches nothing and leaves the sync debug mode of the
        dispatch thread as it is.  Returns a host copy of the record."""
        view, event = slot
        if event is not None:
            pause = _POLL_S[0]
            while not event.query():
                time.sleep(pause)
                pause = min(2 * pause, _POLL_S[1])
        syncs.record(label)
        return view.numpy().copy()

    def _submit(self, fn, trees: int) -> None:
        if self._assembler is None:
            self._assembler = TreeAssembler(self._pipeline_depth)
        self._assembler.submit(fn, trees=trees)

    def _defer_finish(self, out: Dict, init_score: float, lr: float,
                      before) -> None:
        """Pipeline one tree's host half (the JAX package's
        _defer_finish): its record is staged into a pinned slot now, and
        the wait for it (`pipeline_drain`), the Tree assembly and the
        append run on the assembler's worker, strictly in dispatch order,
        while this thread dispatches the next tree.  The tree's syncs are
        its dispatch's and the drain's."""
        flat, layout = _pack(out)
        slot = self._stage([flat])
        t, c = syncs.thread_counts()
        n_syncs, n_critical = t - before[0] + 1, c - before[1]
        extra = {key: v for key, v in out.items()
                 if not isinstance(v, torch.Tensor)}
        it = self.iter
        t_dispatch = time.monotonic()

        def host_half():
            host = _unpack(self._wait_record(slot, "pipeline_drain"),
                           layout, extra)
            tree = self._finish_tree_host(host, init_score, lr)
            self.model.trees.append(tree)
            self._count_tree(n_syncs, n_critical, host)
            self._note_tree_drained(tree.num_leaves, it)
            # dispatch-to-append latency: queue wait, the record's wait
            # and the assembly
            telemetry.histogram("lgbm_pipeline_drain_seconds").observe(
                time.monotonic() - t_dispatch)

        self._submit(host_half, 1)

    def _note_tree_drained(self, num_leaves: int, it: int) -> None:
        """Worker-thread bookkeeping, in tree order: when a whole
        iteration's trees have drained and none found a split, the run
        should have stopped at that iteration."""
        self._pipe_k_seen += 1
        if num_leaves > 1:
            self._pipe_any_split = True
        if self._pipe_k_seen >= self.num_tree_per_iteration:
            if not self._pipe_any_split and self._pipe_stop_iter is None:
                self._pipe_stop_iter = it
                Log.warning("Stopped training because there are no more "
                            "leaves that meet the split requirements")
            self._pipe_k_seen = 0
            self._pipe_any_split = False

    def flush(self, sync_scores: bool = False) -> None:
        """Drain the dispatch pipeline: after this returns, model.trees
        holds every reported iteration's trees in dispatch order and any
        deferred error has been raised.  Every point that observes the
        model calls it: Booster's model reads, the eval rounds, snapshot
        capture, rollback, the fault counter and engine.train's exit.

        `sync_scores=True` also settles the device state at the reported
        iteration: an open boosting window, which ran the device ahead
        of it, is truncated by exact snapshot replay.  Score observers
        (eval rounds, raw_train_score, snapshot capture, rollback) pass
        True; pure model reads keep the default and never truncate.

        If a drained iteration had no splittable leaf, the iterations
        dispatched past it are rolled back here, in place on the payload:
        the synchronous loop would have stopped before training them."""
        if self._assembler is not None:
            self._assembler.flush()
        self._window_append_ready()
        if sync_scores:
            self._window_truncate()
        if self._in_flush:
            return
        stop = self._pipe_stop_iter
        if stop is not None and self.iter > stop + 1:
            # settle an open window at its consumed boundary first, so the
            # scores the rollback edits are the reported iteration's
            self._window_truncate()
            self._in_flush = True
            try:
                K = self.num_tree_per_iteration
                for _ in range(self.iter - (stop + 1)):
                    for k in reversed(range(K)):
                        tree = self.model.trees.pop()
                        for per_tree in (self.host_syncs,
                                         self.critical_syncs,
                                         self.split_rounds):
                            per_tree.pop()
                        if tree.num_leaves <= 1:
                            continue
                        self._add_tree_to_train_score(tree, k, -1.0)
                        self._add_tree_to_valid_scores(tree, k, -1.0)
                    self.iter -= 1
            finally:
                self._in_flush = False

    # -- the boosting window (boost_window=J; the JAX package's
    # gbdt.py:1426-1657) -------------------------------------------------
    def _window_len(self) -> int:
        """The window length of the next dispatch: boost_window, clamped
        by the adaptive truncation history and engine.train's
        observation horizon; 1 (the per-tree loop) outside the window's
        envelope: plain GBDT on one process, an objective without leaf
        renewal, f32 gradients, no forced splits, no phase timers and
        the sentinel off (the JAX package's _window_len, where GOSS's
        sample hook falls outside by its type here)."""
        J = self._boost_window
        if J <= 1 or type(self) is not GBDT or self.parallel_mode is not None:
            return 1
        if (self.objective is None or self._renews() or self._qmax
                or self.forced_schedule is not None or self.timer.enabled
                or self._sentinel_policy != "off"):
            return 1
        J = min(J, max(1, self._win_adapt))
        if self._win_horizon is not None:
            J = min(J, max(1, int(self._win_horizon)))
        return J

    def _fused_step(self, fs: _FastState, fmask: torch.Tensor, k: int,
                    lr: float) -> Dict:
        """Class k's tree as the unprofiled per-tree path dispatches it:
        the gradient fill, the growth and the fused score add, with no
        host read.  Returns the grower's outputs."""
        grower, args, kw = self._fill_tree(fs, k)
        out, fs.payload, fs.aux = grower(fs.payload, fs.aux, fmask,
                                         *args, **kw)
        self._add_tree_scores(fs, out, k, lr)
        return out

    def _window_dispatch(self, J: int) -> bool:
        """Train J iterations at once (the JAX package's
        _window_dispatch): the J iterations' host draws (feature masks,
        bags) are made first, at the RNG stream positions the per-tree
        loop would use, and uploaded once each; the window-start payload
        and scratch are copied for an exact truncation; the J*K trees are
        dispatched through the per-tree steps with no host read between
        them, each tree's packed record made on the device right after
        its growth.  The records reach the host in ONE window_drain wait,
        on the assembler's worker at pipeline_depth >= 1.  The first
        iteration is reported; the next update() calls consume the rest
        with no device work."""
        init_score = self._boost_from_average()
        fs = self._enter_fast()
        cfg = self.config
        K = self.num_tree_per_iteration
        bag_on = cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0
        # the window's shape in the program ledger (the JAX package's
        # window program cache, keyed alike); here a window replays the
        # per-tree sites, so a new shape captures nothing
        key = (J, bag_on)
        graph_obs.cache_event("gbdt.window_cache",
                              "hit" if key in self._win_shapes else "miss")
        self._win_shapes.add(key)
        it0 = self.iter
        before = syncs.thread_counts()
        rng0 = (copy.deepcopy(self.bagging_rng._rng.bit_generator.state),
                copy.deepcopy(self.feature_rng._rng.bit_generator.state),
                self.bag_mask_host.copy(), fs.bag_dirty)
        fmasks = self._upload(np.stack([self._feature_sample_host()
                                        for _ in range(J)]))
        bags = None
        if bag_on:
            bags = np.zeros((J, self.train_set.num_data_padded + 1),
                            np.float32)
            for j in range(J):
                bags[j, :-1] = self._bagging_host(it0 + j)
            bags = self._upload(bags)
        # explicit window-start copies: truncation needs the exact bits
        snap = (fs.payload.clone(), fs.aux.clone())
        lr = self.shrinkage_rate
        recs, halves = [], []
        with telemetry.span("window dispatch J=%d" % J), \
                syncs.critical_path():
            for j in range(J):
                if bag_on and ((it0 + j) % cfg.bagging_freq == 0
                               or fs.bag_dirty):
                    fs.write_bag(bags[j])
                    fs.bag_dirty = False
                fs.snap_scores()
                for k in range(K):
                    out = self._fused_step(fs, fmasks[j], k, lr)
                    tracing.instant("tree dispatch", it=it0 + j, k=k)
                    flat, layout = _pack(out)
                    recs.append(flat)
                    if self.valid_sets:
                        # kept past later trees, whose graph replays
                        # overwrite `out`
                        tree_dev, leaf_out = _device_half(out, lr)
                        halves.append(({key: v.clone() for key, v
                                        in tree_dev.items()}, leaf_out))
        extra = {key: v for key, v in out.items()
                 if not isinstance(v, torch.Tensor)}
        w = {"iter0": it0, "total": J, "consumed": 0, "appended": 0,
             "lr": lr, "snap": snap, "rng0": rng0, "halves": halves,
             "trees": [], "drained": threading.Event()}
        self._win = w
        telemetry.counter("lgbm_window_iterations_total").inc(J)
        t_dispatch = time.monotonic()
        deferred = self._pipeline_depth > 0
        # the window's one wait counts with its first tree, beside the
        # syncs of the dispatch
        t, c = syncs.thread_counts()
        first_syncs = (t - before[0] + 1, c - before[1] + int(not deferred))

        def host_half(flat: np.ndarray):
            n = int(layout[3][-1])
            trees = []
            stop_at = None
            for j in range(J):
                any_split = False
                for k in range(K):
                    i = j * K + k
                    host = _unpack(flat[i * n:(i + 1) * n], layout, extra)
                    tree = self._finish_tree_host(
                        host, init_score if j == 0 else 0.0, lr)
                    n_syncs, n_critical = first_syncs if i == 0 else (0, 0)
                    trees.append((tree, n_syncs, n_critical,
                                  int(host["split_rounds"])))
                    if tree.num_leaves > 1:
                        any_split = True
                if not any_split and stop_at is None:
                    stop_at = it0 + j
            w["trees"] = trees
            if stop_at is not None and self._pipe_stop_iter is None:
                self._pipe_stop_iter = stop_at
                Log.warning("Stopped training because there are no more "
                            "leaves that meet the split requirements")
            w["drained"].set()
            telemetry.histogram("lgbm_pipeline_drain_seconds").observe(
                time.monotonic() - t_dispatch)

        if deferred:
            slot = self._stage(recs)
            self._submit(lambda: host_half(self._wait_record(
                slot, "window_drain")), J * K)
        else:
            with syncs.critical_path():
                host_half(syncs.device_get(torch.cat(recs),
                                           label="window_drain"))
        return self._window_consume_one()

    def _window_consume_one(self) -> bool:
        """Report one iteration the open window already trained (the JAX
        package's _window_consume_one): move the validation scores by its
        trees' device halves (lazily, so they never run ahead of the
        reported iteration), append its trees once their drain has
        landed, and surface the per-tree loop's no-split stop."""
        w = self._win
        j = w["consumed"]
        K = self.num_tree_per_iteration
        if w["halves"]:
            with syncs.critical_path():
                for k in range(K):
                    tree_dev, leaf_out = w["halves"][j * K + k]
                    for vs in self.valid_sets:
                        _traverse_add(vs[2], vs[3], leaf_out, tree_dev,
                                      self.meta, self._bmap, None, k)
        w["consumed"] = j + 1
        self.iter += 1
        finished = False
        if w["drained"].is_set() and w["trees"]:
            finished = all(t[0].num_leaves <= 1
                           for t in w["trees"][j * K:(j + 1) * K])
        self._window_append_ready()
        if w["consumed"] >= w["total"]:
            # fully consumed: it can never truncate again; the parked
            # trees stay until their drain lands
            self._win = None
            w["snap"] = None
            w["halves"] = None
            if w["appended"] < w["total"] * K:
                self._win_unappended.append(w)
            self._win_clean += 1
            if self._win_clean >= 2 and self._win_adapt < self._boost_window:
                self._win_clean = 0
                self._win_adapt = min(self._boost_window,
                                      max(2, self._win_adapt * 2))
        if finished and self._pipe_stop_iter is not None \
                and self.iter > self._pipe_stop_iter:
            self._pipe_stop_iter = None
        return finished

    def _window_append_ready(self) -> None:
        """Append drained window trees to the model, in dispatch order, up
        to the reported (consumed) iteration; trees whose drain has not
        landed stay parked (flush()'s assembler barrier completes them for
        every observer)."""
        K = self.num_tree_per_iteration

        def append(w, upto):
            while w["appended"] < upto:
                tree, n_syncs, n_critical, rounds = w["trees"][w["appended"]]
                self.model.trees.append(tree)
                self.host_syncs.append(n_syncs)
                self.critical_syncs.append(n_critical)
                self.split_rounds.append(rounds)
                w["appended"] += 1

        while self._win_unappended:
            w0 = self._win_unappended[0]
            if not w0["drained"].is_set():
                return    # in order: later windows wait too
            append(w0, w0["total"] * K)
            self._win_unappended.pop(0)
        w = self._win
        if w is not None and w["drained"].is_set():
            append(w, w["consumed"] * K)

    def _window_truncate(self) -> None:
        """Settle an open window at its consumed boundary (the JAX
        package's _window_truncate): drop its unreported trees, restore
        the window-start payload and scratch (in their storage, which the
        grower's graphs read) and the host RNG and bag state, and replay
        the consumed iterations through the per-tree steps, bit for bit.
        Costs `consumed` iterations of device work; the adaptive length
        shrinks to the truncation point, so repeated observations stop
        paying it."""
        w = self._win
        if w is None:
            return
        if self._assembler is not None:
            self._assembler.flush()
        self._window_append_ready()
        self._win = None
        c = w["consumed"]
        self._win_adapt = max(1, min(self._win_adapt, c))
        self._win_clean = 0
        telemetry.counter("lgbm_window_truncations_total").inc()
        fs = self._fast
        fs.payload.copy_(w["snap"][0])
        fs.aux.copy_(w["snap"][1])
        w["snap"] = w["halves"] = None
        bag_state, feat_state, bag_mask0, bag_dirty0 = w["rng0"]
        self.bagging_rng._rng.bit_generator.state = bag_state
        self.feature_rng._rng.bit_generator.state = feat_state
        self.bag_mask_host = bag_mask0
        fs.bag_dirty = bag_dirty0
        it_end = self.iter
        self.iter = w["iter0"]
        try:
            with syncs.critical_path():
                for _ in range(c):
                    fmask = self._feature_sample()
                    self._refresh_bag(fs)
                    fs.snap_scores()
                    for k in range(fs.K):
                        self._fused_step(fs, fmask, k, w["lr"])
                    self.iter += 1
        finally:
            self.iter = it_end
        # a stop found in the truncated (never reported) iterations never
        # happened; the run finds it again if it is real
        if self._pipe_stop_iter is not None \
                and self._pipe_stop_iter > self.iter - 1:
            self._pipe_stop_iter = None

    def _fill_tree(self, fs: _FastState, k: int, custom=None):
        """Write class k's gradients into the payload (the caller's
        `custom` pair, the quantized fill, or `_fill`); returns the grower
        that grows them, its extra positional and keyword arguments."""
        if custom is not None:
            return self._f32_grower(), (), dict(
                hist_scale=self._fill(fs, k, custom),
                nonfinite=fs.nonfinite)
        if self._qmax:
            # one generator per (iteration, class), seeded on the JAX
            # schedule, so reruns on one device quantize identically
            gen = torch.Generator(device=self.device)
            gen.manual_seed(quant_seed(self.config.seed or 0, self.iter,
                                       self.num_tree_per_iteration, k))
            return self.grower, (fs.fill_gradients(
                self.objective, k, self._qmax, gen),), {}
        return self.grower, (), dict(hist_scale=self._fill(fs, k),
                                     nonfinite=fs.nonfinite)

    @staticmethod
    def _add_tree_scores(fs: _FastState, out: Dict, k: int,
                         lr: float) -> None:
        """score[k] += lr * each row's leaf value, on the device.  Stumps
        must not move the scores (gbdt.cpp stops instead): the add is
        predicated on the device's leaf count."""
        col = fs.score0 + k
        score = fs.payload[:, col]
        seg.payload_col_write(fs.payload, col, torch.where(
            out["num_leaves"] > 1,
            score + fs.payload[:, fs.value_col] * lr, score))

    def _flag_nonfinite(self, fs: _FastState, out: Dict) -> None:
        """Under the sentinel, the fill's device flag beside the tree's
        outputs (fetched with them, no fetch of its own): whether any
        gradient or hessian the tree read is not finite."""
        if self._sentinel_policy != "off":
            out[resilience.NONFINITE_KEY] = fs.nonfinite

    def _fill(self, fs: _FastState, k: int, custom=None):
        """Write class k's f32 gradients (of the scores, or the custom
        objective's `custom` pair) into the payload and return the
        histograms' fixed-point exponents (the variants' hook: GOSS
        samples, RF takes the zero score's gradients)."""
        return fs.fill_gradients(self.objective, k, custom=custom)

    def _renew_leaf_values(self, fs: _FastState, host: Dict[str, np.ndarray],
                           k: int = 0) -> None:
        """RenewTreeOutput on the partitioned path (the JAX package's
        _renew_leaf_values_fast): the objective renews the fetched leaf
        values on the host from the rows' pre-tree scores in original
        order (the second blocking fetch of the tree), and the renewed
        values replace the fetched ones (as f32, as the JAX package stores
        them); `_train_tree` adds their shrunk outputs to the scores."""
        nl = int(host["num_leaves"])
        lid, pred, in_bag = fs.renew_inputs(host, k)
        lv = host["leaf_value"].astype(np.float64)
        renewed = self.objective.renew_leaf_values(lv[:nl], lid, pred, in_bag)
        host["leaf_value"] = host["leaf_value"].copy()
        host["leaf_value"][:nl] = renewed

    def _bagging_host(self, it: int) -> np.ndarray:
        """The bag of iteration `it` (the JAX package's _bagging_host):
        on the bagging_freq grid, int(num_data * bagging_fraction) rows
        drawn from the bagging stream; between resamples, the last bag."""
        cfg = self.config
        n = self.train_set.num_data
        if cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0 \
                and it % cfg.bagging_freq == 0:
            idx = self.bagging_rng.sample(n, int(n * cfg.bagging_fraction))
            mask = np.zeros(self.train_set.num_data_padded, np.float32)
            mask[idx] = 1.0
            self.bag_mask_host = mask
        return self.bag_mask_host

    def _refresh_bag(self, fs: _FastState) -> None:
        """Bagging (gbdt.cpp:213-295) through the count column every grower
        mode reads (the JAX package's _fast_refresh_bag): the column rides
        the partition, so only a resample, or a payload rebuilt after a
        rollback (`fs.bag_dirty`: its count column is the plain valid
        mask), refreshes it."""
        cfg = self.config
        if not (cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0):
            return
        with self.timer.phase("bagging"):
            resampled = self.iter % cfg.bagging_freq == 0
            bag = self._bagging_host(self.iter)
            if resampled or fs.bag_dirty:
                fs.set_bag(bag)
                fs.bag_dirty = False
            self.timer.sync(fs.payload)

    def _boost_from_average(self) -> float:
        if self._boosted_from_average or self.model.current_iteration > 0 \
                or self.train_set.metadata.init_score is not None \
                or self.num_class > 1 or self.objective is None:
            return 0.0
        self._boosted_from_average = True
        if not bool(self.config.boost_from_average):
            return 0.0
        init = self.objective.boost_from_score()
        if abs(init) > K_EPSILON:
            # the training scores and every validation set's take f32(init)
            # now (the JAX package's gbdt.py:2156-2158); the first tree's
            # leaves carry it in the model
            self.score = self.score + np.float32(init)
            self._init32 = np.float32(init)
            for vs in self.valid_sets:
                vs[3] += self._init32
            Log.info("Start training from score %f", init)
            return init
        return 0.0

    def _feature_sample_host(self) -> np.ndarray:
        """One iteration's feature mask, drawn on the host (the window
        stacks J of them into one upload)."""
        cfg = self.config
        f = self.train_set.num_features
        mask = np.zeros(f, dtype=bool)
        if cfg.feature_fraction < 1.0:
            used = max(1, int(f * cfg.feature_fraction))
            mask[self.feature_rng.sample(f, used)] = True
        else:
            mask[:] = True
        return mask

    def _feature_sample(self) -> torch.Tensor:
        return self._upload(self._feature_sample_host())

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the training device; on the card from pinned
        memory, so the copy does not wait for the stream."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _finish_tree_host(self, host: Dict[str, np.ndarray],
                          init_score: float, lr: float) -> Tree:
        """Fetched grower outputs -> reference Tree (the JAX package's
        _finish_tree_host)."""
        nl = int(host["num_leaves"])
        L = self.grower_cfg.num_leaves
        tree = Tree(max(L, 2))
        tree.num_leaves = nl
        if self._leaf_transform is not None:
            # RF: the objective's output conversion of every leaf, in f64
            # (the JAX package's _finish_tree_host :2314-2320)
            host["leaf_value"] = self._leaf_transform(
                np.asarray(host["leaf_value"], np.float64))
        if nl > 1:
            ni = nl - 1
            ds = self.train_set
            tree.split_feature[:ni] = host["split_feature"][:ni]
            is_cat_nodes = host["split_is_cat"][:ni].astype(bool)
            tree.split_gain[:ni] = host["split_gain"][:ni]
            dt = np.where(is_cat_nodes, 1,
                          host["default_left"][:ni].astype(np.int8) << 1)
            miss = np.asarray([ds.bin_mappers[int(f)].missing_type
                               for f in host["split_feature"][:ni]],
                              dtype=np.int8)
            dt |= (miss << 2)
            tree.decision_type[:ni] = dt
            for node in range(ni):
                f = int(host["split_feature"][node])
                if is_cat_nodes[node]:
                    # the threshold slots hold the cat index; bitsets over
                    # category values (model text, raw prediction) and over
                    # bins (the validation traversal), tree.cpp
                    # SplitCategorical
                    chosen = np.nonzero(host["split_cat_bitset"][node])[0]
                    cat_idx = tree.num_cat
                    tree.threshold_in_bin[node] = cat_idx
                    tree.threshold[node] = float(cat_idx)
                    tree.num_cat += 1
                    mapper = ds.bin_mappers[f]
                    vals = [int(mapper.bin_2_categorical[int(b)])
                            for b in chosen
                            if int(b) < len(mapper.bin_2_categorical)]
                    tree.cat_threshold.extend(_construct_bitset(vals))
                    tree.cat_boundaries.append(len(tree.cat_threshold))
                    tree.cat_threshold_inner.extend(
                        _construct_bitset([int(b) for b in chosen]))
                    tree.cat_boundaries_inner.append(
                        len(tree.cat_threshold_inner))
                else:
                    b = int(host["split_bin"][node])
                    tree.threshold_in_bin[node] = b
                    tree.threshold[node] = ds.real_threshold(f, b)
            tree.left_child[:ni] = host["left_child"][:ni]
            tree.right_child[:ni] = host["right_child"][:ni]
            tree.internal_value[:ni] = host["internal_value"][:ni] * lr
            tree.internal_count[:ni] = host["internal_count"][:ni].astype(np.int64)
            tree.leaf_value[:nl] = host["leaf_value"][:nl].astype(np.float64) * lr
            tree.leaf_count[:nl] = host["leaf_count"][:nl].astype(np.int64)
            tree.leaf_parent[:] = -1
            for node in range(ni):
                for child in (tree.left_child[node], tree.right_child[node]):
                    if child < 0:
                        tree.leaf_parent[~child] = node
            tree.shrinkage = lr
            if abs(init_score) > K_EPSILON:
                tree.leaf_value[:nl] += init_score
                tree.shrinkage = 1.0
        else:
            tree.leaf_value[0] = float(host["leaf_value"][0]) * lr + init_score
            tree.shrinkage = 1.0
        if self._fused_score_add:
            # what `_valid_add` adds: f32 leaf_value * f32(lr), nothing for
            # a stump (the boost-from-average score goes to the validation
            # scores on its own)
            tree.valid_out = np.asarray(host["leaf_value"][:nl], np.float32) \
                * np.float32(lr) if nl > 1 else np.zeros(0, np.float32)
        return tree

    def split_rounds_per_tree(self) -> Optional[float]:
        """Mean sequential grower rounds per finished tree (< splits per
        tree once the frontier-batched grower commits several splits in
        one round)."""
        if not self.split_rounds:
            return None
        return sum(self.split_rounds) / len(self.split_rounds)

    # -- rollback and parameter reset (gbdt.py:2005-2038 of the JAX package)
    def reset_config(self, new_params: Dict) -> None:
        """Booster::ResetConfig: the new values take effect on the next
        iteration.  The grower's configuration is built once, so what
        moves is what the engine reads every iteration: the learning rate
        (the shrinkage), bagging and feature fraction."""
        from ..config import Config
        if self._win is not None:
            # an observation point: the iterations the open window trained
            # past the reported one used the old parameters
            self.flush(sync_scores=True)
        self.config.set(new_params)
        if any(Config.resolve_alias(k) == "learning_rate"
               for k in new_params):
            self.shrinkage_rate = float(self.config.learning_rate)

    def rollback_one_iter(self) -> None:
        """RollbackOneIter (gbdt.cpp:484-500): leave the payload (its
        scores scattered back to original order on the device), subtract
        each class tree of the last iteration from the training scores and
        from every validation set by the bin-level traversal with negated
        leaf outputs, drop the trees.  The next iteration rebuilds the
        payload in its storage and applies the bag again."""
        self.flush(sync_scores=True)
        if self.iter <= 0:
            return
        self._leave_fast()
        bins = self._bins_on_device(self.train_set)
        for k in reversed(range(self.num_tree_per_iteration)):
            tree = self.model.trees.pop()
            if tree.num_leaves <= 1:
                continue
            self._add_tree_to_score(bins, self.score, tree, k, -1.0)
            self._add_tree_to_valid_scores(tree, k, -1.0)
        self.iter -= 1

    # -- evaluation ----------------------------------------------------------
    def raw_train_score(self, label: str = "eval_fetch") -> np.ndarray:
        """[K, num_data] training scores at the reported iteration (host;
        one blocking fetch under `label`)."""
        self.flush(sync_scores=True)
        return syncs.device_get(self._train_scores_device(),
                                label=label)

    def _train_scores_device(self) -> torch.Tensor:
        """[K, num_data] training scores in original row order, on the
        device (all-gathered under data / voting)."""
        score = self._fast.original_scores() if self._fast_active \
            else self.score
        return score[:, : self.train_set.num_data]

    def custom_objective_scores(self) -> np.ndarray:
        """The training scores a custom objective is called on: one
        blocking fetch under its own label (`fobj_fetch`), counted with
        the next iteration's first tree, whose own fetch makes two."""
        self._iter_before = syncs.thread_counts()
        return self.raw_train_score("fobj_fetch")

    @staticmethod
    def _metric_input(raw: np.ndarray, m) -> np.ndarray:
        """Metrics see score plane 0, except the multiclass metrics, which
        take the whole [K, N] matrix (multiclass_metric.hpp Eval)."""
        return raw if getattr(m, "multiclass", False) else raw[0]

    def _eval(self, name: str, raw: np.ndarray, metrics: List):
        return [(name, m.name, m.eval(self._metric_input(raw, m),
                                      self._metric_objective),
                 m.is_higher_better)
                for m in metrics]

    def raw_valid_score(self, i: int) -> np.ndarray:
        """[K, num_data] scores of validation set i (host)."""
        self.flush()
        _, valid, _, score_v, _ = self.valid_sets[i]
        return syncs.device_get(score_v[:, : valid.num_data],
                                label="eval_fetch")

    def _packed_eval_fetch(self, arrays: List[torch.Tensor]
                           ) -> List[np.ndarray]:
        """ONE blocking fetch for a whole eval round (the JAX package's
        _packed_eval_fetch, gbdt.py:2399): the round's score planes
        flattened into one vector on the device, fetched once and split
        on the host, so metric_freq=1 pays one round trip, not one a
        dataset."""
        if not arrays:
            return []
        if len(arrays) == 1:
            return [syncs.device_get(arrays[0], label="eval_fetch")]
        spec = [tuple(a.shape) for a in arrays]
        offs = np.cumsum([0] + [int(np.prod(sh, dtype=np.int64))
                                for sh in spec])
        flat = syncs.device_get(torch.cat([a.reshape(-1) for a in arrays]),
                                label="eval_fetch")
        return [flat[offs[i]:offs[i + 1]].reshape(sh)
                for i, sh in enumerate(spec)]

    def _eval_raws(self, want_train: bool, want_valid: bool):
        """(train raw, [valid raws]) of an eval round, off one packed
        fetch (the JAX package's _eval_raws).  The flush makes every eval
        a pipeline barrier, so callbacks that observe the model see every
        tree, and settles an open window at the reported iteration."""
        self.flush(sync_scores=True)
        arrays = [self._train_scores_device()] if want_train else []
        if want_valid:
            arrays.extend(vs[3][:, : vs[1].num_data]
                          for vs in self.valid_sets)
        host = self._packed_eval_fetch(arrays)
        train_raw = host.pop(0) if want_train else None
        return train_raw, host

    def _eval_valid_results(self, raws) -> List[Tuple[str, str, float,
                                                      bool]]:
        out = []
        for (name, _, _, _, metrics), raw in zip(self.valid_sets, raws):
            out.extend(self._eval(name, raw, metrics))
        return out

    def eval_train(self) -> List[Tuple[str, str, float, bool]]:
        raw, _ = self._eval_raws(True, False)
        return self._eval("training", raw, self.train_metrics)

    def eval_valid(self) -> List[Tuple[str, str, float, bool]]:
        _, raws = self._eval_raws(False, True)
        return self._eval_valid_results(raws)

    def eval_all(self, include_train: bool):
        """One eval round: the training metrics (when asked) and every
        validation set's, off a single packed fetch."""
        raw, raws = self._eval_raws(include_train, True)
        train_res = self._eval("training", raw, self.train_metrics) \
            if include_train else []
        return train_res, self._eval_valid_results(raws)
