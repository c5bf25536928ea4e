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

The port covers the serial, unforced, non-monotone path, in f32 or
quantized (int32 histograms, dequantized at the split search), one leaf
per round or frontier-batched, with the JAX grower's three histogram
modes.  The JAX grower is one on-device `lax.while_loop`; this one is an
eager Python loop.

- One leaf per round (the default): the loop reads the argmax leaf and
  its gain from the device once per split (one host sync, counted in the
  tree's `host_syncs`) and stops when no positive-gain split remains.
  Everything else — segment bounds, num_left, the split records — stays
  on the device.
- Histogram modes of the one-leaf loop:
  - per-leaf state (the default): one `[F, B, 3]` histogram per leaf; a
    split builds the smaller child from rows and the sibling by
    subtraction from the parent's;
  - the LRU pool (`GrowerConfig.hist_pool_slots`, from
    histogram_pool_size; HistogramPool, feature_histogram.hpp:655-826):
    fewer slots than leaves, the left child takes its parent's slot, the
    right the least recently used one, and a split whose parent was
    evicted rebuilds the parent's histogram from its contiguous rows.
    The slot bookkeeping follows leaf ids only, so it lives on the host,
    fed by the split's one read: the pool adds no sync;
  - merged (`merged_hist`): each split partitions the leaf and takes
    both children's histograms from one kernel (B6,
    `cuda_segment.partition_segment_hist`), so no histogram state, parent
    or subtraction is kept.  Past B6's gate the split partitions through
    the route and walks both children (the JAX package's part_hist_fn).
- Frontier-batched (`GrowerConfig.frontier_batch` = K > 1, the JAX
  package's `round_body`): each round stages the partitions of the K
  best frontier leaves, builds the K smaller children's histograms in ONE
  batched launch, searches the 2K children at once, then replays the
  sequential grower's argmax order on the host against those
  evaluations and commits the splits it accepts.  The round's one host
  sync fetches the gains the replay needs; the host then knows every
  leaf's gain, so no other read is needed.  Models are byte-identical to
  K = 1 (see `frontier_round` in `make_partitioned_grower`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import cuda_segment
from ..ops.bundle import identity_bundle_map
from ..ops.segment import GUARD, SplitPredicate, payload_col_write
from ..ops.split import (FeatureMeta, K_MIN_SCORE, dequantize_hist,
                         find_best_split_batched, leaf_output)


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


class PayloadCols(NamedTuple):
    """Column indices of the value columns inside the payload
    (bin columns occupy [0, F))."""
    grad: int
    hess: int
    cnt: int       # 0/1 count-mask (valid & bagged)
    value: int     # per-row current-tree leaf output


#: grower-output fields forming the device half of a finished tree (the
#: gbdt <-> grower2 contract of the JAX package, grower2.py:62)
TREE_DEVICE_FIELDS = ("split_feature", "split_bin", "default_left",
                      "split_is_cat", "split_cat_bitset", "left_child",
                      "right_child")

#: per-leaf records of a leaf's best split, and the SplitResult field each
#: is taken from
_BEST_FIELDS = (("bgain", "gain"), ("bfeat", "feature"),
                ("bbin", "threshold_bin"), ("bdleft", "default_left"),
                ("blg", "left_sum_g"), ("blh", "left_sum_h"),
                ("blc", "left_count"), ("bcat", "is_cat"),
                ("bbitset", "cat_bitset"), ("blo", "left_output"),
                ("bro", "right_output"))

#: per-node records of the finished tree
_NODE_FIELDS = ("split_feature", "split_bin", "split_gain", "default_left",
                "split_is_cat", "split_cat_bitset", "left_child",
                "right_child", "internal_value", "internal_count")


def make_partitioned_grower(meta: FeatureMeta, cfg: GrowerConfig,
                            num_bins_max: int, cols: PayloadCols,
                            num_features: int, merged_hist=None):
    """Returns grow(payload, aux, feature_mask[, qscale][, hist_scale]) ->
    (tree dict, payload, aux).

    payload/aux: [N_pad + GUARD, P] f32 with a GUARD-row tail whose
    count-mask is 0.  Valid rows are [0, N_pad); the root segment covers
    all of them whatever order previous trees left them in.  payload and
    aux are updated in place.  Numerical splits only (the categorical
    search and monotone constraints are not ported; gbdt refuses them).
    Storage columns are the features themselves (no EFB bundles).

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
    (the JAX gate, grower2.py:333-334)."""
    L = cfg.num_leaves
    B = num_bins_max
    F = num_features
    quantized = bool(cfg.quantized)
    if quantized and cfg.qmax < 2:
        raise ValueError("the quantized grower needs the derive_qmax grid "
                         "(qmax >= 2), got %d" % cfg.qmax)
    find_kwargs = dict(
        l1=cfg.lambda_l1, l2=cfg.lambda_l2, max_delta_step=cfg.max_delta_step,
        min_data_in_leaf=cfg.min_data_in_leaf,
        min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
        min_gain_to_split=cfg.min_gain_to_split)
    hist_kwargs = dict(num_features=F, num_bins=B, grad_col=cols.grad,
                       hess_col=cols.hess, cnt_col=cols.cnt)
    # the histogram pool (grower2.py:301-310 of the JAX package)
    slots = int(cfg.hist_pool_slots or 0)
    POOL = slots if 0 < slots < L else L
    if POOL < 2:
        raise ValueError("the histogram pool needs at least 2 slots, got %d"
                         % POOL)
    # the JAX gate (grower2.py:325-350): serial and unforced hold by
    # construction here; unpooled and unmerged are read per call
    fb = max(int(cfg.frontier_batch or 1), 1)
    KB = min(fb, L - 1) if fb > 1 and L > 2 else 1

    def out_fn(sum_g, sum_h):
        return leaf_output(sum_g, sum_h, cfg.lambda_l1, cfg.lambda_l2,
                           cfg.max_delta_step)

    # the f32 histogram of a segment follows the route by width (B1 or
    # B7); the int32 histogram (B4) serves every width
    hist_wrapper = cuda_segment.segment_histogram_quant if quantized \
        else cuda_segment.histogram_route(F)

    def grow(payload: torch.Tensor, aux: torch.Tensor,
             feature_mask: torch.Tensor, qscale: torch.Tensor = None,
             hist_scale: torch.Tensor = None):
        dev = payload.device
        # the f32 histograms' fixed-point exponents on the card: the
        # caller's for the tree, else each wrapper derives its own
        fixed = {} if quantized else dict(scale=hist_scale)

        def hist_fn(payload, start, count):
            return hist_wrapper(payload, start, count, **hist_kwargs, **fixed)

        def hist_batched_fn(payload, starts, counts):
            return cuda_segment.segment_histogram_batched(
                payload, starts, counts, quantized=quantized, **hist_kwargs,
                **fixed)

        width = payload.shape[1]
        fits = cuda_segment.partition_hist_fits(width, F, B)
        if quantized:
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
        # the one-leaf loop's partition follows the route by payload width
        # (B2, B3 or B8); the frontier rounds stage and commit through B2
        part_fn = cuda_segment.partition_route(width)
        if fused:
            grow.hist_engine = grow.part_engine = "partition_segment_hist"
        else:
            grow.hist_engine = hist_wrapper.__name__
            grow.part_engine = "partition_segment_stage" if frontier \
                else part_fn.__name__
        bmap = identity_bundle_map(F, dev)
        n_rows = payload.shape[0] - GUARD
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)

        # dequantize at the boundary: int32 histograms become f32 views
        # exactly where the split search consumes them
        if quantized:
            if qscale is None:
                raise ValueError("the quantized grower needs the [2] scales")

            def deq(h):
                return dequantize_hist(h, qscale[0], qscale[1])
        else:
            def deq(h):
                return h

        def find_split_batched(hists, sgs, shs, cnts):
            """The one search routine: root (Q = 1), the two children of a
            split (Q = 2) and the 2K children of a frontier round."""
            return find_best_split_batched(deq(hists), sgs, shs, cnts,
                                           feature_mask, meta=meta,
                                           **find_kwargs)

        # a filled device scalar, not torch.tensor: a host-to-device copy
        # would wait for the stream
        hist_root = hist_fn(payload, torch.zeros((), **i32),
                            torch.full((), n_rows, **i32))
        # every row lands in exactly one bin of storage column 0, so the
        # root totals fall out of the histogram (exact integers in the
        # quantized mode, f32 only from the boundary on)
        totals = deq(torch.sum(hist_root[0], dim=0, dtype=hist_root.dtype))
        root_g, root_h, root_c = totals[0], totals[1], totals[2]
        res0 = find_split_batched(hist_root[None], totals[0:1], totals[1:2],
                                  totals[2:3])
        # rows start as one root segment with the root Newton step as the
        # per-row output (covers the unsplittable-stump case)
        payload_col_write(payload, cols.value, out_fn(root_g, root_h))

        ni = max(L - 1, 1)
        st = {
            "seg_start": torch.zeros(L, **i32),
            "seg_cnt": torch.zeros(L, **i32),
            "sum_g": torch.zeros(L, **f32),
            "sum_h": torch.zeros(L, **f32),
            "cnt": torch.zeros(L, **f32),
            # creation value: 0 for the root, set by each split for its
            # children (Tree semantics, as in the JAX grower)
            "leaf_val": torch.zeros(L, **f32),
            "bgain": torch.full((L,), K_MIN_SCORE, **f32),
            "bfeat": torch.zeros(L, **i32),
            "bbin": torch.zeros(L, **i32),
            "bdleft": torch.zeros(L, dtype=torch.bool, device=dev),
            "blg": torch.zeros(L, **f32),
            "blh": torch.zeros(L, **f32),
            "blc": torch.zeros(L, **f32),
            "bcat": torch.zeros(L, dtype=torch.bool, device=dev),
            "bbitset": torch.zeros((L, B), dtype=torch.bool, device=dev),
            "blo": torch.zeros(L, **f32),
            "bro": torch.zeros(L, **f32),
            "leaf_depth": torch.zeros(L, **i32),
            "leaf_parent": torch.full((L,), -1, **i32),
            "split_feature": torch.zeros(ni, **i32),
            "split_bin": torch.zeros(ni, **i32),
            "split_gain": torch.zeros(ni, **f32),
            "default_left": torch.zeros(ni, dtype=torch.bool, device=dev),
            "split_is_cat": torch.zeros(ni, dtype=torch.bool, device=dev),
            "split_cat_bitset": torch.zeros((ni, B), dtype=torch.bool,
                                            device=dev),
            # one slot past the last node: the frontier round's parent
            # update sends the writes it must not make there
            "left_child": torch.zeros(ni + 1, **i32),
            "right_child": torch.zeros(ni + 1, **i32),
            "internal_value": torch.zeros(ni, **f32),
            "internal_count": torch.zeros(ni, **f32),
        }
        if not merged:
            # one histogram per leaf, or per pool slot; int32 in the
            # quantized mode, so the subtraction stays exact
            st["hist"] = torch.zeros((POOL, F, B, 3), dtype=hist_root.dtype,
                                     device=dev)
            st["hist"][0] = hist_root
        if pooled:
            # the LRU bookkeeping, on the host (grower2.py:574-577)
            slot_of_leaf = np.full(L, -1, np.int64)
            leaf_of_slot = np.full(POOL, -1, np.int64)
            slot_use = np.zeros(POOL, np.int64)
            slot_of_leaf[0] = leaf_of_slot[0] = 0
        st["seg_cnt"][0] = n_rows
        st["sum_g"][0] = root_g
        st["sum_h"][0] = root_h
        st["cnt"][0] = root_c
        for key, field in _BEST_FIELDS:
            st[key][0] = getattr(res0, field)[0]

        # Indexing a CUDA tensor with a 0-d tensor reads the index back to
        # the host (a sync); index_select / index_put_ with a [1] index
        # tensor stay on the device, so every per-leaf read and write of
        # the split loop goes through these two.
        def take(t, i1):
            return t.index_select(0, i1)[0]

        def put(t, i1, v):
            if isinstance(v, torch.Tensor):
                t.index_put_((i1,), v.to(t.dtype).reshape((1,) + t.shape[1:]))
            else:
                t.index_fill_(0, i1, v)

        def depth_gate(gains, child_depth):
            if cfg.max_depth > 0:
                return torch.where(child_depth < cfg.max_depth, gains,
                                   torch.full_like(gains, K_MIN_SCORE))
            return gains

        def part_hist_fn(payload, aux, start, count, pred, lo, ro):
            """The merged split: the partition and both children's
            histograms."""
            if fused:
                return cuda_segment.partition_segment_hist(
                    payload, aux, start, count, pred, lo, ro, cols.value, B,
                    num_features=F, grad_col=cols.grad, hess_col=cols.hess,
                    cnt_col=cols.cnt, **fixed)
            payload, aux, nl = part_fn(payload, aux, start, count, pred, lo,
                                       ro, cols.value)
            return (payload, aux, nl, hist_fn(payload, start, nl),
                    hist_fn(payload, start + nl, count - nl))

        def evict(slot: int) -> None:
            old = leaf_of_slot[slot]
            if old >= 0:
                slot_of_leaf[old] = -1

        def pool_store(b: int, s: int, new_left, new_right) -> None:
            """The children's histograms into the pool (grower2.py:665-695
            of the JAX package): the left child takes its parent's slot,
            or the least recently used one if the parent's was evicted;
            the right child the least recently used of the others."""
            pslot = int(slot_of_leaf[b])
            lslot = pslot
            if pslot < 0:
                lslot = int(np.argmin(slot_use))
                evict(lslot)
            leaf_of_slot[lslot] = b
            slot_use[lslot] = s
            prio = slot_use.copy()
            prio[lslot] = 1 << 30
            rslot = int(np.argmin(prio))
            evict(rslot)
            leaf_of_slot[rslot] = s
            slot_use[rslot] = s
            slot_of_leaf[b], slot_of_leaf[s] = lslot, rslot
            st["hist"][lslot] = new_left
            st["hist"][rslot] = new_right

        def do_split(s: int, bl: torch.Tensor, b: int) -> None:
            """Partition leaf `bl` (a [1] device index; `b` on the host)
            into leaves bl and s, and evaluate both children."""
            nonlocal payload, aux
            node = s - 1

            def leaf(key):
                return take(st[key], bl)

            f = leaf("bfeat")
            fl = f.long().reshape(1)
            pred = SplitPredicate(
                col=take(bmap.f_group, fl), threshold=leaf("bbin"),
                default_left=leaf("bdleft"), is_cat=leaf("bcat"),
                bitset=leaf("bbitset"),
                missing_type=take(meta.missing_type, fl),
                num_bin=take(meta.num_bin, fl),
                default_bin=take(meta.default_bin, fl),
                offset=take(bmap.f_offset, fl),
                identity=take(bmap.f_identity, fl))
            start, count = leaf("seg_start"), leaf("seg_cnt")
            # child aggregates: left from the stored split, right by diff
            lg, lh, lcnt = leaf("blg"), leaf("blh"), leaf("blc")
            pg, ph, pc = leaf("sum_g"), leaf("sum_h"), leaf("cnt")
            rg, rh, rcnt = pg - lg, ph - lh, pc - lcnt
            lo, ro = leaf("blo"), leaf("bro")

            if merged:
                payload, aux, nl_raw, new_left, new_right = part_hist_fn(
                    payload, aux, start, count, pred, lo, ro)
                nr_raw = count - nl_raw
            else:
                slot = int(slot_of_leaf[b]) if pooled else b
                if slot >= 0:
                    hist_parent = st["hist"][slot]
                else:
                    # evicted: rebuild from the parent's contiguous rows,
                    # before the partition reorders them
                    hist_parent = hist_fn(payload, start, count)

                payload, aux, nl_raw = part_fn(payload, aux, start, count,
                                               pred, lo, ro, cols.value)
                nr_raw = count - nl_raw

                # build only the smaller child (by masked counts, as the
                # JAX grower does) and derive the sibling by subtraction
                left_smaller = lcnt <= rcnt
                h_start = torch.where(left_smaller, start, start + nl_raw)
                h_count = torch.where(left_smaller, nl_raw, nr_raw)
                hist_small = hist_fn(payload, h_start, h_count)
                hist_big = hist_parent - hist_small
                new_left = torch.where(left_smaller, hist_small, hist_big)
                new_right = torch.where(left_smaller, hist_big, hist_small)

            res = find_split_batched(
                torch.stack([new_left, new_right]), torch.stack([lg, rg]),
                torch.stack([lh, rh]), torch.stack([lcnt, rcnt]))
            child_depth = leaf("leaf_depth") + 1
            gains = depth_gate(res.gain, child_depth)

            # the internal node (Tree::Split, tree.h:404-448), from the
            # pre-split records
            st["split_feature"][node] = f
            st["split_bin"][node] = pred.threshold
            st["split_gain"][node] = leaf("bgain")
            st["default_left"][node] = pred.default_left
            st["split_is_cat"][node] = pred.is_cat
            st["split_cat_bitset"][node] = pred.bitset
            st["internal_value"][node] = leaf("leaf_val")
            st["internal_count"][node] = pc
            st["left_child"][node] = ~bl[0].to(torch.int32)
            st["right_child"][node] = ~s
            parent = leaf("leaf_parent")
            pn = parent.clamp(min=0).long().reshape(1)
            was_left = take(st["left_child"], pn) == ~bl[0].to(torch.int32)
            has_par = parent >= 0
            put(st["left_child"], pn,
                torch.where(has_par & was_left, node,
                            take(st["left_child"], pn)))
            put(st["right_child"], pn,
                torch.where(has_par & ~was_left, node,
                            take(st["right_child"], pn)))

            def set2(key, vl, vr):
                put(st[key], bl, vl)
                st[key][s] = vr

            set2("seg_start", start, start + nl_raw)
            set2("seg_cnt", nl_raw, nr_raw)
            set2("sum_g", lg, rg)
            set2("sum_h", lh, rh)
            set2("cnt", lcnt, rcnt)
            set2("leaf_val", lo, ro)
            set2("leaf_depth", child_depth, child_depth)
            set2("leaf_parent", node, node)
            if pooled:
                pool_store(b, s, new_left, new_right)
            elif not merged:
                set2("hist", new_left, new_right)
            set2("bgain", gains[0], gains[1])
            for key, field in _BEST_FIELDS[1:]:
                v = getattr(res, field)
                set2(key, v[0], v[1])

        def frontier_round(num_leaves: int):
            """One round of the frontier-batched grower (the JAX package's
            round_body, grower2.py:840-1038).  Returns the number of
            splits committed and the host copy of every leaf's best gain
            after them.

            Exactness: segments are disjoint and the partition stable, so
            splitting one leaf changes no other frontier leaf's rows,
            histogram or best split; an evaluation is the same bits
            whenever it runs, and the replay below is the sequential
            order.  The smaller children's histograms are read from the
            STAGED aux rows, which hold each child's rows in the order the
            commit will copy back, and the split search gives each child
            the same bits at any batch size (ops/split.py), so the trees
            are those of K = 1.  A candidate that does not commit leaves
            its payload rows untouched."""
            nonlocal payload, aux
            # selection: the K best leaves; a stable sort keeps the lower
            # index first on ties (lax.top_k's order), so slot 0 is the
            # argmax the sequential grower pops next
            top_gain, cand = torch.sort(st["bgain"], descending=True,
                                        stable=True)
            top_gain, cand = top_gain[:KB], cand[:KB]
            active = top_gain > 0.0

            def at(key):
                return st[key][cand]

            start_c = at("seg_start")
            cnt_c = torch.where(active, at("seg_cnt"),
                                torch.zeros_like(start_c))
            feat_c, bbin_c, bdleft_c = at("bfeat"), at("bbin"), at("bdleft")
            bcat_c, bbitset_c = at("bcat"), at("bbitset")
            blo_c, bro_c = at("blo"), at("bro")
            lval_c, depth_c, parent_c = (at("leaf_val"), at("leaf_depth"),
                                         at("leaf_parent"))
            fl_c = feat_c.long()
            pred_c = SplitPredicate(
                col=bmap.f_group[fl_c], threshold=bbin_c,
                default_left=bdleft_c, is_cat=bcat_c, bitset=bbitset_c,
                missing_type=meta.missing_type[fl_c],
                num_bin=meta.num_bin[fl_c],
                default_bin=meta.default_bin[fl_c],
                offset=bmap.f_offset[fl_c], identity=bmap.f_identity[fl_c])

            # stage every candidate's partition into aux; payload is only
            # read (inactive slots stage count 0: a no-op)
            nl_c = torch.zeros(KB, **i32)
            for j in range(KB):
                cuda_segment.partition_segment_stage(
                    payload, aux, start_c[j], cnt_c[j],
                    SplitPredicate(*[v[j] for v in pred_c]), nl_c, j)

            # ONE batched histogram of the K smaller children from the
            # staged rows; siblings by subtraction, with the sequential
            # grower's masked-count choice of the smaller child
            lg_c, lh_c, lc_c = at("blg"), at("blh"), at("blc")
            pg_c, ph_c, pc_c = at("sum_g"), at("sum_h"), at("cnt")
            rg_c, rh_c, rc_c = pg_c - lg_c, ph_c - lh_c, pc_c - lc_c
            left_smaller = lc_c <= rc_c
            h_start = torch.where(left_smaller, start_c, start_c + nl_c)
            h_count = torch.where(left_smaller, nl_c, cnt_c - nl_c)
            hist_small = hist_batched_fn(aux, h_start, h_count)
            hist_big = at("hist") - hist_small
            ls4 = left_smaller[:, None, None, None]
            new_left = torch.where(ls4, hist_small, hist_big)
            new_right = torch.where(ls4, hist_big, hist_small)

            # ONE split search over the 2K children (lefts, then rights)
            res = find_split_batched(
                torch.cat([new_left, new_right]), torch.cat([lg_c, rg_c]),
                torch.cat([lh_c, rh_c]), torch.cat([lc_c, rc_c]))
            child_depth = depth_c + 1
            gains = depth_gate(res.gain, torch.cat([child_depth,
                                                    child_depth]))

            # the round's one host read: every leaf's stored gain, the
            # window and the children's gains
            host = torch.cat([st["bgain"], cand.to(torch.float32),
                              gains]).cpu().numpy()
            bg = host[:L].copy()
            cand_h = host[L:L + KB].astype(np.int64)
            gain_l, gain_r = host[L + KB:L + 2 * KB], host[L + 2 * KB:]
            # replay the sequential argmax order: a pop outside the window
            # (a child made this round, an unevaluated or used leaf),
            # exhausted gain or the leaf budget ends the round
            active_h = bg[cand_h] > 0.0
            used = np.zeros(KB, dtype=bool)
            commits = []
            s = num_leaves
            while s < L:
                best = int(np.argmax(bg))
                if not bg[best] > 0.0:
                    break
                hit = np.flatnonzero((cand_h == best) & active_h & ~used)
                if hit.size == 0:
                    break
                j = int(hit[0])
                used[j] = True
                commits.append((j, best, s))
                bg[best], bg[s] = gain_l[j], gain_r[j]
                s += 1
            if not commits:
                return 0, bg

            # apply the commits: no leaf is written twice in a round (a
            # used candidate is never popped again, and a new leaf is not
            # in the window), so each update is one vectorized index_put_
            idx = torch.tensor(commits, dtype=torch.int64).T.contiguous()
            if dev.type == "cuda":
                idx = idx.pin_memory().to(dev, non_blocking=True)
            jj, bb, ss = idx[0], idx[1], idx[2]
            nodes = ss - 1
            K2 = jj + KB

            def set2(key, vl, vr):
                t = st[key]
                t.index_put_((bb,), vl.to(t.dtype))
                t.index_put_((ss,), vr.to(t.dtype))

            def setn(key, v):
                t = st[key]
                t.index_put_((nodes,), v.to(t.dtype))

            nl_j = nl_c[jj]
            set2("seg_start", start_c[jj], start_c[jj] + nl_j)
            set2("seg_cnt", nl_j, cnt_c[jj] - nl_j)
            set2("sum_g", lg_c[jj], rg_c[jj])
            set2("sum_h", lh_c[jj], rh_c[jj])
            set2("cnt", lc_c[jj], rc_c[jj])
            set2("bgain", gains[jj], gains[K2])
            for key, field in _BEST_FIELDS[1:]:
                v = getattr(res, field)
                set2(key, v[jj], v[K2])
            set2("leaf_val", blo_c[jj], bro_c[jj])
            set2("leaf_depth", child_depth[jj], child_depth[jj])
            set2("hist", new_left[jj], new_right[jj])

            # the internal nodes, from the round-start records
            setn("split_feature", feat_c[jj])
            setn("split_bin", bbin_c[jj])
            setn("split_gain", top_gain[jj])
            setn("default_left", bdleft_c[jj])
            setn("split_is_cat", bcat_c[jj])
            setn("split_cat_bitset", bbitset_c[jj])
            setn("internal_value", lval_c[jj])
            setn("internal_count", pc_c[jj])
            setn("left_child", ~bb)
            setn("right_child", ~ss)
            # the parent's pointer to the split leaf now names the new
            # node.  Its other child may have split this round too, but
            # that changes only the other pointer, so the round-start
            # records decide which side; writes not to make go to the
            # spare slot past the last node.
            pn = parent_c[jj].long()
            has_par = pn >= 0
            pn = pn.clamp(min=0)
            was_left = st["left_child"][pn] == (~bb).to(torch.int32)
            spare = torch.full_like(pn, ni)
            st["left_child"].index_put_(
                (torch.where(has_par & was_left, pn, spare),),
                nodes.to(torch.int32))
            st["right_child"].index_put_(
                (torch.where(has_par & ~was_left, pn, spare),),
                nodes.to(torch.int32))
            set2("leaf_parent", nodes, nodes)

            # copy back the committed candidates only; the rest never
            # touched the payload
            for j, _, _ in commits:
                payload = cuda_segment.partition_segment_commit(
                    payload, aux, start_c[j], cnt_c[j], nl_c[j], blo_c[j],
                    bro_c[j], cols.value)
            return len(commits), bg

        num_leaves = 1
        host_syncs = 0
        if frontier:
            rounds = 0
            gains_host = None
            while num_leaves < L and (gains_host is None
                                      or gains_host.max() > 0.0):
                committed, gains_host = frontier_round(num_leaves)
                host_syncs += 1
                if not committed:
                    break
                rounds += 1
                num_leaves += committed
        else:
            while num_leaves < L:
                # first maximum, like jnp.argmax; the one host read per
                # split brings the leaf (exact in f32) and its gain
                bl = torch.argmax(st["bgain"]).reshape(1)
                pick = torch.cat([bl.to(torch.float32),
                                  st["bgain"].index_select(0, bl)]).cpu()
                host_syncs += 1
                if not bool(pick[1] > 0.0):
                    break
                do_split(num_leaves, bl, int(pick[0]))
                num_leaves += 1
            rounds = num_leaves - 1

        leaf_value = st["leaf_val"]
        if num_leaves == 1:
            leaf_value = leaf_value.clone()
            leaf_value[0] = out_fn(st["sum_g"], st["sum_h"])[0]
        tree = {
            "num_leaves": num_leaves,
            "split_rounds": rounds,
            "host_syncs": host_syncs,
            "leaf_value": leaf_value,
            "leaf_count": st["cnt"],
            "leaf_sum_g": st["sum_g"],
            "leaf_sum_h": st["sum_h"],
            "seg_start": st["seg_start"],
            "seg_cnt": st["seg_cnt"],
        }
        for key in _NODE_FIELDS:
            tree[key] = st[key][:ni]
        return tree, payload, aux

    # the engines this grower chose, by wrapper name (the JAX grower's
    # hist_engine); each call sets both, from the payload's device and width
    grow.hist_engine = hist_wrapper.__name__
    grow.part_engine = None
    return grow
