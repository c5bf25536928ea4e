"""Partitioned leaf-wise tree grower (counterpart of lightgbm_tpu/boosting/grower2.py).

Rows of every leaf are kept physically contiguous in a payload matrix
(DataPartition, src/treelearner/data_partition.hpp): each split stably
partitions only the split leaf's rows, only the smaller child's histogram
is built from rows, and the sibling comes from subtraction
(serial_tree_learner.cpp:447-544).  Histogram and partition go through
ops/cuda_segment.py: hand-written kernels for CUDA tensors, the plain
PyTorch versions for CPU tensors.

This slice ports the serial, unforced, f32, unpooled, non-frontier,
non-monotone path.  The JAX grower is one on-device `lax.while_loop`;
this one is an eager Python loop that asks the device once per split
whether a positive-gain split remains (one host sync, counted in the
tree's `host_syncs`).  Everything else — segment bounds, num_left, the
split records — stays on the device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import cuda_segment
from ..ops.bundle import identity_bundle_map
from ..ops.segment import GUARD, SplitPredicate, payload_col_write
from ..ops.split import (FeatureMeta, K_MIN_SCORE, find_best_split_batched,
                         leaf_output)


class GrowerConfig(NamedTuple):
    """Static scalars of one grower (the JAX package's GrowerConfig,
    without the knobs of paths this slice does not port)."""
    num_leaves: int
    max_depth: int
    lambda_l1: float
    lambda_l2: float
    max_delta_step: float
    min_data_in_leaf: int
    min_sum_hessian_in_leaf: float
    min_gain_to_split: float


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


def make_partitioned_grower(meta: FeatureMeta, cfg: GrowerConfig,
                            num_bins_max: int, cols: PayloadCols,
                            num_features: int):
    """Returns grow(payload, aux, feature_mask) -> (tree dict, payload, aux).

    payload/aux: [N_pad + GUARD, P] f32 with a GUARD-row tail whose
    count-mask is 0.  Valid rows are [0, N_pad); the root segment covers
    all of them whatever order previous trees left them in.  payload and
    aux are updated in place.  Numerical splits only (the categorical
    search and monotone constraints are not ported; gbdt refuses them).
    Storage columns are the features themselves (no EFB bundles)."""
    L = cfg.num_leaves
    B = num_bins_max
    F = num_features
    find_kwargs = dict(
        l1=cfg.lambda_l1, l2=cfg.lambda_l2, max_delta_step=cfg.max_delta_step,
        min_data_in_leaf=cfg.min_data_in_leaf,
        min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
        min_gain_to_split=cfg.min_gain_to_split)
    hist_kwargs = dict(num_features=F, num_bins=B, grad_col=cols.grad,
                       hess_col=cols.hess, cnt_col=cols.cnt)

    def out_fn(sum_g, sum_h):
        return leaf_output(sum_g, sum_h, cfg.lambda_l1, cfg.lambda_l2,
                           cfg.max_delta_step)

    def hist_fn(payload, start, count):
        return cuda_segment.segment_histogram(payload, start, count,
                                              **hist_kwargs)

    def find_split_batched(hists, sgs, shs, cnts, feature_mask):
        """The one search routine: root (Q = 1) and children (Q = 2)."""
        return find_best_split_batched(hists, sgs, shs, cnts, feature_mask,
                                       meta=meta, **find_kwargs)

    def grow(payload: torch.Tensor, aux: torch.Tensor,
             feature_mask: torch.Tensor):
        dev = payload.device
        bmap = identity_bundle_map(F, dev)
        n_rows = payload.shape[0] - GUARD
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)

        # a filled device scalar, not torch.tensor: a host-to-device copy
        # would wait for the stream
        hist_root = hist_fn(payload, torch.zeros((), **i32),
                            torch.full((), n_rows, **i32))
        # every row lands in exactly one bin of storage column 0, so the
        # root totals fall out of the histogram
        totals = torch.sum(hist_root[0], dim=0)
        root_g, root_h, root_c = totals[0], totals[1], totals[2]
        res0 = find_split_batched(hist_root[None], totals[0:1], totals[1:2],
                                  totals[2:3], feature_mask)
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
            "left_child": torch.zeros(ni, **i32),
            "right_child": torch.zeros(ni, **i32),
            "internal_value": torch.zeros(ni, **f32),
            "internal_count": torch.zeros(ni, **f32),
            "hist": torch.zeros((L, F, B, 3), **f32),
        }
        st["seg_cnt"][0] = n_rows
        st["sum_g"][0] = root_g
        st["sum_h"][0] = root_h
        st["cnt"][0] = root_c
        for key, field in (("bgain", "gain"), ("bfeat", "feature"),
                           ("bbin", "threshold_bin"),
                           ("bdleft", "default_left"), ("blg", "left_sum_g"),
                           ("blh", "left_sum_h"), ("blc", "left_count"),
                           ("bcat", "is_cat"), ("bbitset", "cat_bitset"),
                           ("blo", "left_output"), ("bro", "right_output")):
            st[key][0] = getattr(res0, field)[0]
        st["hist"][0] = hist_root

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

        def do_split(s: int, bl: torch.Tensor) -> None:
            """Partition leaf `bl` (a [1] device index) into leaves bl and
            s, and evaluate both children."""
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
            hist_parent = leaf("hist")

            payload, aux, nl_raw = cuda_segment.partition_segment(
                payload, aux, start, count, pred, lo, ro, cols.value)
            nr_raw = count - nl_raw

            # build only the smaller child (by masked counts, as the JAX
            # grower does) and derive the sibling by subtraction
            left_smaller = lcnt <= rcnt
            h_start = torch.where(left_smaller, start, start + nl_raw)
            h_count = torch.where(left_smaller, nl_raw, nr_raw)
            hist_small = hist_fn(payload, h_start, h_count)
            hist_big = hist_parent - hist_small
            new_left = torch.where(left_smaller, hist_small, hist_big)
            new_right = torch.where(left_smaller, hist_big, hist_small)

            res = find_split_batched(
                torch.stack([new_left, new_right]), torch.stack([lg, rg]),
                torch.stack([lh, rh]), torch.stack([lcnt, rcnt]),
                feature_mask)
            child_depth = leaf("leaf_depth") + 1
            gains = res.gain
            if cfg.max_depth > 0:
                gains = torch.where(child_depth < cfg.max_depth, gains,
                                    torch.full_like(gains, K_MIN_SCORE))

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
            set2("hist", new_left, new_right)
            set2("bgain", gains[0], gains[1])
            for key, field in (("bfeat", "feature"), ("bbin", "threshold_bin"),
                               ("bdleft", "default_left"),
                               ("blg", "left_sum_g"), ("blh", "left_sum_h"),
                               ("blc", "left_count"), ("bcat", "is_cat"),
                               ("bbitset", "cat_bitset"),
                               ("blo", "left_output"),
                               ("bro", "right_output")):
                v = getattr(res, field)
                set2(key, v[0], v[1])

        num_leaves = 1
        host_syncs = 0
        while num_leaves < L:
            # first maximum, like jnp.argmax; the one host read per split
            bl = torch.argmax(st["bgain"]).reshape(1)
            host_syncs += 1
            if not bool(take(st["bgain"], bl) > 0.0):
                break
            do_split(num_leaves, bl)
            num_leaves += 1

        leaf_value = st["leaf_val"]
        if num_leaves == 1:
            leaf_value = leaf_value.clone()
            leaf_value[0] = out_fn(st["sum_g"], st["sum_h"])[0]
        tree = {
            "num_leaves": num_leaves,
            "split_rounds": num_leaves - 1,
            "host_syncs": host_syncs,
            "leaf_value": leaf_value,
            "leaf_count": st["cnt"],
            "leaf_sum_g": st["sum_g"],
            "leaf_sum_h": st["sum_h"],
            "seg_start": st["seg_start"],
            "seg_cnt": st["seg_cnt"],
        }
        for key in ("split_feature", "split_bin", "split_gain",
                    "default_left", "split_is_cat", "split_cat_bitset",
                    "left_child", "right_child", "internal_value",
                    "internal_count"):
            tree[key] = st[key]
        return tree, payload, aux

    return grow
