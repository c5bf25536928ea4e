"""Wrappers of the hand-written Hopper kernels for the segment engine.

csrc/segment_hist.cu:
- `segment_histogram` replaces the TPU kernel
  lightgbm_tpu/ops/pallas_segment.py segment_histogram (_hist_kernel, B1);
- `segment_histogram_quant` replaces segment_histogram_quant
  (_hist_quant_kernel, B4): the int32 histogram of the quantized mode;
- `segment_histogram_batched` replaces segment_histogram_batched
  (_hist_batched_kernel, B5), in f32 and, for the quantized frontier
  grower, in int32.
csrc/segment_partition.cu:
- `partition_segment` replaces partition_segment_acc (_acc_kernel, B2);
- `partition_segment_stage` and `partition_segment_commit` are a stage and
  a commit of the same partition, which the frontier-batched grower runs
  apart (plain JAX in the JAX package, ops/segment.py; hand-written
  kernels here).
csrc/segment_hist_colblock.cu:
- `segment_histogram_colblock` replaces segment_histogram_colblock
  (_hist_colblock_kernel, B7): B1's contract for wide payloads.
csrc/segment_partition_wide.cu:
- `partition_segment_rmw` replaces partition_segment (_partition_kernel,
  B3) and `partition_segment_blocks` replaces partition_segment_acc_blocks
  (_snap_window_kernel + _acc_blocks_kernel, B8): B2's contract for wide
  payloads.
csrc/segment_partition_hist.cu:
- `partition_segment_hist` replaces partition_segment_hist
  (_acc_kernel(hist_cfg=...), B6): B2's partition plus both children's
  f32 histograms, for the grower's merged mode; `partition_hist_fits` is
  its gate and PARTITION_HIST_VALIDATED the staged flag of its auto rule.
All keep the signatures and returns of ops/segment.py.  The whole
partitions on the card (B2's `partition_segment`, B3's
`partition_segment_rmw`, B8's `partition_segment_blocks`, and B6's
partition) keep the Pallas kernels' contract, which is looser than the
plain version's: payload and num_left are the plain version's byte for
byte, aux over the segment is scratch (each passes only its smaller side
through it), and none writes outside the segment.  The stage leaves the
whole partition in aux, as the frontier grower needs.

The histograms of B1, B4, B5 and B6 split their work on the device from
the segment's count (csrc/segment_hist.cuh): the host sizes a fixed grid
from the card alone (`hist_grid`), and each block takes a feature group
and row chunks by `hist_work_split`: its Python form here is the one the
CPU tests hold to cover every (row, feature) once, and chip_smoke.py
holds it to the kernel's own (the library's `segment_hist_split`).  Their
count mask holds small integers (0 or 1 in the grower): each is summed
exactly as an int32, where the plain version sums floats.

The route (`histogram_route`, `partition_route`) picks the wrapper by
width, with the crossovers the JAX package's VMEM gates give at max_bin
255 on its lane-padded width, restated on the port's unpadded width
(P = F + 10).  The card's own crossovers are not these; one set of
constants serves every bin count.

For a tensor on the CPU a wrapper runs the plain PyTorch version in
ops/segment.py; for a CUDA tensor it launches its kernel on the current
stream or raises — there is no fallback.  Each wrapper counts its kernel
launches in a plain integer attribute, `<wrapper>.launches`.  start,
count and the predicate scalars may be 0-d device tensors: they are
packed on the device, so a launch never waits for the host.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build
from . import segment as seg
from .segment import SplitPredicate

_P = ctypes.c_void_p
_I = ctypes.c_int

#: shared memory one histogram block may use: two blocks fit on an SM
HIST_SMEM_BYTES = 110 * 1024
#: rows per work item of the histograms (kHistChunkRows of
#: csrc/segment_hist.cuh)
HIST_CHUNK_ROWS = 128
#: features per group at most (kHistGroupCols): with the three value
#: columns, a row fits one warp-wide load
HIST_GROUP_COLS = 29

#: features from which the column-block histogram (B7) replaces B1
COLBLOCK_MIN_FEATURES = 889
#: payload widths from which the RMW partition (B3) replaces B2
PARTITION_RMW_MIN_WIDTH = 513
#: payload widths from which the column-block partition (B8) replaces B3
PARTITION_BLOCKS_MIN_WIDTH = 1665

#: True once the merged partition + histogram kernel (B6) is to serve the
#: grower's merged mode wherever the auto rule admits it (the JAX
#: package's pallas_segment.PARTITION_HIST_VALIDATED, with its name and
#: default).  Off: the default path keeps B1 + B2 and the subtraction.  A
#: caller that has held B6 against its plain version on the card may set
#: it in-process, as chip_smoke.py does.
PARTITION_HIST_VALIDATED = False


def _lib(name: str, fn: str, argtypes):
    lib = build.load(name)
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        err = getattr(lib, name + "_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib, f


def _check(lib, name: str, rc: int) -> None:
    if rc != 0:
        msg = getattr(lib, name + "_error_string")(rc).decode()
        raise RuntimeError("%s kernel launch failed: %s (%d)" % (name, msg, rc))


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index) \
        .multi_processor_count


def _int_vec(values, device) -> torch.Tensor:
    """int32 [len(values)] on `device` from 0-d tensors and Python scalars,
    without a host round trip for device tensors.  Each value is cast
    first: a stack of mixed dtypes copies its inputs one launch each, a
    stack of one dtype takes one launch for all."""
    return torch.stack([torch.as_tensor(v, device=device).reshape(())
                        .to(torch.int32) for v in values])


def _check_payload(payload: torch.Tensor, name: str) -> None:
    if not payload.is_cuda:
        raise ValueError("%s: payload must be a CPU or CUDA tensor, got %s"
                         % (name, payload.device))
    if payload.dtype != torch.float32 or payload.dim() != 2 \
            or not payload.is_contiguous():
        raise ValueError("%s: payload must be a contiguous 2-D float32 "
                         "tensor" % name)
    if payload.shape[0] * payload.shape[1] >= 2 ** 31:
        raise ValueError("%s: payload of %d elements is past the kernel's "
                         "int32 element indexing" % (name, payload.numel()))


def _check_aux(payload: torch.Tensor, aux: torch.Tensor, name: str) -> None:
    if aux.shape != payload.shape or aux.dtype != payload.dtype \
            or aux.device != payload.device or not aux.is_contiguous():
        raise ValueError("%s: aux must match the payload" % name)


def hist_group_cap(num_bins: int) -> int:
    """Features per histogram group at most at `num_bins` bins: as many as
    HIST_SMEM_BYTES holds at 12 bytes a cell (B + 1 cells a feature), at
    most HIST_GROUP_COLS; 0 when not one fits."""
    return min(HIST_GROUP_COLS, HIST_SMEM_BYTES // ((num_bins + 1) * 12))


def hist_grid(sms: int, num_features: int, cap: int) -> int:
    """Histogram blocks per segment: two per SM, and at least one per
    feature group the shared memory forces."""
    return max(2 * sms, -(-num_features // cap))


class HistSplit(NamedTuple):
    """How the histogram kernels split two segments' rows (segment 0's
    chunks first) and F features over a grid (hist_split of
    csrc/segment_hist.cuh)."""
    groups: int      # feature groups
    group_cols: int  # features per group; the last may have fewer
    chunks0: int     # row chunks of segment 0
    chunks: int      # row chunks of both segments


def hist_work_split(count0: int, count1: int, grid: int, num_features: int,
                    cap: int) -> HistSplit:
    """The split of segments of count0 and count1 rows (B1's one segment
    has count1 = 0; B6's children are the left then the right) over
    `grid` blocks: chunks of HIST_CHUNK_ROWS rows; as many feature groups
    (of at most `cap` features) as fill the grid when there are fewer
    chunks than blocks, else as few as `cap` allows."""
    F = num_features
    chunks0 = -(-count0 // HIST_CHUNK_ROWS)
    chunks = chunks0 + -(-count1 // HIST_CHUNK_ROWS)
    g = grid // chunks if chunks > 0 else grid
    g = max(min(g, F), -(-F // cap))
    group_cols = -(-F // g)
    return HistSplit(-(-F // group_cols), group_cols, chunks0, chunks)


def hist_block_work(split: HistSplit, block: int, grid: int,
                    num_features: int) -> tuple:
    """Block `block`'s work under `split`: (first feature, features,
    [chunks in the order it takes them]); no chunks for a block past the
    work."""
    group = block % split.groups
    nbg = (grid - group + split.groups - 1) // split.groups
    f0 = group * split.group_cols
    fn = min(split.group_cols, num_features - f0)
    return f0, fn, list(range(block // split.groups, split.chunks, nbg))


def _hist_launch(name: str, payload: torch.Tensor, segv: torch.Tensor,
                 quantized: bool, *, num_features: int, num_bins: int,
                 grad_col: int, hess_col: int,
                 cnt_col: int) -> torch.Tensor:
    """Launch csrc/segment_hist.cu over K segments (segv: int32 [K, 2]
    start/count on the device); returns the filled [K, F, B, 3] output,
    int32 when quantized, else f32."""
    _check_payload(payload, name)
    F, B, P = num_features, num_bins, payload.shape[1]
    K = segv.shape[0]
    cap = hist_group_cap(B) if B > 0 else 0
    if not 0 < F <= P or cap == 0:
        raise ValueError("%s: F=%d, B=%d outside the kernel's range"
                         % (name, F, B))
    if not 0 < K < 65536:
        raise ValueError("%s: %d segments outside [1, 65535]" % (name, K))
    for c in (grad_col, hess_col, cnt_col):
        if not 0 <= c < P:
            raise ValueError("%s: value column %d outside [0, %d)"
                             % (name, c, P))
    dev = payload.device
    out = torch.zeros((K, F, B, 3), device=dev,
                      dtype=torch.int32 if quantized else torch.float32)
    lib, fn = _lib("segment_hist", "segment_hist_launch",
                   [_P, _I, _P, _P] + [_I] * 9 + [_P])
    rc = fn(payload.data_ptr(), P, segv.data_ptr(), out.data_ptr(), K, F, B,
            cap, grad_col, hess_col, cnt_col,
            hist_grid(_sm_count(dev.index), F, cap), int(quantized),
            _stream(dev))
    _check(lib, "segment_hist", rc)
    return out


def segment_histogram(payload: torch.Tensor, start, count, *,
                      num_features: int, num_bins: int, grad_col: int,
                      hess_col: int, cnt_col: int) -> torch.Tensor:
    """f32 hist[F, B, 3] over payload rows [start, start+count) (B1).
    The count mask column must hold small integers (0 or 1): the kernel
    rounds each to int32 before its exact sum."""
    kwargs = dict(num_features=num_features, num_bins=num_bins,
                  grad_col=grad_col, hess_col=hess_col, cnt_col=cnt_col)
    if payload.device.type == "cpu":
        return seg.segment_histogram(payload, start, count, **kwargs)
    segv = _int_vec((start, count), payload.device).reshape(1, 2)
    out = _hist_launch("segment_histogram", payload, segv, False, **kwargs)
    segment_histogram.launches += 1
    return out[0]


segment_histogram.launches = 0


def segment_histogram_quant(payload: torch.Tensor, start, count, *,
                            num_features: int, num_bins: int, grad_col: int,
                            hess_col: int, cnt_col: int) -> torch.Tensor:
    """int32 hist[F, B, 3] over payload rows [start, start+count) whose
    grad/hess columns hold integer-valued quantized gradients (B4); the
    plain version is segment_histogram(..., quantized=True)."""
    kwargs = dict(num_features=num_features, num_bins=num_bins,
                  grad_col=grad_col, hess_col=hess_col, cnt_col=cnt_col)
    if payload.device.type == "cpu":
        return seg.segment_histogram(payload, start, count, quantized=True,
                                     **kwargs)
    segv = _int_vec((start, count), payload.device).reshape(1, 2)
    out = _hist_launch("segment_histogram_quant", payload, segv, True,
                       **kwargs)
    segment_histogram_quant.launches += 1
    return out[0]


segment_histogram_quant.launches = 0


def segment_histogram_batched(payload: torch.Tensor, starts, counts, *,
                              num_features: int, num_bins: int,
                              grad_col: int, hess_col: int, cnt_col: int,
                              quantized: bool = False) -> torch.Tensor:
    """hist[K, F, B, 3] over K disjoint segments (B5): starts / counts are
    [K] integer tensors; slice k equals the single-segment histogram of
    segment k, a zero count gives zeros.  int32 when quantized."""
    kwargs = dict(num_features=num_features, num_bins=num_bins,
                  grad_col=grad_col, hess_col=hess_col, cnt_col=cnt_col)
    if payload.device.type == "cpu":
        return seg.segment_histogram_batched(payload, starts, counts,
                                             quantized=quantized, **kwargs)
    _check_payload(payload, "segment_histogram_batched")
    dev = payload.device
    starts = torch.as_tensor(starts, device=dev).reshape(-1)
    counts = torch.as_tensor(counts, device=dev).reshape(-1)
    if starts.shape != counts.shape:
        raise ValueError("segment_histogram_batched: starts and counts "
                         "differ in shape")
    if starts.shape[0] == 0:
        return torch.zeros((0, num_features, num_bins, 3), device=dev,
                           dtype=torch.int32 if quantized else torch.float32)
    segv = torch.stack([starts.to(torch.int32), counts.to(torch.int32)],
                       dim=1)
    out = _hist_launch("segment_histogram_batched", payload, segv,
                       quantized, **kwargs)
    segment_histogram_batched.launches += 1
    return out


segment_histogram_batched.launches = 0


def _pred_args(start, count, pred: SplitPredicate, dev):
    """The kernels' predicate: int32[11] scalars (start, count, col,
    threshold, default_left, is_cat, missing_type, num_bin, default_bin,
    offset, identity) and the bitset's bytes, both on `dev`."""
    scalars = _int_vec((start, count, pred.col, pred.threshold,
                        pred.default_left, pred.is_cat, pred.missing_type,
                        pred.num_bin, pred.default_bin, pred.offset,
                        pred.identity), dev)
    # a bool bitset is passed as its bytes, with no conversion launch
    bitset = torch.as_tensor(pred.bitset, device=dev).to(torch.bool) \
        .contiguous().view(torch.uint8)
    return scalars, bitset


def _leaf_values(left_value, right_value, dev) -> torch.Tensor:
    return torch.stack([torch.as_tensor(v, device=dev).reshape(())
                        .to(torch.float32)
                        for v in (left_value, right_value)])


def _stage(payload, aux, start, count, pred: SplitPredicate, num_left,
           slot: int) -> None:
    """Launch the stage kernels, writing num_left into num_left[slot]."""
    dev = payload.device
    N, P = payload.shape
    scalars, bitset = _pred_args(start, count, pred, dev)
    lib, fn = _lib("segment_partition", "segment_partition_stage_launch",
                   [_P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P])
    n_tiles = -(-N // lib.segment_partition_tile_rows())
    tile_left = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    tile_off = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    rc = fn(payload.data_ptr(), aux.data_ptr(), P, scalars.data_ptr(),
            bitset.data_ptr(), bitset.shape[0], n_tiles, tile_left.data_ptr(),
            tile_off.data_ptr(), num_left.data_ptr() + 4 * slot, _stream(dev))
    _check(lib, "segment_partition", rc)


def _commit(payload, aux, start, count, num_left, left_value, right_value,
            value_col: int) -> None:
    """Launch the commit kernel; num_left is a 0-d int32 device tensor."""
    dev = payload.device
    P = payload.shape[1]
    if not 0 <= value_col < P:
        raise ValueError("partition commit: value_col %d outside [0, %d)"
                         % (value_col, P))
    segv = _int_vec((start, count), dev)
    fvals = _leaf_values(left_value, right_value, dev)
    lib, fn = _lib("segment_partition", "segment_partition_commit_launch",
                   [_P, _P, _I, _P, _P, _P, _I, _I, _P])
    copy_blocks = 8 * _sm_count(dev.index)
    rc = fn(payload.data_ptr(), aux.data_ptr(), P, segv.data_ptr(),
            num_left.data_ptr(), fvals.data_ptr(), value_col, copy_blocks,
            _stream(dev))
    _check(lib, "segment_partition", rc)


@functools.lru_cache(maxsize=None)
def _tile_rows(lib_name: str, entry: str, payload_width: int) -> int:
    f = getattr(build.load(lib_name), entry)
    f.argtypes = [_I]
    return f(payload_width)


def _whole_row_partition(payload, aux, start, count, pred: SplitPredicate,
                         left_value, right_value, value_col: int,
                         lib_name: str, entry: str, rows_entry: str,
                         name: str):
    """Launch a whole partition of whole-row tiles (B2 from
    csrc/segment_partition.cu, B3 from csrc/segment_partition_wide.cu):
    the count, the scan, the move that writes the larger side in place,
    and the smaller side's copy-back.  Returns num_left, a 0-d int32
    device tensor."""
    _check_payload(payload, name)
    _check_aux(payload, aux, name)
    dev = payload.device
    N, P = payload.shape
    T = _tile_rows(lib_name, rows_entry, P)
    if T == 0 or not 0 <= value_col < P:
        raise ValueError("%s: width %d or value_col %d outside the kernel's "
                         "range" % (name, P, value_col))
    scalars, bitset = _pred_args(start, count, pred, dev)
    fvals = _leaf_values(left_value, right_value, dev)
    lib, fn = _lib(lib_name, entry,
                   [_P, _P, _I, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _I,
                    _P])
    n_tiles = -(-N // T)
    # each tile's left count and offset, num_left, then the move's ticket
    # and the tiles' flags
    scratch = torch.empty(3 * n_tiles + 2, dtype=torch.int32, device=dev)
    tile_left, tile_off, num_left, sync = scratch.split(
        (n_tiles, n_tiles, 1, n_tiles + 1))
    rc = fn(payload.data_ptr(), aux.data_ptr(), P, scalars.data_ptr(),
            bitset.data_ptr(), bitset.shape[0], fvals.data_ptr(), value_col,
            n_tiles, tile_left.data_ptr(), tile_off.data_ptr(),
            num_left.data_ptr(), sync.data_ptr(), _sm_count(dev.index),
            _stream(dev))
    _check(lib, lib_name, rc)
    return num_left.reshape(())


def partition_segment(payload: torch.Tensor, aux: torch.Tensor, start, count,
                      pred: SplitPredicate, left_value, right_value,
                      value_col: int):
    """Stable in-place partition of rows [start, start+count); returns
    (payload, aux, num_left) with num_left a 0-d int32 tensor (B2).  On the
    card payload and num_left are the plain version's byte for byte, aux
    over the segment is scratch (the smaller side passes through it), and
    nothing outside the segment is written: the count, the scan, the move
    that writes the larger side in place, and the smaller side's
    copy-back (csrc/segment_partition.cu)."""
    if payload.device.type == "cpu":
        return seg.partition_segment(payload, aux, start, count, pred,
                                     left_value, right_value, value_col)
    num_left = _whole_row_partition(
        payload, aux, start, count, pred, left_value, right_value, value_col,
        "segment_partition", "segment_partition_launch",
        "segment_partition_move_tile_rows", "partition_segment")
    partition_segment.launches += 1
    return payload, aux, num_left


partition_segment.launches = 0


def partition_segment_stage(payload: torch.Tensor, aux: torch.Tensor, start,
                            count, pred: SplitPredicate, num_left=None,
                            slot: int = 0):
    """The rows of [start, start+count), left rows first, into aux over the
    same range; payload is only read.  Returns (aux, num_left) with
    num_left a 0-d int32 tensor: slot `slot` of the caller's int32 vector
    `num_left` when one is given (the frontier grower stages K candidates
    into one [K] vector), else a new one."""
    if payload.device.type == "cpu":
        aux, nl = seg.partition_segment_stage(payload, aux, start, count,
                                              pred)
        if num_left is None:
            return aux, nl
        num_left[slot] = nl
        return aux, num_left[slot]
    _check_payload(payload, "partition_segment_stage")
    _check_aux(payload, aux, "partition_segment_stage")
    if num_left is None:
        num_left, slot = torch.empty(1, dtype=torch.int32,
                                     device=payload.device), 0
    elif num_left.dtype != torch.int32 or num_left.dim() != 1 \
            or not num_left.is_contiguous() \
            or num_left.device != payload.device \
            or not 0 <= slot < num_left.shape[0]:
        raise ValueError("partition_segment_stage: num_left must be a "
                         "contiguous int32 vector on the payload's device "
                         "holding slot %d" % slot)
    _stage(payload, aux, start, count, pred, num_left, slot)
    partition_segment_stage.launches += 1
    return aux, num_left[slot]


partition_segment_stage.launches = 0


def partition_segment_commit(payload: torch.Tensor, aux: torch.Tensor, start,
                             count, num_left, left_value, right_value,
                             value_col: int) -> torch.Tensor:
    """Copy the staged rows aux[start, start+count) back into payload with
    the children's values in `value_col`; count 0 is a no-op.  start,
    count and num_left are read from device memory.  Returns payload."""
    if payload.device.type == "cpu":
        return seg.partition_segment_commit(payload, aux, start, count,
                                            num_left, left_value,
                                            right_value, value_col)
    _check_payload(payload, "partition_segment_commit")
    _check_aux(payload, aux, "partition_segment_commit")
    num_left = torch.as_tensor(num_left, device=payload.device) \
        .reshape(()).to(torch.int32)
    _commit(payload, aux, start, count, num_left, left_value, right_value,
            value_col)
    partition_segment_commit.launches += 1
    return payload


partition_segment_commit.launches = 0


@functools.lru_cache(maxsize=None)
def _colblock_features(num_features: int, num_bins: int) -> int:
    """Columns per block of B7 (as many as its shared memory holds at this
    bin count), at most F; 0 when not one fits."""
    f = build.load("segment_hist_colblock").segment_hist_colblock_cols
    f.argtypes = [_I, _I]
    return f(num_features, num_bins)


def segment_histogram_colblock(payload: torch.Tensor, start, count, *,
                               num_features: int, num_bins: int,
                               grad_col: int, hess_col: int,
                               cnt_col: int) -> torch.Tensor:
    """f32 hist[F, B, 3] over payload rows [start, start+count) of a wide
    payload (B7: replaces lightgbm_tpu/ops/pallas_segment.py
    segment_histogram_colblock).  Its contract is B1's, so a CPU tensor
    runs the same plain version, `seg.segment_histogram`."""
    kwargs = dict(num_features=num_features, num_bins=num_bins,
                  grad_col=grad_col, hess_col=hess_col, cnt_col=cnt_col)
    if payload.device.type == "cpu":
        return seg.segment_histogram(payload, start, count, **kwargs)
    _check_payload(payload, "segment_histogram_colblock")
    F, B, P = num_features, num_bins, payload.shape[1]
    lib, fn = _lib("segment_hist_colblock", "segment_hist_colblock_launch",
                   [_P, _I, _P, _P] + [_I] * 6 + [_P])
    fb = _colblock_features(F, B) if 0 < B < 0xFFFF else 0
    if not 0 < F <= P or fb == 0:
        raise ValueError("segment_histogram_colblock: F=%d, B=%d outside "
                         "the kernel's range" % (F, B))
    for c in (grad_col, hess_col, cnt_col):
        if not 0 <= c < P:
            raise ValueError("segment_histogram_colblock: value column %d "
                             "outside [0, %d)" % (c, P))
    dev = payload.device
    segv = _int_vec((start, count), dev)
    out = torch.zeros((F, B, 3), device=dev, dtype=torch.float32)
    rc = fn(payload.data_ptr(), P, segv.data_ptr(), out.data_ptr(), F, B,
            _sm_count(dev.index), grad_col, hess_col, cnt_col, _stream(dev))
    _check(lib, "segment_hist_colblock", rc)
    segment_histogram_colblock.launches += 1
    return out


segment_histogram_colblock.launches = 0


@functools.lru_cache(maxsize=None)
def _blocks_tiles() -> tuple:
    """B8's rows per routing tile, rows per move tile and floats per column
    block."""
    lib = build.load("segment_partition_wide")
    return (lib.segment_partition_wide_tile_rows(),
            lib.segment_partition_blocks_row_tile(),
            lib.segment_partition_blocks_col_block())


def _partition_blocks(payload, aux, start, count, pred: SplitPredicate,
                      left_value, right_value, value_col: int):
    """Launch B8 (csrc/segment_partition_wide.cu): the routing, the in-place
    column-block move and the smaller side's copy-back.  Returns num_left,
    a 0-d int32 device tensor."""
    name = "partition_segment_blocks"
    _check_payload(payload, name)
    _check_aux(payload, aux, name)
    dev = payload.device
    N, P = payload.shape
    if not 0 <= value_col < P:
        raise ValueError("%s: value_col %d outside [0, %d)"
                         % (name, value_col, P))
    scalars, bitset = _pred_args(start, count, pred, dev)
    fvals = _leaf_values(left_value, right_value, dev)
    tile, row_tile, col_block = _blocks_tiles()
    n_tiles = -(-N // tile)
    side = torch.empty(N, dtype=torch.uint8, device=dev)
    # each row's destination, each tile's left count and offset, num_left,
    # and the move's ticket and flags (one per row tile and column block)
    n_sync = 1 + -(-N // row_tile) * -(-P // col_block)
    scratch = torch.empty(N + 2 * n_tiles + 1 + n_sync, dtype=torch.int32,
                          device=dev)
    dest, tile_left, tile_off, num_left, sync = scratch.split(
        (N, n_tiles, n_tiles, 1, n_sync))
    lib, fn = _lib("segment_partition_wide", "segment_partition_blocks_launch",
                   [_P, _P, _I, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _P,
                    _P, _I, _P])
    rc = fn(payload.data_ptr(), aux.data_ptr(), P, scalars.data_ptr(),
            bitset.data_ptr(), bitset.shape[0], fvals.data_ptr(), value_col,
            n_tiles, side.data_ptr(), dest.data_ptr(), tile_left.data_ptr(),
            tile_off.data_ptr(), num_left.data_ptr(), sync.data_ptr(),
            _sm_count(dev.index), _stream(dev))
    _check(lib, "segment_partition_wide", rc)
    return num_left.reshape(())


def partition_segment_rmw(payload: torch.Tensor, aux: torch.Tensor, start,
                          count, pred: SplitPredicate, left_value,
                          right_value, value_col: int):
    """Stable in-place partition of rows [start, start+count) of a wide
    payload; returns (payload, aux, num_left) (B3: replaces
    lightgbm_tpu/ops/pallas_segment.py partition_segment, the RMW kernel).
    Its contract is B2's, so a CPU tensor runs the same plain version,
    `seg.partition_segment`; on the card, as B2's, aux over the segment is
    scratch.  B2's whole-row tiles, sized for rows of 2-6.5 KB
    (csrc/segment_partition_wide.cu)."""
    if payload.device.type == "cpu":
        return seg.partition_segment(payload, aux, start, count, pred,
                                     left_value, right_value, value_col)
    num_left = _whole_row_partition(
        payload, aux, start, count, pred, left_value, right_value, value_col,
        "segment_partition_wide", "segment_partition_rmw_launch",
        "segment_partition_rmw_tile_rows", "partition_segment_rmw")
    partition_segment_rmw.launches += 1
    return payload, aux, num_left


partition_segment_rmw.launches = 0


def partition_segment_blocks(payload: torch.Tensor, aux: torch.Tensor, start,
                             count, pred: SplitPredicate, left_value,
                             right_value, value_col: int):
    """Stable in-place partition of rows [start, start+count) of the widest
    payloads, moved in column blocks; returns (payload, aux, num_left) (B8:
    replaces lightgbm_tpu/ops/pallas_segment.py
    partition_segment_acc_blocks).  Its contract is B2's, so a CPU tensor
    runs the same plain version, `seg.partition_segment`; on the card, as
    B2's, aux over the segment is scratch."""
    if payload.device.type == "cpu":
        return seg.partition_segment(payload, aux, start, count, pred,
                                     left_value, right_value, value_col)
    num_left = _partition_blocks(payload, aux, start, count, pred,
                                 left_value, right_value, value_col)
    partition_segment_blocks.launches += 1
    return payload, aux, num_left


partition_segment_blocks.launches = 0


def partition_hist_fits(payload_width: int, num_features: int,
                        num_bins: int) -> bool:
    """The merged kernel's gate: the JAX package's
    pallas_segment.partition_hist_fits_vmem (its VMEM plan at ring depth
    2, 256-row chunks, a 13 MiB budget) on the lane-padded width of this
    payload, so the auto rule takes the merged mode where the JAX grower
    would.  At 255 or 256 bins it admits up to 136 features, at 128 or
    fewer up to 246.  B6 itself groups features and takes any F."""
    if num_bins > 256:
        return False
    chunk = 256
    ft = max(1, min(num_features, 2048 // num_bins))
    n_tiles = -(-num_features // ft)
    w = -(-ft * num_bins // 128) * 128
    p = -(-payload_width // 128) * 128
    est_acc = 4 * p * 18 * chunk + 4 * 8 * chunk * chunk + 4 * chunk * num_bins
    est_hist = (2 * 4 * chunk * w + 2 * 4 * 8 * n_tiles * w + 4 * ft * w)
    return est_acc + est_hist <= 13 * 2 ** 20


def partition_segment_hist(payload: torch.Tensor, aux: torch.Tensor, start,
                           count, pred: SplitPredicate, left_value,
                           right_value, value_col: int, num_bins: int, *,
                           num_features: int, grad_col: int, hess_col: int,
                           cnt_col: int):
    """Stable in-place partition of rows [start, start+count) and both
    children's f32 histograms [F, B, 3]; returns (payload, aux, num_left,
    hist_left, hist_right) with num_left a 0-d int32 device tensor (B6:
    replaces lightgbm_tpu/ops/pallas_segment.py partition_segment_hist).
    On the card the partition is B2's in-place one: payload and num_left
    byte for byte, aux over the segment scratch; then both histograms,
    split over the card as B1's (csrc/segment_partition_hist.cu), with
    B1's rule for the count mask (small integers, summed exactly)."""
    hk = dict(num_features=num_features, grad_col=grad_col,
              hess_col=hess_col, cnt_col=cnt_col)
    if payload.device.type == "cpu":
        return seg.partition_segment_hist(payload, aux, start, count, pred,
                                          left_value, right_value, value_col,
                                          num_bins, **hk)
    name = "partition_segment_hist"
    _check_payload(payload, name)
    _check_aux(payload, aux, name)
    dev = payload.device
    N, P = payload.shape
    F, B = num_features, num_bins
    cap = hist_group_cap(B) if B > 0 else 0
    T = _tile_rows("segment_partition_hist",
                   "segment_partition_hist_tile_rows", P)
    if not 0 < F <= P or cap == 0 or T == 0:
        raise ValueError("%s: F=%d, B=%d, width %d outside the kernel's "
                         "range" % (name, F, B, P))
    for c in (grad_col, hess_col, cnt_col, value_col):
        if not 0 <= c < P:
            raise ValueError("%s: column %d outside [0, %d)" % (name, c, P))
    scalars, bitset = _pred_args(start, count, pred, dev)
    fvals = _leaf_values(left_value, right_value, dev)
    lib, fn = _lib("segment_partition_hist", "segment_partition_hist_launch",
                   [_P, _P, _I, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _P]
                   + [_I] * 8 + [_P])
    n_tiles = -(-N // T)
    # each tile's left count and offset, num_left, then the move's ticket
    # and the tiles' flags
    scratch = torch.empty(3 * n_tiles + 2, dtype=torch.int32, device=dev)
    tile_left, tile_off, num_left, sync = scratch.split(
        (n_tiles, n_tiles, 1, n_tiles + 1))
    hist = torch.empty((2, F, B, 3), dtype=torch.float32, device=dev)
    sms = _sm_count(dev.index)
    rc = fn(payload.data_ptr(), aux.data_ptr(), P, scalars.data_ptr(),
            bitset.data_ptr(), bitset.shape[0], fvals.data_ptr(), value_col,
            n_tiles, tile_left.data_ptr(), tile_off.data_ptr(),
            num_left.data_ptr(), sync.data_ptr(), hist.data_ptr(), F, B, cap,
            grad_col, hess_col, cnt_col, hist_grid(sms, F, cap), sms,
            _stream(dev))
    _check(lib, "segment_partition_hist", rc)
    partition_segment_hist.launches += 1
    return payload, aux, num_left.reshape(()), hist[0], hist[1]


partition_segment_hist.launches = 0


def histogram_route(num_features: int):
    """The f32 histogram wrapper for F features: B7 from
    COLBLOCK_MIN_FEATURES on, else B1."""
    if num_features >= COLBLOCK_MIN_FEATURES:
        return segment_histogram_colblock
    return segment_histogram


def partition_route(payload_width: int):
    """The whole-partition wrapper for a payload of P columns: B8 from
    PARTITION_BLOCKS_MIN_WIDTH on, B3 from PARTITION_RMW_MIN_WIDTH on,
    else B2."""
    if payload_width >= PARTITION_BLOCKS_MIN_WIDTH:
        return partition_segment_blocks
    if payload_width >= PARTITION_RMW_MIN_WIDTH:
        return partition_segment_rmw
    return partition_segment
