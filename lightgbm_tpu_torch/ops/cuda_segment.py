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
the segments' counts (csrc/segment_hist.cuh): the host sizes a fixed grid
from the card alone (`hist_grid`), and each block takes a feature group
and a run of row chunks of the K segments by `hist_work_split` and
`hist_block_work`: their Python form here is the one the CPU tests hold
to cover every (segment, row, feature) once, and chip_smoke.py holds it
to the kernel's own (the library's `segment_hist_split`).  Their count
mask holds small integers (0 or 1 in the grower): each is summed exactly
as an int32, where the plain version sums floats.

The f32 histograms on the card (B1, B5 f32, B6, B7) sum in fixed point,
so their result does not depend on the order of the adds: each is
`segment.segment_histogram_fixed` bit for bit, at the int32 [2]
exponents `scale` (the grower passes one per tree, from
`segment.fixed_scale` over the payload; without one a wrapper derives it
from its own segments on the device).  Their int64 scratch and tickets
are a `Workspace`'s (the grower's own, else the device's default),
zeroed once and left zero by every launch, so the wrappers launch on one
stream per device.  A CPU
tensor keeps the plain row-order f32 sum (`segment.segment_histogram`),
the JAX CPU engine's order.

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
packed on the device, so a launch never waits for the host, and a
Python scalar is filled on the device, never copied from the host, so
every launch can be captured in a CUDA graph.  A count-0 segment is a
no-op: nothing is written, num_left is 0 and a histogram is zero.  Each
wrapper takes an optional `workspace=` (`Workspace`) for its kernels'
scratch.
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
#: shared memory a histogram cell takes: int32 (grad, hess, count), and
#: fixed point (two 32-bit words for grad and for hess, and the count)
#: (kHistCellBytesInt / kHistCellBytesFixed of csrc/segment_hist.cuh)
HIST_CELL_BYTES_INT = 12
HIST_CELL_BYTES_FIXED = 20
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
    without a host round trip.  Each value is cast first: a stack of mixed
    dtypes copies its inputs one launch each, a stack of one dtype takes
    one launch for all."""
    return torch.stack([seg.scalar(v, torch.int32, device) for v in values])


def _check_payload(payload: torch.Tensor, name: str) -> None:
    if not payload.is_cuda:
        raise ValueError("%s: payload must be a CPU or CUDA tensor, got %s"
                         % (name, payload.device))
    if payload.dtype != torch.float32 or payload.dim() != 2 \
            or not payload.is_contiguous():
        raise ValueError("%s: payload must be a contiguous 2-D float32 "
                         "tensor" % name)
    if payload.shape[0] >= 2 ** 31:
        raise ValueError("%s: payload of %d rows is past the kernels' int32 "
                         "row indexing" % (name, payload.shape[0]))


def _check_aux(payload: torch.Tensor, aux: torch.Tensor, name: str) -> None:
    if aux.shape != payload.shape or aux.dtype != payload.dtype \
            or aux.device != payload.device or not aux.is_contiguous():
        raise ValueError("%s: aux must match the payload" % name)


def hist_stride(num_bins: int) -> int:
    """Cells a feature takes in a histogram block's shared memory: B + 1,
    made odd (hist_stride of csrc/segment_hist.cuh)."""
    return (num_bins + 1) | 1


def hist_group_cap(num_bins: int, quantized: bool = False) -> int:
    """Features per histogram group at most at `num_bins` bins: as many as
    HIST_SMEM_BYTES holds at hist_stride cells a feature of 20 bytes (f32,
    fixed point) or 12 (int32), at most HIST_GROUP_COLS; 0 when not one
    fits."""
    cell = HIST_CELL_BYTES_INT if quantized else HIST_CELL_BYTES_FIXED
    return min(HIST_GROUP_COLS,
               HIST_SMEM_BYTES // (hist_stride(num_bins) * cell))


def hist_grid(sms: int, num_features: int, cap: int) -> int:
    """Histogram blocks: two per SM, and at least one per feature group
    the shared memory forces."""
    return max(2 * sms, -(-num_features // cap))


class HistSplit(NamedTuple):
    """How the histogram kernels split K segments' rows (their chunks
    numbered one after another, segment 0's first) and F features over a
    grid (hist_split of csrc/segment_hist.cuh)."""
    groups: int      # feature groups
    group_cols: int  # features per group; the last may have fewer
    chunks: int      # row chunks of all segments
    offsets: tuple   # each segment's first chunk, and `chunks` last


def hist_work_split(counts, grid: int, num_features: int,
                    cap: int) -> HistSplit:
    """The split of segments of counts[k] rows (B1's one segment; B5's K;
    B6's children, the left then the right) over `grid` blocks: chunks of
    HIST_CHUNK_ROWS rows; as many feature groups (of at most `cap`
    features) as fill the grid when there are fewer chunks than blocks,
    else as few as `cap` allows."""
    F = num_features
    offsets = [0]
    for c in counts:
        offsets.append(offsets[-1] + -(-int(c) // HIST_CHUNK_ROWS))
    chunks = offsets[-1]
    g = grid // chunks if chunks > 0 else grid
    g = max(min(g, F), -(-F // cap))
    group_cols = -(-F // g)
    return HistSplit(-(-F // group_cols), group_cols, chunks, tuple(offsets))


class HistRun(NamedTuple):
    """One block's share of a split (hist_run of csrc/segment_hist.cuh)."""
    group: int
    first: int     # its run of chunks [first, last)
    last: int
    workers: int   # the blocks of its group with a run
    works: bool    # whether it has one (with no chunks at all, the
    #                group's first block takes the empty run)
    q: int         # the run's index in its group
    per: int       # chunks a full run takes


def hist_run(split: HistSplit, block: int, grid: int) -> HistRun:
    group = block % split.groups
    q = block // split.groups
    nbg = (grid - group + split.groups - 1) // split.groups
    per = -(-split.chunks // nbg) if split.chunks > 0 else 0
    workers = -(-split.chunks // per) if split.chunks > 0 else 1
    first = q * per
    return HistRun(group, first, min(first + per, split.chunks), workers,
                   q < workers, q, per)


def hist_owners(split: HistSplit, run: HistRun, k: int) -> range:
    """The runs of `run`'s group that convert segment k's cells (hist_owners
    of csrc/segment_hist.cuh): those holding one of its chunks, and for an
    empty segment the run at its place; the last of them to flush writes
    the f32 cells."""
    off = split.offsets[k]
    nck = split.offsets[k + 1] - off
    if nck:
        return range(off // run.per, (off + nck - 1) // run.per + 1)
    qa = min(off // run.per, run.workers - 1) if run.per else 0
    return range(qa, qa + 1)


def hist_block_work(split: HistSplit, block: int, grid: int,
                    num_features: int) -> tuple:
    """Block `block`'s work under `split`: (first feature, features,
    [(segment, chunk of that segment) in the order it takes them]); no
    chunks for a block past the work."""
    r = hist_run(split, block, grid)
    f0 = r.group * split.group_cols
    fn = min(split.group_cols, num_features - f0)
    work = []
    if r.works:
        k = 0
        for j in range(r.first, r.last):
            while j >= split.offsets[k + 1]:
                k += 1
            work.append((k, j - split.offsets[k]))
    return f0, fn, work


class Workspace:
    """The scratch of the wrappers' kernels on one device: int32 words (the
    partitions' tile counts, offsets, tickets and flags, B8's row
    destinations), bytes (B8's row sides), and the fixed-point histograms'
    int64 cells, int32 counts and tickets, which are zeroed once and which
    every launch leaves zero.  Launches on one stream run in order, so
    each call takes its scratch from the start of each buffer; outputs
    (histograms, num_left) are new tensors.

    A grower makes one before its first tree, sized for the largest call
    of its route (`sized`), and frozen: a CUDA graph holds its addresses,
    so a call that needs more raises instead of replacing a buffer.  A
    wrapper called without one takes the device's default workspace, which
    grows to the largest call it has seen (the allocator orders an old
    buffer's reuse after the launches on the stream)."""

    def __init__(self, device, ints: int = 0, nbytes: int = 0,
                 cells: int = 0, tickets: int = 0, frozen: bool = False):
        self.device = torch.device(device)
        self.frozen = frozen
        self._i32 = torch.empty(ints, dtype=torch.int32, device=self.device)
        self._u8 = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
        self._fixed = self._zeroed(cells, tickets)

    def _zeroed(self, cells: int, tickets: int) -> tuple:
        dev = self.device
        return (torch.zeros((cells, 2), dtype=torch.int64, device=dev),
                torch.zeros(cells, dtype=torch.int32, device=dev),
                torch.zeros(tickets, dtype=torch.int32, device=dev))

    def _refuse(self, what: str, need: int, have: int) -> None:
        if self.frozen:
            raise ValueError("workspace: a call needs %d %s, the grower's "
                             "workspace holds %d" % (need, what, have))

    def ints(self, n: int) -> torch.Tensor:
        if self._i32.numel() < n:
            self._refuse("int32 words", n, self._i32.numel())
            self._i32 = torch.empty(n, dtype=torch.int32, device=self.device)
        return self._i32[:n]

    def bytes(self, n: int) -> torch.Tensor:
        if self._u8.numel() < n:
            self._refuse("bytes", n, self._u8.numel())
            self._u8 = torch.empty(n, dtype=torch.uint8, device=self.device)
        return self._u8[:n]

    def fixed(self, cells: int, tickets: int) -> tuple:
        """Pointers to the fixed-point scratch: at least `cells` cells and
        `tickets` tickets, all zero."""
        gh, cnt, tk = self._fixed
        if cnt.numel() < cells or tk.numel() < tickets:
            self._refuse("fixed-point cells / tickets",
                         max(cells, tickets), min(cnt.numel(), tk.numel()))
            self._fixed = self._zeroed(max(cells, cnt.numel()),
                                       max(tickets, tk.numel()))
        return tuple(t.data_ptr() for t in self._fixed)

    @classmethod
    def sized(cls, device, needs) -> "Workspace":
        """A frozen workspace holding the largest of `needs`, each an
        (ints, nbytes, cells, tickets) tuple of `scratch_need`."""
        top = [max([n[k] for n in needs] + [0]) for k in range(4)]
        return cls(device, *top, frozen=True)


#: the default workspace per device index
_DEFAULT_WORKSPACE = {}


def _workspace(ws, dev) -> Workspace:
    if ws is not None:
        if ws.device != dev:
            raise ValueError("workspace on %s, payload on %s"
                             % (ws.device, dev))
        return ws
    have = _DEFAULT_WORKSPACE.get(dev.index)
    if have is None:
        have = _DEFAULT_WORKSPACE[dev.index] = Workspace(dev)
    return have


def _scale_of(payload: torch.Tensor, scale, starts, counts, grad_col: int,
              hess_col: int) -> torch.Tensor:
    """The int32 [2] fixed-point exponents on the payload's device: the
    caller's, or `segment.fixed_scale` of the segments."""
    if scale is None:
        scale = seg.fixed_scale(payload, starts, counts, grad_col, hess_col)
    scale = torch.as_tensor(scale, device=payload.device).to(torch.int32) \
        .reshape(2).contiguous()
    return scale


def _hist_launch(name: str, payload: torch.Tensor, segv: torch.Tensor,
                 quantized: bool, scale=None, workspace=None, *,
                 num_features: int, num_bins: int, grad_col: int,
                 hess_col: int, cnt_col: int,
                 raw: bool = False) -> torch.Tensor:
    """Launch csrc/segment_hist.cu over K segments (segv: int32 [K, 2]
    start/count on the device); returns the filled [K, F, B, 3] output:
    int32 when quantized, else f32 at the fixed-point exponents `scale`
    (derived from the segments when None), or with `raw` the int64 cells
    (grad and hess at those exponents, count) without the conversion."""
    _check_payload(payload, name)
    F, B, P = num_features, num_bins, payload.shape[1]
    K = segv.shape[0]
    cap = hist_group_cap(B, quantized) if B > 0 else 0
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
    lib, fn = _lib("segment_hist", "segment_hist_launch",
                   [_P, _I, _I, _P, _P] + [_I] * 10 + [_P] * 4 + [_I, _P])
    if quantized:
        out = torch.zeros((K, F, B, 3), device=dev, dtype=torch.int32)
        sc, gh, cnt, tk = None, None, None, None
    else:
        out = torch.empty((K, F, B, 3), device=dev,
                          dtype=torch.int64 if raw else torch.float32)
        sc = _scale_of(payload, scale, segv[:, 0], segv[:, 1], grad_col,
                       hess_col)
        gh, cnt, tk = _workspace(workspace, dev).fixed(K * F * B, K * F)
    rc = fn(payload.data_ptr(), P, payload.shape[0], segv.data_ptr(),
            out.data_ptr(), K, F, B, cap, grad_col, hess_col, cnt_col,
            hist_grid(_sm_count(dev.index), F, cap), int(quantized),
            int(name == "segment_histogram_batched"),
            None if sc is None else sc.data_ptr(), gh, cnt, tk,
            int(raw and not quantized), _stream(dev))
    _check(lib, "segment_hist", rc)
    return out


def segment_histogram(payload: torch.Tensor, start, count, *,
                      num_features: int, num_bins: int, grad_col: int,
                      hess_col: int, cnt_col: int, scale=None,
                      workspace=None, raw: bool = False) -> torch.Tensor:
    """f32 hist[F, B, 3] over payload rows [start, start+count) (B1).  On
    the card: `segment.segment_histogram_fixed` at the int32 [2]
    exponents `scale` (by default those of this segment), bit for bit; on
    the CPU the plain row-order sum, `scale` unused.  The count mask
    column must hold small integers (0 or 1): the kernel rounds each to
    int32 before its exact sum.

    raw: the int64 [F, B, 3] cells before the conversion (the exact sums
    of grad and hess at `scale`, and the count), which sum exactly across
    the distributed learners' ranks (`segment.cells_to_hist` converts
    them); the plain version, on the CPU too, is `segment.fixed_cells`."""
    kwargs = dict(num_features=num_features, num_bins=num_bins,
                  grad_col=grad_col, hess_col=hess_col, cnt_col=cnt_col)
    if payload.device.type == "cpu":
        if raw:
            return seg.fixed_cells(payload, start, count, scale=scale,
                                   **kwargs)
        return seg.segment_histogram(payload, start, count, **kwargs)
    segv = _int_vec((start, count), payload.device).reshape(1, 2)
    out = _hist_launch("segment_histogram", payload, segv, False, scale,
                       workspace, raw=raw, **kwargs)
    segment_histogram.launches += 1
    return out[0]


segment_histogram.launches = 0


def segment_histogram_quant(payload: torch.Tensor, start, count, *,
                            num_features: int, num_bins: int, grad_col: int,
                            hess_col: int, cnt_col: int,
                            workspace=None) -> torch.Tensor:
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
                              quantized: bool = False, scale=None,
                              workspace=None) -> torch.Tensor:
    """hist[K, F, B, 3] over K disjoint segments (B5): starts / counts are
    [K] integer tensors; slice k equals the single-segment histogram of
    segment k, a zero count gives zeros.  int32 when quantized; else, on
    the card, `segment.segment_histogram_fixed` of each segment at the
    exponents `scale` (by default those of all K segments' rows)."""
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
                       quantized, scale, workspace, **kwargs)
    segment_histogram_batched.launches += 1
    return out


segment_histogram_batched.launches = 0


def _pred_args(start, count, pred: SplitPredicate, rows: int, dev):
    """The kernels' predicate: int32[12] scalars (start, count, col,
    threshold, default_left, is_cat, missing_type, num_bin, default_bin,
    offset, identity, and the payload's `rows`, which the kernels check
    the segment against on the device) and the bitset's bytes, both on
    `dev`."""
    scalars = _int_vec((start, count, pred.col, pred.threshold,
                        pred.default_left, pred.is_cat, pred.missing_type,
                        pred.num_bin, pred.default_bin, pred.offset,
                        pred.identity, rows), dev)
    # a bool bitset is passed as its bytes, with no conversion launch
    bitset = torch.as_tensor(pred.bitset, device=dev).to(torch.bool) \
        .contiguous().view(torch.uint8)
    return scalars, bitset


def _leaf_values(left_value, right_value, dev) -> torch.Tensor:
    return torch.stack([seg.scalar(v, torch.float32, dev)
                        for v in (left_value, right_value)])


def _stage(payload, aux, start, count, pred: SplitPredicate, num_left,
           slot: int, workspace=None) -> None:
    """Launch the stage kernels, writing num_left into num_left[slot]."""
    dev = payload.device
    N, P = payload.shape
    T = _tile_rows("segment_partition", "segment_partition_move_tile_rows", P)
    if T == 0:
        raise ValueError("partition stage: width %d past the kernel" % P)
    scalars, bitset = _pred_args(start, count, pred, N, dev)
    lib, fn = _lib("segment_partition", "segment_partition_stage_launch",
                   [_P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _I, _P])
    n_tiles = -(-N // T)
    # each tile's left count and offset, then the move's ticket and the
    # tiles' flags (cleared by the count; the stage reads no flag)
    scratch = _workspace(workspace, dev).ints(_whole_row_ints(n_tiles))
    tile_left, tile_off, sync = scratch.split((n_tiles, n_tiles, n_tiles + 1))
    rc = fn(payload.data_ptr(), aux.data_ptr(), P, scalars.data_ptr(),
            bitset.data_ptr(), bitset.shape[0], n_tiles, tile_left.data_ptr(),
            tile_off.data_ptr(), num_left.data_ptr() + 4 * slot,
            sync.data_ptr(), _sm_count(dev.index), _stream(dev))
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
                   [_P, _P, _I, _P, _I, _P, _P, _I, _I, _P])
    rc = fn(payload.data_ptr(), aux.data_ptr(), P, segv.data_ptr(),
            payload.shape[0], num_left.data_ptr(), fvals.data_ptr(), value_col,
            4 * _sm_count(dev.index), _stream(dev))
    _check(lib, "segment_partition", rc)


@functools.lru_cache(maxsize=None)
def _tile_rows(lib_name: str, entry: str, payload_width: int) -> int:
    f = getattr(build.load(lib_name), entry)
    f.argtypes = [_I]
    return f(payload_width)


def _whole_row_ints(n_tiles: int) -> int:
    """int32 scratch of a whole-row partition or stage of n_tiles tiles:
    each tile's left count and offset, then the move's ticket and the
    tiles' flags."""
    return 3 * n_tiles + 1


#: the whole-row partitions: library and tile-rows entry, by wrapper
_WHOLE_ROW = {
    "partition_segment": ("segment_partition",
                          "segment_partition_move_tile_rows"),
    "partition_segment_stage": ("segment_partition",
                                "segment_partition_move_tile_rows"),
    "partition_segment_rmw": ("segment_partition_wide",
                              "segment_partition_rmw_tile_rows"),
    "partition_segment_hist": ("segment_partition_hist",
                               "segment_partition_hist_tile_rows"),
}


def scratch_need(wrapper, n_rows: int, width: int, num_features: int,
                 num_bins: int, segments: int = 1) -> tuple:
    """(int32 words, bytes, fixed-point cells, tickets) of one call of
    `wrapper` on an [n_rows, width] payload: what `Workspace.sized` takes
    for a grower's route.  `segments`: the batched histogram's K."""
    name = wrapper.__name__
    F, B, N = num_features, num_bins, n_rows
    ints = nbytes = cells = tickets = 0
    if name in _WHOLE_ROW:
        T = _tile_rows(*_WHOLE_ROW[name], width)
        ints = _whole_row_ints(-(-N // T)) if T else 0
    if name == "partition_segment_blocks":
        ints, nbytes = _blocks_ints(N, width), N
    if name in ("segment_histogram", "segment_histogram_colblock"):
        cells, tickets = F * B, F
    if name == "partition_segment_hist":
        cells, tickets = 2 * F * B, 2 * F
    if name == "segment_histogram_batched":
        cells, tickets = segments * F * B, segments * F
    return ints, nbytes, cells, tickets


def _whole_row_partition(payload, aux, start, count, pred: SplitPredicate,
                         left_value, right_value, value_col: int,
                         lib_name: str, entry: str, rows_entry: str,
                         name: str, workspace=None):
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
    scalars, bitset = _pred_args(start, count, pred, N, dev)
    fvals = _leaf_values(left_value, right_value, dev)
    lib, fn = _lib(lib_name, entry,
                   [_P, _P, _I, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _I,
                    _P])
    n_tiles = -(-N // T)
    scratch = _workspace(workspace, dev).ints(_whole_row_ints(n_tiles))
    tile_left, tile_off, sync = scratch.split((n_tiles, n_tiles, n_tiles + 1))
    num_left = torch.empty(1, dtype=torch.int32, device=dev)
    rc = fn(payload.data_ptr(), aux.data_ptr(), P, scalars.data_ptr(),
            bitset.data_ptr(), bitset.shape[0], fvals.data_ptr(), value_col,
            n_tiles, tile_left.data_ptr(), tile_off.data_ptr(),
            num_left.data_ptr(), sync.data_ptr(), _sm_count(dev.index),
            _stream(dev))
    _check(lib, lib_name, rc)
    return num_left.reshape(())


def partition_segment(payload: torch.Tensor, aux: torch.Tensor, start, count,
                      pred: SplitPredicate, left_value, right_value,
                      value_col: int, workspace=None):
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
        "segment_partition_move_tile_rows", "partition_segment", workspace)
    partition_segment.launches += 1
    return payload, aux, num_left


partition_segment.launches = 0


def partition_segment_stage(payload: torch.Tensor, aux: torch.Tensor, start,
                            count, pred: SplitPredicate, num_left=None,
                            slot: int = 0, workspace=None):
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
    _stage(payload, aux, start, count, pred, num_left, slot, workspace)
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
                               grad_col: int, hess_col: int, cnt_col: int,
                               scale=None, workspace=None,
                               raw: bool = False) -> torch.Tensor:
    """f32 hist[F, B, 3] over payload rows [start, start+count) of a wide
    payload (B7: replaces lightgbm_tpu/ops/pallas_segment.py
    segment_histogram_colblock).  Its contract is B1's, fixed-point sums,
    `scale` and `raw` included, so a CPU tensor runs the same plain
    versions, `seg.segment_histogram` and `seg.fixed_cells`."""
    kwargs = dict(num_features=num_features, num_bins=num_bins,
                  grad_col=grad_col, hess_col=hess_col, cnt_col=cnt_col)
    if payload.device.type == "cpu":
        if raw:
            return seg.fixed_cells(payload, start, count, scale=scale,
                                   **kwargs)
        return seg.segment_histogram(payload, start, count, **kwargs)
    _check_payload(payload, "segment_histogram_colblock")
    F, B, P = num_features, num_bins, payload.shape[1]
    lib, fn = _lib("segment_hist_colblock", "segment_hist_colblock_launch",
                   [_P, _I, _I, _P, _P] + [_I] * 6 + [_P] * 4 + [_I, _P])
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
    sc = _scale_of(payload, scale, segv[0], segv[1], grad_col, hess_col)
    gh, cnt, tk = _workspace(workspace, dev).fixed(F * B, F)
    out = torch.empty((F, B, 3), device=dev,
                      dtype=torch.int64 if raw else torch.float32)
    rc = fn(payload.data_ptr(), P, payload.shape[0], segv.data_ptr(),
            out.data_ptr(), F, B, _sm_count(dev.index), grad_col, hess_col,
            cnt_col, sc.data_ptr(), gh, cnt, tk, int(raw), _stream(dev))
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


def _blocks_ints(n_rows: int, width: int) -> int:
    """B8's int32 scratch: each row's destination, each tile's left count
    and offset, and the move's ticket and flags (one per row tile and
    column block)."""
    tile, row_tile, col_block = _blocks_tiles()
    return (n_rows + 2 * -(-n_rows // tile)
            + 1 + -(-n_rows // row_tile) * -(-width // col_block))


def _partition_blocks(payload, aux, start, count, pred: SplitPredicate,
                      left_value, right_value, value_col: int,
                      workspace=None):
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
    scalars, bitset = _pred_args(start, count, pred, N, dev)
    fvals = _leaf_values(left_value, right_value, dev)
    n_tiles = -(-N // _blocks_tiles()[0])
    ws = _workspace(workspace, dev)
    side = ws.bytes(N)
    n_ints = _blocks_ints(N, P)
    dest, tile_left, tile_off, sync = ws.ints(n_ints).split(
        (N, n_tiles, n_tiles, n_ints - N - 2 * n_tiles))
    num_left = torch.empty(1, dtype=torch.int32, device=dev)
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
                          right_value, value_col: int, workspace=None):
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
        "segment_partition_rmw_tile_rows", "partition_segment_rmw",
        workspace)
    partition_segment_rmw.launches += 1
    return payload, aux, num_left


partition_segment_rmw.launches = 0


def partition_segment_blocks(payload: torch.Tensor, aux: torch.Tensor, start,
                             count, pred: SplitPredicate, left_value,
                             right_value, value_col: int, workspace=None):
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
                                 left_value, right_value, value_col,
                                 workspace)
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
                           cnt_col: int, scale=None, workspace=None):
    """Stable in-place partition of rows [start, start+count) and both
    children's f32 histograms [F, B, 3]; returns (payload, aux, num_left,
    hist_left, hist_right) with num_left a 0-d int32 device tensor (B6:
    replaces lightgbm_tpu/ops/pallas_segment.py partition_segment_hist).
    On the card the partition is B2's in-place one: payload and num_left
    byte for byte, aux over the segment scratch; then both histograms,
    split over the card as B1's (csrc/segment_partition_hist.cu), with
    B1's rules: the count mask small integers summed exactly, grad / hess
    `segment.segment_histogram_fixed`'s at the exponents `scale` (by
    default those of the parent segment)."""
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
    scalars, bitset = _pred_args(start, count, pred, N, dev)
    fvals = _leaf_values(left_value, right_value, dev)
    lib, fn = _lib("segment_partition_hist", "segment_partition_hist_launch",
                   [_P, _P, _I, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _P]
                   + [_I] * 7 + [_P] * 4 + [_I, _P])
    n_tiles = -(-N // T)
    ws = _workspace(workspace, dev)
    tile_left, tile_off, sync = ws.ints(_whole_row_ints(n_tiles)).split(
        (n_tiles, n_tiles, n_tiles + 1))
    num_left = torch.empty(1, dtype=torch.int32, device=dev)
    hist = torch.empty((2, F, B, 3), dtype=torch.float32, device=dev)
    sc = _scale_of(payload, scale, scalars[0], scalars[1], grad_col,
                   hess_col)
    gh, cnt, tk = ws.fixed(2 * F * B, 2 * F)
    sms = _sm_count(dev.index)
    rc = fn(payload.data_ptr(), aux.data_ptr(), P, scalars.data_ptr(),
            bitset.data_ptr(), bitset.shape[0], fvals.data_ptr(), value_col,
            n_tiles, tile_left.data_ptr(), tile_off.data_ptr(),
            num_left.data_ptr(), sync.data_ptr(), hist.data_ptr(), F, B, cap,
            grad_col, hess_col, cnt_col, hist_grid(sms, F, cap),
            sc.data_ptr(), gh, cnt, tk, sms, _stream(dev))
    _check(lib, "segment_partition_hist", rc)
    partition_segment_hist.launches += 1
    return payload, aux, num_left.reshape(()), hist[0], hist[1]


partition_segment_hist.launches = 0


#: the wrappers that count their launches, by name
WRAPPERS = ("segment_histogram", "segment_histogram_quant",
            "segment_histogram_batched", "partition_segment",
            "partition_segment_stage", "partition_segment_commit",
            "segment_histogram_colblock", "partition_segment_rmw",
            "partition_segment_blocks", "partition_segment_hist")


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
