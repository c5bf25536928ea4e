"""Wrappers of the hand-written Hopper kernels for the segment engine.

`segment_histogram` (csrc/segment_hist.cu) replaces the TPU kernel
lightgbm_tpu/ops/pallas_segment.py segment_histogram (_hist_kernel);
`partition_segment` (csrc/segment_partition.cu) replaces
partition_segment_acc (_acc_kernel).  Both keep the signatures and
returns of ops/segment.py.

For a tensor on the CPU a wrapper runs the plain PyTorch version in
ops/segment.py; for a CUDA tensor it launches its kernel on the current
stream or raises — there is no fallback.  Each wrapper counts its kernel
launches in a plain integer attribute, `<wrapper>.launches`.  start,
count and the predicate scalars may be 0-d device tensors: they are
packed on the device, so a launch never waits for the host.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from . import segment as seg
from .segment import SplitPredicate

_P = ctypes.c_void_p
_I = ctypes.c_int

#: shared memory one histogram block may use: two blocks fit on an SM
HIST_SMEM_BYTES = 110 * 1024


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


def segment_histogram(payload: torch.Tensor, start, count, *,
                      num_features: int, num_bins: int, grad_col: int,
                      hess_col: int, cnt_col: int) -> torch.Tensor:
    """hist[F, B, 3] over payload rows [start, start+count)."""
    kwargs = dict(num_features=num_features, num_bins=num_bins,
                  grad_col=grad_col, hess_col=hess_col, cnt_col=cnt_col)
    if payload.device.type == "cpu":
        return seg.segment_histogram(payload, start, count, **kwargs)
    _check_payload(payload, "segment_histogram")
    F, B, P = num_features, num_bins, payload.shape[1]
    if not 0 < F <= P or B * 3 * 4 > HIST_SMEM_BYTES:
        raise ValueError("segment_histogram: F=%d, B=%d outside the kernel's "
                         "range" % (F, B))
    dev = payload.device
    segv = _int_vec((start, count), dev)
    out = torch.zeros((F, B, 3), dtype=torch.float32, device=dev)
    Ft = min(F, HIST_SMEM_BYTES // (B * 3 * 4))
    grid_x = 2 * torch.cuda.get_device_properties(dev).multi_processor_count
    lib, fn = _lib("segment_hist", "segment_hist_launch",
                   [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P])
    rc = fn(payload.data_ptr(), P, segv.data_ptr(), out.data_ptr(), F, B, Ft,
            grad_col, hess_col, cnt_col, grid_x, _stream(dev))
    _check(lib, "segment_hist", rc)
    segment_histogram.launches += 1
    return out


segment_histogram.launches = 0


def partition_segment(payload: torch.Tensor, aux: torch.Tensor, start, count,
                      pred: SplitPredicate, left_value, right_value,
                      value_col: int):
    """Stable in-place partition of rows [start, start+count); returns
    (payload, aux, num_left) with num_left a 0-d int32 tensor."""
    if payload.device.type == "cpu":
        return seg.partition_segment(payload, aux, start, count, pred,
                                     left_value, right_value, value_col)
    _check_payload(payload, "partition_segment")
    if aux.shape != payload.shape or aux.dtype != payload.dtype \
            or aux.device != payload.device or not aux.is_contiguous():
        raise ValueError("partition_segment: aux must match the payload")
    dev = payload.device
    N, P = payload.shape
    if not 0 <= value_col < P:
        raise ValueError("partition_segment: value_col %d outside [0, %d)"
                         % (value_col, P))
    scalars = _int_vec((start, count, pred.col, pred.threshold,
                        pred.default_left, pred.is_cat, pred.missing_type,
                        pred.num_bin, pred.default_bin, pred.offset,
                        pred.identity), dev)
    # a bool bitset is passed as its bytes, with no conversion launch
    bitset = torch.as_tensor(pred.bitset, device=dev).to(torch.bool) \
        .contiguous().view(torch.uint8)
    fvals = torch.stack([torch.as_tensor(v, device=dev).reshape(())
                         .to(torch.float32)
                         for v in (left_value, right_value)])
    lib, fn = _lib("segment_partition", "segment_partition_launch",
                   [_P, _P, _I, _P, _P, _I, _P, _I, _I, _P, _P, _P, _I, _P])
    n_tiles = -(-N // lib.segment_partition_tile_rows())
    tile_left = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    tile_off = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    num_left = torch.empty(1, dtype=torch.int32, device=dev)
    copy_blocks = 8 * torch.cuda.get_device_properties(dev) \
        .multi_processor_count
    rc = fn(payload.data_ptr(), aux.data_ptr(), P, scalars.data_ptr(),
            bitset.data_ptr(), bitset.shape[0], fvals.data_ptr(), value_col,
            n_tiles, tile_left.data_ptr(), tile_off.data_ptr(),
            num_left.data_ptr(), copy_blocks, _stream(dev))
    _check(lib, "segment_partition", rc)
    partition_segment.launches += 1
    return payload, aux, num_left.reshape(())


partition_segment.launches = 0
