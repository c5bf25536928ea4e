"""Segment engine, plain PyTorch versions.

Counterpart of lightgbm_tpu/ops/segment.py, with the same signatures and
returns.  Training rows live in ONE row-major payload matrix
[N_pad + GUARD, P] (f32): bin columns, then value columns (label, weight,
count mask, row index, score, grad/hess, leaf value, ...).  Rows of every
tree leaf are kept physically contiguous, so a split's partition and a
leaf's histogram only touch the rows of one contiguous segment
[start, start + count).

These functions are the reference the hand-written kernels
(ops/cuda_segment.py) are held against, and what a CPU tensor runs:
the f32 and int32 (quantized) histograms, the batched histogram of the
frontier grower, the stable partition, whole or as its stage and
commit halves, and the merged partition + both children's histograms.
They index with host integers, so on a card they would sync per call;
the grower reaches them through ops/cuda_segment.py, which launches the
kernels for CUDA tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .bundle import decode_bin
from .split import MISSING_NAN, MISSING_ZERO

#: rows per chunk of the JAX engine.  The port's passes are not chunked;
#: the constant survives because it sizes GUARD.
CHUNK = 256

#: guard rows past the last real row, kept so a payload converts 1:1
#: between the two packages (convert.py).  Guard rows carry idx == n_pad
#: and a zero count mask.
GUARD = CHUNK + 8


def payload_col_write(payload: torch.Tensor, col, vec, op: str = "set"):
    """payload[:, col] <op>= vec, in place (the JAX version builds a new
    array; PyTorch updates the buffer it was given).  `vec` is an [N]
    vector or a scalar."""
    if op == "add":
        payload[:, col] += vec
    elif op == "mul":
        payload[:, col] *= vec
    elif op == "set":
        payload[:, col] = vec
    else:
        raise ValueError("op must be set|add|mul, got %r" % (op,))
    return payload


class SplitPredicate(NamedTuple):
    """Scalars describing one split's routing decision
    (Bin::Split semantics, src/io/dense_bin.hpp:190-283).  `col` is the
    STORAGE column (the feature's EFB bundle); offset/identity decode the
    stored value back to the feature's own bin.  Each field is a 0-d
    tensor (or a Python scalar), `bitset` a [B] bool tensor."""
    col: torch.Tensor           # i32 storage-column index into the bin columns
    threshold: torch.Tensor     # i32 bin threshold (numerical)
    default_left: torch.Tensor  # bool — where missing rows go
    is_cat: torch.Tensor        # bool — categorical bitset split
    bitset: torch.Tensor        # [B] bool — bins routed left (categorical)
    missing_type: torch.Tensor  # i32 (of the split feature)
    num_bin: torch.Tensor       # i32
    default_bin: torch.Tensor   # i32
    offset: torch.Tensor        # i32 bin offset inside the bundle
    identity: torch.Tensor      # bool — raw-bin passthrough (no bundle)


def go_left_chunk(chunk: torch.Tensor, pred: SplitPredicate) -> torch.Tensor:
    """[C] bool routing for payload rows (bin cols at [:, :G])."""
    dev = chunk.device
    fcol = chunk[:, int(pred.col)]
    num_bin = int(pred.num_bin)
    default_bin = int(pred.default_bin)
    fbin = decode_bin(fcol, bool(pred.identity), int(pred.offset), num_bin,
                      default_bin)
    mt = int(pred.missing_type)
    miss = ((mt == MISSING_NAN) & (fbin == num_bin - 1)) | \
           ((mt == MISSING_ZERO) & (fbin == default_bin))
    gl_num = torch.where(miss, bool(pred.default_left),
                         fbin <= int(pred.threshold))
    if not bool(pred.is_cat):
        return gl_num
    bitset = torch.as_tensor(pred.bitset, dtype=torch.bool, device=dev)
    inside = (fbin >= 0) & (fbin < bitset.shape[0])
    return inside & bitset[fbin.clamp(0, bitset.shape[0] - 1).long()]


def partition_segment_stage(payload: torch.Tensor, aux: torch.Tensor, start,
                            count, pred: SplitPredicate):
    """The first half of the stable partition: the rows of
    [start, start+count), left rows first, into aux over the same range.
    payload is only read, so the frontier-batched grower can stage a
    candidate split and copy it back (`partition_segment_commit`) only if
    it commits.  Unlike the JAX version, nothing is written past the
    segment, so segments may be staged in any order.  Returns
    (aux, num_left), num_left a 0-d int32 tensor."""
    s, c = int(start), int(count)
    rows = payload[s:s + c]
    gl = go_left_chunk(rows, pred)
    order = torch.cat([torch.nonzero(gl)[:, 0], torch.nonzero(~gl)[:, 0]])
    aux[s:s + c] = rows[order]
    return aux, torch.tensor(int(gl.sum()), dtype=torch.int32,
                             device=payload.device)


def partition_segment_commit(payload: torch.Tensor, aux: torch.Tensor, start,
                             count, num_left, left_value, right_value,
                             value_col: int) -> torch.Tensor:
    """The second half: copy aux[start, start+count) back into payload,
    writing the children's creation values (left_value for the first
    num_left rows, right_value after them) into `value_col`.  count = 0 is
    a no-op (a staged candidate that did not commit).  Returns payload,
    updated in place."""
    s, c = int(start), int(count)
    nl = min(int(num_left), c)
    payload[s:s + c] = aux[s:s + c]
    payload[s:s + nl, value_col] = torch.as_tensor(left_value,
                                                   dtype=payload.dtype)
    payload[s + nl:s + c, value_col] = torch.as_tensor(right_value,
                                                       dtype=payload.dtype)
    return payload


def partition_segment(payload: torch.Tensor, aux: torch.Tensor, start, count,
                      pred: SplitPredicate, left_value, right_value,
                      value_col: int):
    """Stably partition payload rows [start, start+count) by the predicate:
    left rows first.  aux[start, start+count) receives the partitioned
    rows, payload gets them back with the children's leaf outputs written
    into `value_col`.  Returns (payload, aux, num_left), num_left a 0-d
    int32 tensor; payload and aux are updated in place.  The stage and the
    commit above, one after the other."""
    aux, num_left = partition_segment_stage(payload, aux, start, count, pred)
    payload = partition_segment_commit(payload, aux, start, count, num_left,
                                       left_value, right_value, value_col)
    return payload, aux, num_left


def segment_histogram(payload: torch.Tensor, start, count, *,
                      num_features: int, num_bins: int, grad_col: int,
                      hess_col: int, cnt_col: int,
                      quantized: bool = False) -> torch.Tensor:
    """hist[F, B, 3] over payload rows [start, start+count).

    Each (feature, bin, channel) cell is summed in row order — on the CPU
    a 1-D index_add_ runs serially — which is the order of the JAX CPU
    engine's scatter-add, so the two agree bit for bit on equal inputs.

    quantized=True (gradient_quantization, ops/quantize.py): the grad/hess
    columns hold integer-valued quantized gradients, and the histogram is
    int32, each value converted exactly; integer sums are order-free, so
    every engine agrees bit for bit."""
    F, B = num_features, num_bins
    s, c = int(start), int(count)
    rows = payload[s:s + c]
    dev = payload.device
    bins = rows[:, :F].to(torch.int64)                             # [c, F]
    cell = bins + torch.arange(F, dtype=torch.int64, device=dev)[None, :] * B
    vals = torch.stack([rows[:, grad_col], rows[:, hess_col],
                        rows[:, cnt_col]], dim=1)                  # [c, 3]
    idx = (cell[:, :, None] * 3
           + torch.arange(3, dtype=torch.int64, device=dev)).reshape(-1)
    upd = vals[:, None, :].expand(c, F, 3).reshape(-1)
    dtype = torch.int32 if quantized else torch.float32
    hist = torch.zeros(F * B * 3, dtype=dtype, device=dev)
    hist.index_add_(0, idx, upd.to(dtype))
    return hist.reshape(F, B, 3)


def partition_segment_hist(payload: torch.Tensor, aux: torch.Tensor, start,
                           count, pred: SplitPredicate, left_value,
                           right_value, value_col: int, num_bins: int, *,
                           num_features: int, grad_col: int, hess_col: int,
                           cnt_col: int):
    """The merged partition + histogram: `partition_segment`, then both
    children's f32 histograms from the partitioned rows, the left over
    [start, start+num_left) and the right over the rest.  Returns
    (payload, aux, num_left, hist_left, hist_right).  This is the JAX
    grower's portable merged step (part_hist_fn), so on equal inputs the
    two agree bit for bit."""
    payload, aux, num_left = partition_segment(payload, aux, start, count,
                                               pred, left_value, right_value,
                                               value_col)
    hk = dict(num_features=num_features, num_bins=num_bins,
              grad_col=grad_col, hess_col=hess_col, cnt_col=cnt_col)
    nl = int(num_left)
    hist_left = segment_histogram(payload, start, nl, **hk)
    hist_right = segment_histogram(payload, int(start) + nl,
                                   int(count) - nl, **hk)
    return payload, aux, num_left, hist_left, hist_right


def segment_histogram_batched(payload: torch.Tensor, starts, counts, *,
                              num_features: int, num_bins: int,
                              grad_col: int, hess_col: int, cnt_col: int,
                              quantized: bool = False) -> torch.Tensor:
    """hist[K, F, B, 3] over K disjoint segments: slice k is
    `segment_histogram(payload, starts[k], counts[k])`, bit for bit; a
    zero count gives zeros (an inactive slot of the frontier window)."""
    kw = dict(num_features=num_features, num_bins=num_bins,
              grad_col=grad_col, hess_col=hess_col, cnt_col=cnt_col,
              quantized=quantized)
    starts = torch.as_tensor(starts).reshape(-1).tolist()
    counts = torch.as_tensor(counts).reshape(-1).tolist()
    if len(starts) != len(counts):
        raise ValueError("starts and counts differ in length: %d vs %d"
                         % (len(starts), len(counts)))
    if not starts:
        return torch.zeros((0, num_features, num_bins, 3),
                           dtype=torch.int32 if quantized else torch.float32,
                           device=payload.device)
    return torch.stack([segment_histogram(payload, s, c, **kw)
                        for s, c in zip(starts, counts)])
