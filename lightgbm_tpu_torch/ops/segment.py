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
The card's f32 histograms sum in fixed point, so they are held bit for
bit to `segment_histogram_fixed`; a CPU tensor keeps the row-order f32
sum of `segment_histogram`, the JAX CPU engine's order.
They never read a tensor's value on the host: start, count and the
predicate may be 0-d tensors, a segment's rows are picked by a mask over
the payload's rows, and the results stay tensors, so the grower's tree
runs on the CPU with no host read (on a card the mask's selection waits
for the device; the grower reaches these through ops/cuda_segment.py,
which launches the kernels for CUDA tensors).
"""
from __future__ import annotations

import math

import numbers
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


def scalar(v, dtype, device) -> torch.Tensor:
    """v, a number or a one-element array, as a 0-d `dtype` tensor on
    `device`: a tensor is cast there, a number filled there (a fill is a
    launch that a CUDA graph can hold; a host-to-device copy from pageable
    memory is not)."""
    if isinstance(v, torch.Tensor):
        return v.to(device).reshape(()).to(dtype)
    if isinstance(v, numbers.Number):
        return torch.full((), v, dtype=dtype, device=device)
    return torch.as_tensor(v, device=device).reshape(()).to(dtype)


def segment_rows(n: int, start, count, device) -> torch.Tensor:
    """[n] bool mask of the rows [start, start+count)."""
    idx = torch.arange(n, device=device)
    s = scalar(start, torch.int64, device)
    return (idx >= s) & (idx < s + scalar(count, torch.int64, device))


def go_left_chunk(chunk: torch.Tensor, pred: SplitPredicate) -> torch.Tensor:
    """[C] bool routing for payload rows (bin cols at [:, :G])."""
    dev = chunk.device
    i32 = torch.int32

    def sc(v, dtype=i32):
        return scalar(v, dtype, dev)

    fcol = chunk.index_select(1, sc(pred.col, torch.int64).reshape(1))[:, 0]
    num_bin, default_bin = sc(pred.num_bin), sc(pred.default_bin)
    fbin = decode_bin(fcol, sc(pred.identity, torch.bool), sc(pred.offset),
                      num_bin, default_bin)
    mt = sc(pred.missing_type)
    miss = ((mt == MISSING_NAN) & (fbin == num_bin - 1)) | \
           ((mt == MISSING_ZERO) & (fbin == default_bin))
    gl_num = torch.where(miss, sc(pred.default_left, torch.bool),
                         fbin <= sc(pred.threshold))
    bitset = torch.as_tensor(pred.bitset, device=dev).to(torch.bool)
    inside = (fbin >= 0) & (fbin < bitset.shape[0])
    gl_cat = inside & bitset[fbin.clamp(0, bitset.shape[0] - 1).long()]
    return torch.where(sc(pred.is_cat, torch.bool), gl_cat, gl_num)


def partition_segment_stage(payload: torch.Tensor, aux: torch.Tensor, start,
                            count, pred: SplitPredicate):
    """The first half of the stable partition: the rows of
    [start, start+count), left rows first, into aux over the same range.
    payload is only read, so the frontier-batched grower can stage a
    candidate split and copy it back (`partition_segment_commit`) only if
    it commits.  Unlike the JAX version, nothing is written past the
    segment, so segments may be staged in any order.  Returns
    (aux, num_left), num_left a 0-d int32 tensor."""
    inside = segment_rows(payload.shape[0], start, count, payload.device)
    rows = payload[inside]
    gl = go_left_chunk(rows, pred)
    # a stable sort of the right-side flags: left rows first, each side in
    # row order
    order = torch.sort((~gl).to(torch.uint8), stable=True).indices
    aux[inside] = rows[order]
    return aux, gl.sum(dtype=torch.int32)


def partition_segment_commit(payload: torch.Tensor, aux: torch.Tensor, start,
                             count, num_left, left_value, right_value,
                             value_col: int) -> torch.Tensor:
    """The second half: copy aux[start, start+count) back into payload,
    writing the children's creation values (left_value for the first
    num_left rows, right_value after them) into `value_col`.  count = 0 is
    a no-op (a staged candidate that did not commit).  Returns payload,
    updated in place."""
    dev = payload.device
    n = payload.shape[0]
    inside = segment_rows(n, start, count, dev)
    nl = torch.minimum(scalar(num_left, torch.int64, dev),
                       scalar(count, torch.int64, dev))
    left = segment_rows(n, start, nl, dev)
    payload[inside] = aux[inside]
    col = payload[:, value_col]
    col.copy_(torch.where(left, scalar(left_value, payload.dtype, dev),
                          torch.where(inside & ~left,
                                      scalar(right_value, payload.dtype,
                                              dev), col)))
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
    dev = payload.device
    rows = payload[segment_rows(payload.shape[0], start, count, dev)]
    c = rows.shape[0]
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


#: the fixed-point sums of the card's f32 histograms stay below 2^62 in
#: magnitude (int64 cells, with room for the rounding of each value)
FIXED_SUM_BITS = 62
#: the fixed-point exponents are clamped to [-FIXED_MAX_EXP, FIXED_MAX_EXP],
#: so 2^s and 2^-s are normal f32 (kFixedMaxExp of csrc/segment_hist.cuh)
FIXED_MAX_EXP = 126


def fixed_exponents(amax: torch.Tensor, rows) -> torch.Tensor:
    """int32 [2] fixed-point exponents s (grad, hess) for values of
    magnitude at most amax ([2] f32) summed over at most `rows` rows (a
    host integer or a 0-d tensor): as large as keeps rows * amax * 2^s
    below 2^FIXED_SUM_BITS, so no sum of rint(v * 2^s) overflows an int64.
    Computed on amax's device with no host read, and for a host `rows`
    with no copy to the device."""
    # amax < 2^e and rows < 2^r (frexp's mantissa lies in [0.5, 1))
    e = torch.frexp(amax.to(torch.float64)).exponent
    if isinstance(rows, torch.Tensor):
        r = torch.frexp(rows.to(device=amax.device,
                                dtype=torch.float64)).exponent
    else:
        r = math.frexp(float(rows))[1]
    return (FIXED_SUM_BITS - r - e).clamp(-FIXED_MAX_EXP, FIXED_MAX_EXP) \
        .to(torch.int32)


def fixed_scale(payload: torch.Tensor, starts, counts, grad_col: int,
                hess_col: int) -> torch.Tensor:
    """The fixed-point exponents (`fixed_exponents`) for the rows of the
    segments [starts[k], starts[k] + counts[k]): their largest |grad| and
    |hess|, and their total count as the row bound.  starts / counts are
    scalars or 1-D, host values or device tensors; no host read."""
    dev = payload.device
    n = payload.shape[0]
    st = torch.as_tensor(starts, device=dev).reshape(-1, 1).to(torch.int64)
    ct = torch.as_tensor(counts, device=dev).reshape(-1, 1).to(torch.int64)
    idx = torch.arange(n, device=dev)[None, :]
    inside = ((idx >= st) & (idx < st + ct)).any(dim=0)
    vals = payload[:, [grad_col, hess_col]].abs()
    amax = torch.where(inside[:, None], vals, torch.zeros_like(vals)) \
        .amax(dim=0)
    return fixed_exponents(amax, ct.sum())


def to_fixed(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """rint(v * 2^s) as int64, for f32 v and int32 exponents s: the f32
    product (exact, a power of two) rounded half to even, as the card's
    __float2ll_rn(__fmul_rn(v, 2^s))."""
    scale = torch.ldexp(torch.ones_like(s, dtype=torch.float32), s)
    return torch.round(v.to(torch.float32) * scale).to(torch.int64)


def fixed_sums(payload: torch.Tensor, start, count, *, num_features: int,
               num_bins: int, grad_col: int, hess_col: int, cnt_col: int,
               scale) -> tuple:
    """The exact integer sums behind `segment_histogram_fixed`: int64
    [F * B, 2] of rint(v * 2^s) per (feature, bin) for grad and hess, and
    int32 [F * B] of the rounded count mask.  Sums over disjoint row
    ranges add up exactly, so a large segment may be summed in parts."""
    F, B = num_features, num_bins
    dev = payload.device
    scale = torch.as_tensor(scale, device=dev).to(torch.int32).reshape(2)
    rows = payload[segment_rows(payload.shape[0], start, count, dev)]
    c = rows.shape[0]
    cell = (rows[:, :F].to(torch.int64)
            + torch.arange(F, dtype=torch.int64, device=dev)[None, :] * B) \
        .reshape(-1)
    q = to_fixed(rows[:, [grad_col, hess_col]], scale[None, :])    # [c, 2]
    n = torch.round(rows[:, cnt_col]).to(torch.int32)              # [c]
    gh = torch.zeros(F * B, 2, dtype=torch.int64, device=dev)
    gh.index_add_(0, cell, q[:, None, :].expand(c, F, 2).reshape(-1, 2))
    cnt = torch.zeros(F * B, dtype=torch.int32, device=dev)
    cnt.index_add_(0, cell, n[:, None].expand(c, F).reshape(-1))
    return gh, cnt


def fixed_hist(gh: torch.Tensor, cnt: torch.Tensor, scale, num_features: int,
               num_bins: int) -> torch.Tensor:
    """f32 hist[F, B, 3] from `fixed_sums`' integers: each sum times 2^-s
    rounded once to f32 (int64 -> f32 rounds to nearest, and the power of
    two is exact), the count converted."""
    scale = torch.as_tensor(scale, device=gh.device).to(torch.int32) \
        .reshape(2)
    inv = torch.ldexp(torch.ones(2, dtype=torch.float32, device=gh.device),
                      -scale)
    out = torch.stack([gh[:, 0].to(torch.float32) * inv[0],
                       gh[:, 1].to(torch.float32) * inv[1],
                       cnt.to(torch.float32)], dim=1)
    return out.reshape(num_features, num_bins, 3)


def fixed_cells(payload: torch.Tensor, start, count, *, num_features: int,
                num_bins: int, grad_col: int, hess_col: int, cnt_col: int,
                scale) -> torch.Tensor:
    """int64 [F, B, 3]: `fixed_sums`' integers in one tensor per cell
    (grad, hess, count), the raw output of B1 and B7.  Cells of disjoint
    row sets (the ranks' row blocks) add up exactly; `cells_to_hist`
    converts a sum once.  scale: by default `fixed_scale` of the segment."""
    if scale is None:
        scale = fixed_scale(payload, start, count, grad_col, hess_col)
    gh, cnt = fixed_sums(payload, start, count, num_features=num_features,
                         num_bins=num_bins, grad_col=grad_col,
                         hess_col=hess_col, cnt_col=cnt_col, scale=scale)
    return torch.cat([gh, cnt.to(torch.int64)[:, None]], dim=1) \
        .reshape(num_features, num_bins, 3)


def cells_to_hist(cells: torch.Tensor, scale) -> torch.Tensor:
    """f32 [..., 3] histogram of int64 [..., 3] fixed-point cells: each sum
    times 2^-s rounded once to f32, the count converted (the card's
    conversion, csrc/segment_hist.cuh convert_fixed; `fixed_hist`)."""
    scale = torch.as_tensor(scale, device=cells.device).to(torch.int32) \
        .reshape(2)
    inv = torch.ldexp(torch.ones(2, dtype=torch.float32,
                                 device=cells.device), -scale)
    return torch.stack([cells[..., 0].to(torch.float32) * inv[0],
                        cells[..., 1].to(torch.float32) * inv[1],
                        cells[..., 2].to(torch.float32)], dim=-1)


def segment_histogram_fixed(payload: torch.Tensor, start, count, *,
                            num_features: int, num_bins: int, grad_col: int,
                            hess_col: int, cnt_col: int,
                            scale=None) -> torch.Tensor:
    """The f32 hist[F, B, 3] of the card's order-free kernels (B1, B5 f32,
    B6 and B7, csrc/segment_hist.cuh): each grad / hess value rounded to a
    multiple of 2^-s (`to_fixed`), the rows' integers summed exactly in
    int64 and the sum times 2^-s rounded once to f32; each count-mask value
    rounded to int32 and summed exactly.  scale: the int32 [2] exponents
    (grad, hess), by default `fixed_scale` of this segment.  Integer sums do
    not depend on order, so the kernels agree with this bit for bit."""
    if scale is None:
        scale = fixed_scale(payload, start, count, grad_col, hess_col)
    gh, cnt = fixed_sums(payload, start, count, num_features=num_features,
                         num_bins=num_bins, grad_col=grad_col,
                         hess_col=hess_col, cnt_col=cnt_col, scale=scale)
    return fixed_hist(gh, cnt, scale, num_features, num_bins)


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
    hist_left = segment_histogram(payload, start, num_left, **hk)
    hist_right = segment_histogram(payload, num_left + start,
                                   count - num_left, **hk)
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
    starts = torch.as_tensor(starts).reshape(-1)
    counts = torch.as_tensor(counts).reshape(-1)
    if len(starts) != len(counts):
        raise ValueError("starts and counts differ in length: %d vs %d"
                         % (len(starts), len(counts)))
    if not len(starts):
        return torch.zeros((0, num_features, num_bins, 3),
                           dtype=torch.int32 if quantized else torch.float32,
                           device=payload.device)
    return torch.stack([segment_histogram(payload, s, c, **kw)
                        for s, c in zip(starts, counts)])
