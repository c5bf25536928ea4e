"""Per-iteration gradient/hessian quantization (Shi et al., NeurIPS 2022,
"Quantized Training of Gradient Boosting Decision Trees").

Counterpart of lightgbm_tpu/ops/quantize.py.  Once per (iteration,
class), after the count mask is applied, the f32 gradients and hessians
are scaled into an integer grid and stochastically rounded
(`quantize_pair`).  The integer-valued results live in the payload's
grad/hess columns (small integers are exact in f32), so the partition is
unchanged; histograms accumulate them into int32 (the `quantized=True`
engines of ops/segment.py and ops/cuda_segment.py), which is exact and
order-free, and the f32 view is taken only at the split search
(`ops.split.dequantize_hist`).

The grid half-range, the byte tables and the scales are integer- and
bit-identical to the JAX package's.  The uniform draws are not: they come
from a `torch.Generator`, which cannot reproduce `jax.random`, and a CPU
generator draws another stream than a CUDA one.  Quantized models are
therefore held to the f32 path (and across packages and devices) by
model quality, while reruns with one seed on one device are identical.
"""
from __future__ import annotations

import torch

#: integer grid half-range per requested packing width (the sign bit is
#: spent on the gradient's sign; hessians are non-negative, in [0, qmax])
QUANT_DTYPE_MAX = {"int8": 127, "int16": 32767}

#: bytes of gradient+hessian information per row fed to a histogram, per
#: packing width (f32: 4 + 4)
QUANT_GH_BYTES = {"int8": 2, "int16": 4}
F32_GH_BYTES = 8


def derive_qmax(n_rows: int, dtype: str) -> int:
    """Integer grid half-range for `dtype` at `n_rows`.

    Caps the requested width by the int32 accumulator's overflow bound
    (rows per leaf * max|q| < 2^31; the root leaf holds every row, so
    n_rows is the bound).  Raises when the grid left is too coarse to
    carry any gradient signal (< 2 levels per sign)."""
    if dtype not in QUANT_DTYPE_MAX:
        raise ValueError(
            "gradient_quant_dtype must be one of %s, got %r"
            % (sorted(QUANT_DTYPE_MAX), dtype))
    qmax = min(QUANT_DTYPE_MAX[dtype], (2 ** 31 - 1) // max(int(n_rows), 1))
    if qmax < 2:
        raise ValueError(
            "gradient_quantization: %d rows leave no int32 headroom for "
            "an integer histogram (rows * qmax must stay below 2^31)"
            % n_rows)
    return qmax


def quant_seed(seed: int, iteration: int, num_tree_per_iteration: int,
               k: int) -> int:
    """The stochastic-rounding seed of one (iteration, class): the JAX
    package's schedule (gbdt.GBDT._quant_seed), so no two trees share a
    rounding draw and reruns of one configuration quantize identically."""
    return (int(seed) + iteration * num_tree_per_iteration + k) & 0x7FFFFFFF


def stochastic_round(x: torch.Tensor, generator: torch.Generator, lo: float,
                     hi: float) -> torch.Tensor:
    """floor(x + u), u ~ U[0, 1): unbiased (E[floor(x + u)] = x), clipped
    to [lo, hi] (the clip only acts at the grid's edge).  Exact zero stays
    zero (u < 1), so masked-out rows keep contributing nothing."""
    u = torch.rand(x.shape, generator=generator, dtype=torch.float32,
                   device=x.device)
    return torch.clamp(torch.floor(x + u), lo, hi)


def quantize_pair(g: torch.Tensor, h: torch.Tensor,
                  generator: torch.Generator, qmax: float):
    """Quantize one class's (already masked) gradient/hessian vectors.

    Returns (qg, qh, qscale): integer-valued f32 vectors for the payload's
    grad/hess columns, and the [2] f32 scales (gradient, hessian) the
    split search dequantizes with.  Scales are the maxima over the rows
    divided by qmax (the paper's max-scaling); an all-zero vector gets
    scale 1, so the division is always finite.  Both scales are computed
    on the device, with no host read.  The gradient draws come first from
    `generator`, then the hessian draws."""
    gmax = torch.max(torch.abs(g))
    hmax = torch.max(h)
    gscale = torch.where(gmax > 0, gmax, torch.full_like(gmax, qmax)) / qmax
    hscale = torch.where(hmax > 0, hmax, torch.full_like(hmax, qmax)) / qmax
    qg = stochastic_round(g / gscale, generator, -qmax, qmax)
    qh = stochastic_round(h / hscale, generator, 0.0, qmax)
    return qg, qh, torch.stack([gscale, hscale])
