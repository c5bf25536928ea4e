"""The port's quantized-gradient pieces (lightgbm_tpu_torch.ops.quantize
and ops.split.dequantize_hist) against the JAX package's, on the same
numpy inputs.  The uniform draws of the two packages differ by design
(torch.Generator against jax.random), so the draws are checked for what
they must give (unbiased, exact on the grid, zero kept) and the
deterministic parts bit for bit."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lightgbm_tpu.ops import quantize as jq
from lightgbm_tpu.ops.split import dequantize_hist as jdequantize_hist
from lightgbm_tpu_torch.ops import quantize as tq
from lightgbm_tpu_torch.ops.split import dequantize_hist


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_tables_match():
    assert tq.QUANT_DTYPE_MAX == jq.QUANT_DTYPE_MAX
    assert tq.QUANT_GH_BYTES == jq.QUANT_GH_BYTES
    assert tq.F32_GH_BYTES == jq.F32_GH_BYTES


@pytest.mark.parametrize("dtype", ["int8", "int16"])
@pytest.mark.parametrize("rows", [1, 1000, 200_000, 1_015_808, 10_500_000,
                                  2 ** 30 - 1])
def test_derive_qmax_matches(dtype, rows):
    assert tq.derive_qmax(rows, dtype) == jq.derive_qmax(rows, dtype)


@pytest.mark.parametrize("rows,dtype", [(2 ** 30, "int16"), (2 ** 31, "int8"),
                                        (100, "int4")])
def test_derive_qmax_raises_as_jax(rows, dtype):
    with pytest.raises(ValueError) as jerr:
        jq.derive_qmax(rows, dtype)
    with pytest.raises(ValueError) as terr:
        tq.derive_qmax(rows, dtype)
    assert str(terr.value) == str(jerr.value)


def test_stochastic_round_unbiased():
    """E[floor(x + u)] = x (tests/test_quantized.py:27-38 for the port's
    generator)."""
    x = torch.linspace(-5.0, 5.0, 41, dtype=torch.float32)
    gen = _gen(0)
    reps = 4000
    acc = torch.zeros(41, dtype=torch.float64)
    for _ in range(reps):
        acc += tq.stochastic_round(x, gen, -127.0, 127.0).double()
    err = acc / reps - x.double()
    assert float(err.abs().max()) < 0.03, err


def test_stochastic_round_exact_on_grid_and_zero():
    x = torch.tensor([-127.0, -3.0, 0.0, 5.0, 127.0])
    for s in range(20):
        out = tq.stochastic_round(x, _gen(s), -127.0, 127.0)
        assert torch.equal(out, x)
    z = torch.zeros(10_000)
    assert not tq.stochastic_round(z, _gen(3), -127.0, 127.0).any()
    # the clip holds at the grid's edge
    edge = tq.stochastic_round(torch.full((1000,), 126.5), _gen(4), -127.0,
                               127.0)
    assert float(edge.max()) == 127.0 and float(edge.min()) == 126.0


@pytest.mark.parametrize("qmax", [127.0, 2114.0, 32767.0])
def test_quantize_pair_scales_match_jax(qmax):
    rng = np.random.default_rng(int(qmax))
    g = (rng.standard_normal(4096) * 0.7).astype(np.float32)
    h = rng.random(4096).astype(np.float32)
    g[::7] = 0.0
    h[::7] = 0.0
    _, _, jscale = jq.quantize_pair(jnp.asarray(g), jnp.asarray(h),
                                    jnp.int32(7), qmax)
    qg, qh, tscale = tq.quantize_pair(torch.from_numpy(g),
                                      torch.from_numpy(h), _gen(7), qmax)
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    qg, qh = qg.numpy(), qh.numpy()
    gs, hs = float(tscale[0]), float(tscale[1])
    assert np.all(qg == np.round(qg)) and np.all(np.abs(qg) <= qmax)
    assert np.all(qh == np.round(qh)) and np.all((qh >= 0) & (qh <= qmax))
    assert np.abs(qg * gs - g).max() <= gs * (1 + 1e-6)
    assert np.abs(qh * hs - h).max() <= hs * (1 + 1e-6)
    # exact zeros (the masked rows) stay zero
    assert not qg[::7].any() and not qh[::7].any()


def test_quantize_pair_zero_mass_safe():
    qg, qh, qscale = tq.quantize_pair(torch.zeros(64), torch.zeros(64),
                                      _gen(0), 127.0)
    _, _, jscale = jq.quantize_pair(jnp.zeros(64), jnp.zeros(64),
                                    jnp.int32(0), 127.0)
    np.testing.assert_array_equal(qscale.numpy(), np.asarray(jscale))
    assert not qg.any() and not qh.any()


def test_quantize_pair_reruns_identical():
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    h = torch.from_numpy(rng.random(1000).astype(np.float32))
    a = tq.quantize_pair(g, h, _gen(5), 127.0)
    b = tq.quantize_pair(g, h, _gen(5), 127.0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_quant_seed_schedule():
    """(seed + iter * trees_per_iter + k) & 0x7FFFFFFF, the JAX schedule
    (gbdt.py:1924-1930)."""
    assert tq.quant_seed(11, 3, 1, 0) == 14
    assert tq.quant_seed(5, 2, 3, 1) == 12
    assert tq.quant_seed(2 ** 31 - 1, 1, 1, 0) == 0


@pytest.mark.parametrize("shape", [(5, 16, 3), (2, 4, 8, 3)])
def test_dequantize_hist_bit_equal(shape):
    rng = np.random.default_rng(2)
    hist = rng.integers(-2 ** 20, 2 ** 20, size=shape).astype(np.int32)
    gs, hs = np.float32(0.0123457), np.float32(3.3e-4)
    ref = np.asarray(jdequantize_hist(jnp.asarray(hist), jnp.float32(gs),
                                      jnp.float32(hs)))
    got = dequantize_hist(torch.from_numpy(hist), torch.tensor(gs),
                          torch.tensor(hs)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
