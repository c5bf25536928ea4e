"""The port's segment engine (lightgbm_tpu_torch.ops.segment and the CPU
path of ops.cuda_segment) against the JAX package's portable engine and
its Pallas kernels in interpret mode, on the same numpy inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lightgbm_tpu.ops import bundle as jbundle
from lightgbm_tpu.ops import pallas_segment as pseg
from lightgbm_tpu.ops import segment as jseg
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.ops import bundle as tbundle
from lightgbm_tpu_torch.ops import cuda_segment
from lightgbm_tpu_torch.ops import segment as tseg

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

F, B = 5, 16
COLS = dict(grad_col=F, hess_col=F + 1, cnt_col=F + 2)
VALUE_COL = F + 3
P = F + 4

# the segments of tests/test_pallas_segment.py:30-32
HIST_SEGMENTS = [(0, 1000), (256, 700), (100, 37), (0, 0), (513, 256),
                 (7, 1), (9, 1015), (1023, 1)]

# the routing cases of tests/test_pallas_segment.py:114-127
PARTITION_CASES = [
    (0, 1000, {}),
    (256, 700, dict(feature=3, threshold=4)),
    (100, 37, dict(missing_type=2, default_left=True, threshold=3)),
    (0, 600, dict(is_cat=True, bitset=(np.arange(B) % 3 == 0))),
    (513, 256, dict(feature=0, threshold=0)),
    (7, 1, {}),
    (9, 1015, dict(feature=2, threshold=B // 3)),
    (255, 513, dict(feature=4, threshold=1)),
    (64, 500, dict(feature=2, threshold=3, offset=5, identity=False,
                   num_bin=9, default_bin=0)),
    (30, 900, dict(feature=1, threshold=6, missing_type=1, default_bin=4,
                   default_left=True)),
]


def _payload(n_pad, seed=0):
    rng = np.random.default_rng(seed)
    pay = np.zeros((n_pad + jseg.GUARD, P), np.float32)
    pay[:n_pad, :F] = rng.integers(0, B, size=(n_pad, F))
    pay[:n_pad, F] = rng.standard_normal(n_pad)
    pay[:n_pad, F + 1] = rng.random(n_pad)
    pay[:n_pad, F + 2] = 1.0
    return pay


def _pred_fields(feature=1, threshold=B // 2, default_left=False,
                 is_cat=False, bitset=None, missing_type=0, num_bin=B,
                 default_bin=0, offset=0, identity=True):
    return dict(col=np.int32(feature), threshold=np.int32(threshold),
                default_left=np.bool_(default_left), is_cat=np.bool_(is_cat),
                bitset=np.asarray(bitset if bitset is not None
                                  else np.zeros(B, bool)),
                missing_type=np.int32(missing_type),
                num_bin=np.int32(num_bin), default_bin=np.int32(default_bin),
                offset=np.int32(offset), identity=np.bool_(identity))


def _jax_pred(fields):
    return jseg.SplitPredicate(**{k: jnp.asarray(v) for k, v in
                                  fields.items()})


def test_layout_constants_match():
    assert tseg.CHUNK == jseg.CHUNK
    assert tseg.GUARD == jseg.GUARD


@pytest.mark.parametrize("start,count", HIST_SEGMENTS)
def test_histogram_matches_portable(start, count):
    pay = _payload(1024)
    ref = np.asarray(jseg.segment_histogram(
        jnp.asarray(pay), jnp.int32(start), jnp.int32(count),
        num_features=F, num_bins=B, **COLS))
    got = tseg.segment_histogram(convert.payload_from_numpy(pay), start,
                                 count, num_features=F, num_bins=B,
                                 **COLS).numpy()
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("start,count", [(0, 1000), (100, 37), (0, 0),
                                         (9, 1015)])
def test_histogram_matches_pallas_interpret(start, count):
    pay = _payload(1024, seed=3)
    ref = np.asarray(pseg.segment_histogram(
        jnp.asarray(pay), jnp.int32(start), jnp.int32(count),
        num_features=F, num_bins=B, interpret=True, **COLS))
    got = tseg.segment_histogram(convert.payload_from_numpy(pay), start,
                                 count, num_features=F, num_bins=B,
                                 **COLS).numpy()
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_histogram_wrapper_runs_plain_version_on_cpu():
    pay = convert.payload_from_numpy(_payload(1024, seed=4))
    before = cuda_segment.segment_histogram.launches
    got = cuda_segment.segment_histogram(
        pay, torch.tensor(9, dtype=torch.int32),
        torch.tensor(1015, dtype=torch.int32), num_features=F, num_bins=B,
        **COLS)
    ref = tseg.segment_histogram(pay, 9, 1015, num_features=F, num_bins=B,
                                 **COLS)
    assert torch.equal(got, ref)
    assert cuda_segment.segment_histogram.launches == before


@pytest.mark.parametrize("start,count,predkw", PARTITION_CASES)
def test_partition_matches_portable(start, count, predkw):
    pay = _payload(1024, seed=start + count)
    fields = _pred_fields(**predkw)
    lv, rv = np.float32(-0.25), np.float32(0.75)
    ref_pay, ref_aux, ref_nl = jseg.partition_segment(
        jnp.asarray(pay), jnp.zeros_like(jnp.asarray(pay)), jnp.int32(start),
        jnp.int32(count), _jax_pred(fields), jnp.float32(lv),
        jnp.float32(rv), VALUE_COL)
    got_pay, got_aux, got_nl = tseg.partition_segment(
        convert.payload_from_numpy(pay), torch.zeros(pay.shape),
        start, count, convert.split_predicate_from_numpy(fields),
        torch.tensor(lv), torch.tensor(rv), VALUE_COL)
    assert int(got_nl) == int(ref_nl)
    np.testing.assert_array_equal(convert.payload_to_numpy(got_pay),
                                  np.asarray(ref_pay))
    # inside the segment aux holds the partitioned rows in both packages
    np.testing.assert_array_equal(
        got_aux.numpy()[start:start + count],
        np.asarray(ref_aux)[start:start + count])


@pytest.mark.parametrize("start,count,predkw", PARTITION_CASES)
def test_partition_matches_pallas_acc_interpret(start, count, predkw):
    pay = _payload(1024, seed=start + count)
    fields = _pred_fields(**predkw)
    ref_pay, _, ref_nl = pseg.partition_segment_acc(
        jnp.asarray(pay), jnp.zeros_like(jnp.asarray(pay)), jnp.int32(start),
        jnp.int32(count), _jax_pred(fields), jnp.float32(-0.25),
        jnp.float32(0.75), VALUE_COL, B, interpret=True)
    got_pay, _, got_nl = cuda_segment.partition_segment(
        convert.payload_from_numpy(pay), torch.zeros(pay.shape), start,
        count, convert.split_predicate_from_numpy(fields),
        torch.tensor(-0.25), torch.tensor(0.75), VALUE_COL)
    assert int(got_nl) == int(ref_nl)
    np.testing.assert_array_equal(got_pay.numpy(), np.asarray(ref_pay))


@pytest.mark.parametrize("start,count", [(0, 1024), (7, 777), (100, 1),
                                         (256, 512), (513, 511)])
@pytest.mark.parametrize("skew", ["all_left", "all_right"])
def test_partition_skewed(start, count, skew):
    """One-sided splits (tests/test_pallas_segment.py:155-157)."""
    pay = _payload(1024, seed=count)
    fields = _pred_fields(threshold=(B if skew == "all_left" else -1))
    ref_pay, _, ref_nl = jseg.partition_segment(
        jnp.asarray(pay), jnp.zeros_like(jnp.asarray(pay)), jnp.int32(start),
        jnp.int32(count), _jax_pred(fields), jnp.float32(1.5),
        jnp.float32(-2.5), VALUE_COL)
    got_pay, _, got_nl = cuda_segment.partition_segment(
        convert.payload_from_numpy(pay), torch.zeros(pay.shape), start,
        count, convert.split_predicate_from_numpy(fields),
        torch.tensor(1.5), torch.tensor(-2.5), VALUE_COL)
    assert int(got_nl) == int(ref_nl) == (count if skew == "all_left" else 0)
    np.testing.assert_array_equal(got_pay.numpy(), np.asarray(ref_pay))
    acc_pay, _, acc_nl = pseg.partition_segment_acc(
        jnp.asarray(pay), jnp.zeros_like(jnp.asarray(pay)), jnp.int32(start),
        jnp.int32(count), _jax_pred(fields), jnp.float32(1.5),
        jnp.float32(-2.5), VALUE_COL, B, interpret=True)
    assert int(acc_nl) == int(got_nl)
    np.testing.assert_array_equal(got_pay.numpy(), np.asarray(acc_pay))


@pytest.mark.parametrize("predkw", [c[2] for c in PARTITION_CASES])
def test_go_left_chunk_matches(predkw):
    chunk = _payload(300, seed=11)[:300]
    fields = _pred_fields(**predkw)
    ref = np.asarray(jseg.go_left_chunk(jnp.asarray(chunk),
                                        _jax_pred(fields)))
    got = tseg.go_left_chunk(torch.from_numpy(chunk),
                             convert.split_predicate_from_numpy(fields))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("identity,offset,num_bin,default_bin",
                         [(True, 0, 16, 0), (False, 5, 9, 0),
                          (False, 3, 7, 2), (False, 0, 4, 3)])
def test_decode_bin_matches(identity, offset, num_bin, default_bin):
    v = np.arange(-2, 20, dtype=np.float32)
    ref = np.asarray(jbundle.decode_bin(jnp.asarray(v), identity, offset,
                                        num_bin, default_bin))
    got = tbundle.decode_bin(torch.from_numpy(v), identity, offset, num_bin,
                             default_bin)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("op", ["set", "add", "mul"])
def test_payload_col_write_matches(op):
    pay = _payload(64, seed=2)
    vec = np.linspace(-1, 1, pay.shape[0]).astype(np.float32)
    ref = np.asarray(jseg.payload_col_write(jnp.asarray(pay), VALUE_COL,
                                            jnp.asarray(vec), op))
    got = tseg.payload_col_write(torch.from_numpy(pay.copy()), VALUE_COL,
                                 torch.from_numpy(vec), op)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA device is refused, never
    routed to the plain version."""
    pay = torch.zeros((300, P), device="meta")
    with pytest.raises(ValueError):
        cuda_segment.segment_histogram(pay, 0, 10, num_features=F,
                                       num_bins=B, **COLS)
    pred = convert.split_predicate_from_numpy(_pred_fields())
    with pytest.raises(ValueError):
        cuda_segment.partition_segment(pay, pay, 0, 10, pred, 0.0, 1.0,
                                       VALUE_COL)


# -- quantized, batched, stage/commit ------------------------------------

def _qpayload(n_pad, qmax, seed=0):
    """A payload whose grad/hess columns hold quantized (integer-valued)
    gradients on the grid of half-range qmax, with a 0/1 count mask."""
    pay = _payload(n_pad, seed)
    rng = np.random.default_rng(seed + 50)
    mask = (rng.random(n_pad) < 0.9).astype(np.float32)
    pay[:n_pad, F] = rng.integers(-qmax, qmax + 1, size=n_pad) * mask
    pay[:n_pad, F + 1] = rng.integers(0, qmax + 1, size=n_pad) * mask
    pay[:n_pad, F + 2] = mask
    return pay


@pytest.mark.parametrize("qmax", [127, 2114])
@pytest.mark.parametrize("start,count", HIST_SEGMENTS)
def test_quant_histogram_matches_portable(start, count, qmax):
    pay = _qpayload(1024, qmax, seed=start)
    ref = np.asarray(jseg.segment_histogram(
        jnp.asarray(pay), jnp.int32(start), jnp.int32(count),
        num_features=F, num_bins=B, quantized=True, **COLS))
    got = cuda_segment.segment_histogram_quant(
        convert.payload_from_numpy(pay), torch.tensor(start),
        torch.tensor(count), num_features=F, num_bins=B, **COLS)
    assert got.dtype == torch.int32 and ref.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("start,count", [(0, 1000), (100, 37), (0, 0),
                                         (9, 1015)])
def test_quant_histogram_matches_pallas_interpret(start, count):
    pay = _qpayload(1024, 127, seed=7)
    ref = np.asarray(pseg.segment_histogram_quant(
        jnp.asarray(pay), jnp.int32(start), jnp.int32(count),
        num_features=F, num_bins=B, interpret=True, **COLS))
    got = tseg.segment_histogram(convert.payload_from_numpy(pay), start,
                                 count, num_features=F, num_bins=B,
                                 quantized=True, **COLS)
    np.testing.assert_array_equal(got.numpy(), ref)


# K disjoint segments of uneven sizes, one empty and one of a single row
BATCH_STARTS = np.array([0, 300, 301, 520, 900, 640, 1000], np.int32)
BATCH_COUNTS = np.array([300, 1, 0, 120, 124, 260, 23], np.int32)


def test_batched_histogram_matches_portable_and_pallas():
    pay = _payload(1024, seed=9)
    args = (jnp.asarray(pay), jnp.asarray(BATCH_STARTS),
            jnp.asarray(BATCH_COUNTS))
    ref = np.asarray(jseg.segment_histogram_batched(
        *args, num_features=F, num_bins=B, **COLS))
    ref_pl = np.asarray(pseg.segment_histogram_batched(
        *args, num_features=F, num_bins=B, interpret=True, **COLS))
    got = cuda_segment.segment_histogram_batched(
        convert.payload_from_numpy(pay), torch.from_numpy(BATCH_STARTS),
        torch.from_numpy(BATCH_COUNTS), num_features=F, num_bins=B,
        **COLS).numpy()
    assert got.shape == (len(BATCH_STARTS), F, B, 3)
    for r in (ref, ref_pl):
        np.testing.assert_array_equal(got[..., 2], r[..., 2])
        np.testing.assert_allclose(got, r, rtol=1e-5, atol=1e-5)
    assert not got[2].any()
    # each slice is the single-segment histogram, bit for bit
    for k, (s, c) in enumerate(zip(BATCH_STARTS, BATCH_COUNTS)):
        one = tseg.segment_histogram(convert.payload_from_numpy(pay), s, c,
                                     num_features=F, num_bins=B, **COLS)
        np.testing.assert_array_equal(got[k], one.numpy())


def test_batched_quant_histogram_matches_portable():
    pay = _qpayload(1024, 2114, seed=10)
    ref = np.asarray(jseg.segment_histogram_batched(
        jnp.asarray(pay), jnp.asarray(BATCH_STARTS),
        jnp.asarray(BATCH_COUNTS), num_features=F, num_bins=B,
        quantized=True, **COLS))
    got = cuda_segment.segment_histogram_batched(
        convert.payload_from_numpy(pay), torch.from_numpy(BATCH_STARTS),
        torch.from_numpy(BATCH_COUNTS), num_features=F, num_bins=B,
        quantized=True, **COLS)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("start,count,predkw", PARTITION_CASES)
def test_stage_commit_match_jax(start, count, predkw):
    pay = _payload(1024, seed=start + count + 1)
    fields = _pred_fields(**predkw)
    jaux, jnl = jseg.partition_segment_stage(
        jnp.asarray(pay), jnp.zeros_like(jnp.asarray(pay)), jnp.int32(start),
        jnp.int32(count), _jax_pred(fields))
    jpay = jseg.partition_segment_commit(
        jnp.asarray(pay), jaux, jnp.int32(start), jnp.int32(count), jnl,
        jnp.float32(-0.25), jnp.float32(0.75), VALUE_COL)
    tpay = convert.payload_from_numpy(pay)
    nl_vec = torch.full((3,), -1, dtype=torch.int32)
    taux, tnl = cuda_segment.partition_segment_stage(
        tpay, torch.zeros(pay.shape), start, count,
        convert.split_predicate_from_numpy(fields), nl_vec, 1)
    # the stage only reads the payload, and fills only its own slot
    assert tpay.numpy().tobytes() == pay.tobytes()
    assert int(tnl) == int(jnl) and nl_vec.tolist() == [-1, int(jnl), -1]
    # aux is compared inside the segment: the JAX stage overruns past it
    np.testing.assert_array_equal(taux.numpy()[start:start + count],
                                  np.asarray(jaux)[start:start + count])
    tpay = cuda_segment.partition_segment_commit(
        tpay, taux, start, count, tnl, torch.tensor(-0.25),
        torch.tensor(0.75), VALUE_COL)
    assert tpay.numpy().tobytes() == np.asarray(jpay).tobytes()
    # and stage + commit is the whole partition
    whole, _, nl = tseg.partition_segment(
        convert.payload_from_numpy(pay), torch.zeros(pay.shape), start,
        count, convert.split_predicate_from_numpy(fields),
        torch.tensor(-0.25), torch.tensor(0.75), VALUE_COL)
    assert int(nl) == int(jnl)
    assert torch.equal(whole, tpay)


def test_commit_count_zero_is_noop():
    pay = _payload(1024, seed=12)
    aux = torch.from_numpy(_payload(1024, seed=13))
    got = cuda_segment.partition_segment_commit(
        convert.payload_from_numpy(pay), aux, 100, 0, 37, 1.0, 2.0,
        VALUE_COL)
    assert got.numpy().tobytes() == pay.tobytes()
    ref = jseg.partition_segment_commit(
        jnp.asarray(pay), jnp.asarray(aux.numpy()), jnp.int32(100),
        jnp.int32(0), jnp.int32(37), jnp.float32(1.0), jnp.float32(2.0),
        VALUE_COL)
    assert np.asarray(ref).tobytes() == pay.tobytes()


def test_new_wrappers_run_plain_versions_on_cpu_and_refuse_meta():
    pay = convert.payload_from_numpy(_qpayload(1024, 127, seed=14))
    counters = [cuda_segment.segment_histogram_quant,
                cuda_segment.segment_histogram_batched,
                cuda_segment.partition_segment_stage,
                cuda_segment.partition_segment_commit]
    before = [c.launches for c in counters]
    pred = convert.split_predicate_from_numpy(_pred_fields())
    cuda_segment.segment_histogram_quant(pay, 0, 500, num_features=F,
                                         num_bins=B, **COLS)
    cuda_segment.segment_histogram_batched(pay, [0, 600], [500, 10],
                                           num_features=F, num_bins=B,
                                           quantized=True, **COLS)
    aux, nl = cuda_segment.partition_segment_stage(
        pay, torch.zeros_like(pay), 0, 500, pred)
    cuda_segment.partition_segment_commit(pay, aux, 0, 500, nl, 0.0, 1.0,
                                          VALUE_COL)
    assert [c.launches for c in counters] == before
    meta = torch.zeros((300, P), device="meta")
    with pytest.raises(ValueError):
        cuda_segment.segment_histogram_quant(meta, 0, 10, num_features=F,
                                             num_bins=B, **COLS)
    with pytest.raises(ValueError):
        cuda_segment.segment_histogram_batched(meta, [0], [10],
                                               num_features=F, num_bins=B,
                                               **COLS)
    with pytest.raises(ValueError):
        cuda_segment.partition_segment_stage(meta, meta, 0, 10, pred)
    with pytest.raises(ValueError):
        cuda_segment.partition_segment_commit(meta, meta, 0, 10, 5, 0.0, 1.0,
                                              VALUE_COL)
