"""The port's serving policies (lightgbm_tpu_torch/runtime/policy.py)
against the JAX package's (lightgbm_tpu/runtime/policy.py): fed the same
seeded observation streams, `AutoscaleShedPolicy`, `FleetScalePolicy` and
`CanaryPolicy` give the same decision sequences and end in the same
state."""
import numpy as np
import pytest

from lightgbm_tpu.runtime import policy as jpolicy
from lightgbm_tpu_torch.runtime import policy


def _clean(decisions):
    return [{k: v for k, v in d.items() if k != "wallclock"}
            for d in decisions]


def _walk(seed: int, n: int, lo: float = 0.0, hi: float = 1.0):
    """A seeded depth signal with sustained pressure, slack and a
    deadband oscillation."""
    rng = np.random.default_rng(seed)
    level = rng.uniform(lo, hi)
    out = []
    for i in range(n):
        if i % 40 == 0:
            level = rng.choice([0.05, 0.45, 0.9, rng.uniform(lo, hi)])
        out.append(float(np.clip(level + rng.normal(0, 0.08), 0.0, 1.0)))
    return out


@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (1, dict(patience=1)),
    (2, dict(high_watermark=0.6, low_watermark=0.3, widen_factor=1.5,
             max_window_s=0.05)),
])
def test_autoscale_shed_decisions_match_jax(seed, kw):
    mine, theirs = policy.AutoscaleShedPolicy(**kw), \
        jpolicy.AutoscaleShedPolicy(**kw)
    got, want = [], []
    for i, d in enumerate(_walk(seed, 400)):
        if i == 150:
            got += mine.allow_shed(False)
            want += theirs.allow_shed(False)
        if i == 260:
            got += mine.allow_shed(True)
            want += theirs.allow_shed(True)
        got += mine.observe(d)
        want += theirs.observe(d)
    assert _clean(got) == _clean(want)
    # the stream drives the controller through several transitions
    assert len({a["action"] for a in got}) >= 2
    assert mine.state() == theirs.state()


@pytest.mark.parametrize("seed,kw", [
    (3, {}),
    (4, dict(min_replicas=2, max_replicas=3, patience=2,
             scale_down_patience=5, slo_p99_s=0.2)),
])
def test_fleet_scale_decisions_match_jax(seed, kw):
    mine, theirs = policy.FleetScalePolicy(**kw), \
        jpolicy.FleetScalePolicy(**kw)
    rng = np.random.default_rng(seed)
    got, want = [], []
    for d in _walk(seed, 400):
        p99 = None if rng.random() < 0.1 else float(rng.gamma(2.0, 0.15))
        got += mine.observe(d, p99)
        want += theirs.observe(d, p99)
    assert _clean(got) == _clean(want)
    assert len({a["action"] for a in got}) >= 2
    assert mine.state() == theirs.state()


@pytest.mark.parametrize("seed,canary_err,canary_lat", [
    (5, 0.10, 1.0),      # healthy: promote
    (6, 0.35, 1.0),      # error regression: rollback
    (7, 0.10, 8.0),      # latency regression: rollback
    (8, 0.16, 1.0),      # near the bound: streaks reset
])
def test_canary_decisions_match_jax(seed, canary_err, canary_lat):
    kw = dict(min_samples=4, patience=3, promote_after=40, window=16)
    mine, theirs = policy.CanaryPolicy(**kw), jpolicy.CanaryPolicy(**kw)
    assert _clean([mine.note_start(9)]) == _clean([theirs.note_start(9)])
    rng = np.random.default_rng(seed)
    got, want = [], []
    for i in range(200):
        kind = "canary" if rng.random() < 0.3 else "incumbent"
        base_e, base_l = (canary_err, canary_lat) if kind == "canary" \
            else (0.1, 1.0)
        err = None if rng.random() < 0.2 else \
            float(abs(rng.normal(base_e, 0.03)))
        lat = float(abs(rng.normal(base_l, 0.2))) * 1e-3
        got += mine.observe(kind, error=err, latency_s=lat)
        want += theirs.observe(kind, error=err, latency_s=lat)
    assert _clean(got) == _clean(want)
    assert len(got) == 1 and mine.decided == theirs.decided
    assert _clean([mine.state()]) == _clean([theirs.state()])
    with pytest.raises(ValueError):
        mine.observe("shadow")
