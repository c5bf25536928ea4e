"""The kernel build cache of the PyTorch port (lightgbm_tpu_torch/runtime/
warmup.py, the compile-cache half of runtime/warmup.py): the fingerprint
(stable; keyed on the nvcc flags, the torch and CUDA versions, the card's
capability once CUDA is initialized, the host), the sweep past a budget,
and the build directory moved under the fingerprint with every kernel
build classified as a hit or a miss.  The CPU sandbox has no nvcc: a
stand-in writes the libraries."""
import os
import stat

import pytest
import torch

from lightgbm_tpu_torch.ops import build
from lightgbm_tpu_torch.runtime import telemetry, warmup

# one intra-op thread: the pytest-xdist workers share the cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    warmup._reset_for_tests()
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    yield
    warmup._reset_for_tests()


def _fake_nvcc(tmp_path):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n  if [ \"$1\" = -o ]; "
                    "then shift; echo built > \"$1\"; fi\n  shift\ndone\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_cache_fingerprint_stable_and_flag_sensitive(monkeypatch):
    fp1 = warmup.cache_fingerprint()
    assert fp1 == warmup.cache_fingerprint()
    assert fp1.startswith("torch") and "-cuda" in fp1
    # CUDA is not initialized here: the fingerprint must not initialize it
    assert "-uninit-" in fp1 and not torch.cuda.is_initialized()
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert warmup.cache_fingerprint() != fp1, (
        "changing the nvcc flags did not change the cache fingerprint: a "
        "library built with other flags could be loaded")


def test_cache_sweep_evicts_oldest_past_budget(tmp_path):
    cdir = warmup.enable_compile_cache(str(tmp_path), budget_mb=1)
    assert cdir and cdir.startswith(str(tmp_path))
    assert os.path.basename(cdir) == warmup.cache_fingerprint()
    assert str(build.BUILD_DIR) == cdir
    for i, name in enumerate(("a", "b", "c")):
        p = os.path.join(cdir, name)
        with open(p, "wb") as fh:
            fh.write(b"\0" * (600 * 1024))
        os.utime(p, (1000 + i, 1000 + i))
    c = telemetry.counter("lgbm_compile_cache_events_total")
    e0 = c.value(event="evict")
    assert warmup.sweep_cache(budget_mb=1) == 2
    assert sorted(os.listdir(cdir)) == ["c"]
    assert c.value(event="evict") == e0 + 2
    st = warmup.cache_status()
    assert st["evictions"] >= 2 and st["files"] == 1 and st["enabled"]


def test_builds_classified_hit_or_miss(tmp_path, monkeypatch):
    # written once: rewriting the script while an earlier build's shell
    # reads it can leave that build without its output
    nvcc = _fake_nvcc(tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: nvcc)
    cdir = warmup.enable_compile_cache(str(tmp_path / "cache"))
    assert warmup.enable_compile_cache(str(tmp_path / "cache")) == cdir
    c = telemetry.counter("lgbm_compile_cache_events_total")
    m0, h0 = c.value(event="miss"), c.value(event="hit")
    build.build_all(["segment_hist", "segment_partition"])
    assert sorted(os.listdir(cdir)) == sorted(
        build._target(n).name for n in ("segment_hist", "segment_partition"))
    build.build_all(["segment_hist"])
    assert c.value(event="miss") == m0 + 2 and c.value(event="hit") == h0 + 1
    st = warmup.cache_status()
    assert (st["misses"], st["hits"], st["files"]) == (2, 1, 2)


def test_maybe_enable_from_env(tmp_path, monkeypatch):
    monkeypatch.delenv(warmup.CACHE_ENV, raising=False)
    before = build.BUILD_DIR
    assert warmup.maybe_enable_from_env() is None
    assert build.BUILD_DIR == before and not warmup.cache_status()["enabled"]
    monkeypatch.setenv(warmup.CACHE_ENV, str(tmp_path))
    monkeypatch.setenv(warmup.CACHE_BUDGET_ENV, "7")
    cdir = warmup.maybe_enable_from_env()
    assert cdir == os.path.join(str(tmp_path), warmup.cache_fingerprint())
    assert warmup.cache_status()["budget_mb"] == 7
