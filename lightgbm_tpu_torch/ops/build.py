"""Build and load the hand-written CUDA kernels.

Each source in lightgbm_tpu_torch/csrc/ is compiled by its own `nvcc` into
a shared library with a plain C interface (no PyTorch headers, so a build
takes seconds) and loaded with ctypes.  Builds go into build/kernels/
beside the package, keyed by a hash of the source and the csrc headers,
and happen at first use; `build_all` starts one nvcc per source at once,
so the build takes as long as the slowest source.  Each source's nvcc run
is a build of site ``build.<source>`` in the program ledger
(runtime/graph_obs.py), and a library found already built a cache hit
there.  `runtime/warmup.py` can point BUILD_DIR at a fingerprinted cache
directory.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

from ..runtime import graph_obs

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
SOURCES = ("segment_hist", "segment_partition", "segment_hist_colblock",
           "segment_partition_wide", "segment_partition_hist")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    # the headers count too: a source that includes one is rebuilt when
    # it changes
    text = b"".join(p.read_bytes() for p in [CSRC / (name + ".cu")]
                    + sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()[:16]
    return BUILD_DIR / ("lib%s_%s.so" % (name, digest))


def build_all(names: Sequence[str] = SOURCES) -> Tuple[float, Dict[str, str]]:
    """Compile every listed source that has no current build, one nvcc per
    source, all started together.  Returns the wall seconds spent and the
    compiler output (ptxas register / shared-memory report) per source
    built.  Each library is written under a temporary name and renamed, so
    a concurrent process never loads a half-written one."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = []
    for name in names:
        if _target(name).exists():
            graph_obs.build_event(name, "hit")
            continue
        tmp = _target(name).with_suffix(".so.tmp%d" % os.getpid())
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / (name + ".cu"))]
        started.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    # wait for every nvcc before raising, so none outlives a failed build
    logs = {name: proc.communicate()[0] for name, _, proc in started}
    wall = time.perf_counter() - t0
    for name, tmp, proc in started:
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s.cu:\n%s" % (name, logs[name]))
        os.replace(tmp, _target(name))
        # the builds run side by side: each is billed the whole wait
        graph_obs.build_event(name, "miss", wall,
                              (_target(name).name, *NVCC_FLAGS[:2]))
    return time.perf_counter() - t0, logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    if name not in _libs:
        build_all([name])
        _libs[name] = ctypes.CDLL(str(_target(name)))
    return _libs[name]
