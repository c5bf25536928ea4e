"""Variants of the B3 and B7 kernels, timed on one GPU beside the tree's own.

    python3 chip_variants.py [--seed N]

Each variant is the tree's source (lightgbm_tpu_torch/csrc) with a few
text patches, built by its own nvcc under build/variants/ (all at once),
loaded in place of the tree's library and driven through the port's
wrapper (lightgbm_tpu_torch.ops.cuda_segment), so the launch is the one
training makes.
  - B3 (partition_segment_rmw): threads per move block x staging bytes
    per buffer, at P = 513, 978 and 1664 on 1,015,808 rows (fresh rows, the
    numerical split of chip_smoke.py, ~40 % left), with each kernel's
    device time; every variant is first held to the plain partition.
  - B7 (segment_histogram_colblock): the tree's kernel, whose lanes find
    equal bins by one ballot per bit of the bin; the same with
    __match_any_sync, and with __match_any_sync for one of a warp's two
    features; for reference, the cells added with shared-memory atomics
    (a compare-and-swap loop for grad and hess, a native add for the
    count) and no groups (all held to the plain histogram); and timing
    probes that are not right and are not checked: staging alone (no
    accumulation) and the accumulation without the equal-bin groups
    (every lane its own group).
    At the Bosch root (968 features, 1,015,808 rows) and the Epsilon root
    (2,000 features, 409,600 rows), with uniform bins and with a fifth of
    every other feature's rows in the last bin (wide 968's NaN share).
Also prints, from cuobjdump -sass, the shared-memory atomic, MATCH and
VOTE instructions of each histogram kernel built, and of a probe kernel
that adds 32- and 64-bit integers and f32 with atomicAdd on shared
memory.  Every line names the card and its power limit.  Needs nvcc and
one CUDA device; imports nothing of JAX or lightgbm_tpu.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys

import torch

import chip_smoke as c
from lightgbm_tpu_torch.ops import build, cuda_segment
from lightgbm_tpu_torch.ops import segment as seg

VARIANT_DIR = build.BUILD_DIR.parent / "variants"
B = c.B

B3_THREADS = "constexpr int kRmwMoveThreads = 512;"
B3_STAGE = "constexpr int kRmwStageBytes = 32 * 1024;"
B3_GEOMETRY = [(t, kb) for t in (256, 512, 1024) for kb in (32, 48, 64, 96)]
B3_WIDTHS = (513, 978, 1664)
ROOT_ROWS = 1_015_808

B7_VARIANTS = {
    "tree": [],
    "no_hot_bin": [("if (hot == kNoBin) {  // the first contended bin becomes "
                    "hot", "if (false) {")],
    "probe_staging_only": [("    if (lane < fn) {\n      for (int rr = warp",
                            "    if (false) {\n      for (int rr = warp")],
}
B7_CHECKED = ("tree", "no_hot_bin")

PROBE = r"""
extern "C" __global__ void probe(int* o32, unsigned long long* o64,
                                 float* of, int i) {
  __shared__ int s32[64];
  __shared__ unsigned long long s64[64];
  __shared__ float sf[64];
  atomicAdd(&s32[threadIdx.x & 63], i);
  atomicAdd(&s64[threadIdx.x & 63], static_cast<unsigned long long>(i));
  atomicAdd(&sf[threadIdx.x & 63], static_cast<float>(i));
  __syncthreads();
  o32[threadIdx.x] = s32[threadIdx.x & 63];
  o64[threadIdx.x] = s64[threadIdx.x & 63];
  of[threadIdx.x] = sf[threadIdx.x & 63];
}
"""


def sass_ops(path) -> dict:
    """{function: {op: count}} of the shared atomics, MATCH and VOTE
    instructions in a built library or cubin."""
    out = subprocess.run([shutil.which("cuobjdump")
                          or "/usr/local/cuda/bin/cuobjdump", "-sass",
                          str(path)], capture_output=True, text=True,
                         check=True).stdout
    res, fn = {}, None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            res[fn] = {}
            continue
        m = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)",
                      ln)
        if fn and m and m.group(1).split(".")[0] in ("ATOMS", "MATCH",
                                                     "VOTE"):
            res[fn][m.group(1)] = res[fn].get(m.group(1), 0) + 1
    return res


def build_variants(specs: dict) -> dict:
    """specs: {tag: (source name, [(old, new), ...])}.  Writes each patched
    source beside a copy of the csrc headers and builds all at once;
    returns {tag: library path}."""
    procs, paths = [], {}
    for tag, (name, patches) in specs.items():
        d = VARIANT_DIR / tag
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for h in build.CSRC.glob("*.cuh"):
            shutil.copy(h, d)
        text = (build.CSRC / (name + ".cu")).read_text()
        for old, new in patches:
            if isinstance(old, tuple):  # the region from one marker to another
                i = text.index(old[0])
                old = text[i:text.index(old[1], i) + len(old[1])]
            if text.count(old) != 1:
                raise RuntimeError("%s: patch target not found once: %r"
                                   % (tag, old[:60]))
            text = text.replace(old, new)
        (d / (name + ".cu")).write_text(text)
        paths[tag] = d / ("lib%s.so" % name)
        procs.append((tag, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(paths[tag]),
             str(d / (name + ".cu"))], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    logs = {tag: p.communicate()[0] for tag, p in procs}
    for tag, p in procs:
        if p.returncode != 0:
            raise RuntimeError("nvcc failed for %s:\n%s" % (tag, logs[tag]))
    return paths


def use(name: str, path) -> None:
    """Serve the wrappers of source `name` from the library at `path`."""
    build._libs[name] = ctypes.CDLL(str(path))
    cuda_segment._tile_rows.cache_clear()
    cuda_segment._colblock_features.cache_clear()


def b3_phase(paths: dict, seed: int, dev) -> dict:
    i32 = dict(dtype=torch.int32, device=dev)
    lv = torch.tensor(-0.25, device=dev)
    rv = torch.tensor(0.75, device=dev)
    pred = c.make_pred(dev, B, 3, c.TIMED_SPLITS[""])
    out = {}
    for p in B3_WIDTHS:
        f = p - 10
        pay = c.device_payload(ROOT_ROWS, f, p, seed + p, dev)
        small = pay[:c.WIDE_CMP_ROWS + seg.GUARD].clone()
        small[c.WIDE_CMP_ROWS:] = 0.0
        aux = torch.zeros_like(pay)
        count = torch.tensor(ROOT_ROWS, **i32)
        start0 = torch.zeros((), **i32)
        fn = cuda_segment.partition_segment_rmw
        for tag, path in paths.items():
            use("segment_partition_wide", path)
            c.partition_equal((fn,), small, pred, 0, c.WIDE_CMP_ROWS,
                              f + 7)
            run = (lambda: fn(pay, aux, start0, count, pred, lv, rv, f + 7))
            out.setdefault(tag, {})[p] = dict(
                ms=c.time_fresh_ms(run, pay, 0, ROOT_ROWS, 5),
                breakdown_us=c.kernel_breakdown(run, pay, 0, ROOT_ROWS, 3))
        del pay, aux, small
        torch.cuda.empty_cache()
    return out


def b7_phase(paths: dict, seed: int, dev) -> dict:
    i32 = dict(dtype=torch.int32, device=dev)
    out = {}
    for f, rows in c.WIDE:
        n = -(-rows // 16384) * 16384
        cols = c.cols_of(f)
        hk = dict(num_features=f, num_bins=B, grad_col=cols["grad"],
                  hess_col=cols["hess"], cnt_col=cols["cnt"])
        pay = c.device_payload(n, f, f + 10, seed + f, dev)
        for kind in ("uniform", "nan_fifth"):
            if kind == "nan_fifth":
                gen = torch.Generator(device=dev)
                gen.manual_seed(seed + 1)
                odd = pay[:n, 1:f:2]
                odd[torch.rand(odd.shape, generator=gen, device=dev)
                    < 0.2] = B - 1
                del odd
            count = torch.tensor(n, **i32)
            start0 = torch.zeros((), **i32)
            fn = cuda_segment.segment_histogram_colblock
            for tag, path in paths.items():
                use("segment_hist_colblock", path)
                if tag in B7_CHECKED:
                    m = c.WIDE_CMP_ROWS
                    got = fn(pay, 0, m, **hk)
                    torch.cuda.synchronize()
                    c.hist_errors(pay, 0, m, f, got)
                    del got
                out.setdefault(tag, {})["%d_%s" % (f, kind)] = c.time_ms(
                    lambda: fn(pay, start0, count, **hk), 10)
        del pay
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--kernels", default="b3,b7",
                    help="which kernels' variants to build and time")
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    if "jax" in sys.modules or "lightgbm_tpu" in sys.modules:
        print("JAX or lightgbm_tpu was imported", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = c.nvidia_smi()
    print("device: %s | %s" % (torch.cuda.get_device_name(0), smi),
          flush=True)
    specs = {}
    if "b3" in kernels:
        specs.update({"b3_%d_%dk" % (t, kb): ("segment_partition_wide", [
            (B3_THREADS, "constexpr int kRmwMoveThreads = %d;" % t),
            (B3_STAGE, "constexpr int kRmwStageBytes = %d * 1024;" % kb)])
            for t, kb in B3_GEOMETRY})
    if "b7" in kernels:
        specs.update({"b7_" + k: ("segment_hist_colblock", v)
                      for k, v in B7_VARIANTS.items()})
    paths = build_variants(specs)
    probe_dir = VARIANT_DIR / "probe"
    probe_dir.mkdir(parents=True, exist_ok=True)
    (probe_dir / "probe.cu").write_text(PROBE)
    subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-cubin", "-o", str(probe_dir / "probe.cubin"),
                    str(probe_dir / "probe.cu")], check=True)
    print("sass (shared atomics, MATCH, VOTE): %s" % json.dumps(
        {"probe": sass_ops(probe_dir / "probe.cubin"),
         **{tag: sass_ops(p) for tag, p in paths.items()
            if tag.startswith("b7_")}}), flush=True)
    if "b7" in kernels:
        b7 = b7_phase({k[3:]: v for k, v in paths.items()
                       if k.startswith("b7_")}, args.seed, dev)
        print("B7 variants, ms at the wide roots (%s): %s"
              % (smi, json.dumps(b7)), flush=True)
    if "b3" in kernels:
        b3 = b3_phase({k[3:]: v for k, v in paths.items()
                       if k.startswith("b3_")}, args.seed, dev)
        print("B3 geometry (threads_stageKB), ms at %d rows (%s): %s"
              % (ROOT_ROWS, smi, json.dumps(b3)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
