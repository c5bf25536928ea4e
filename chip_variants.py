"""Variants of the B1, B5, B6, B3 and B7 kernels, timed on one GPU beside
the tree's own.

    python3 chip_variants.py [--seed N] [--kernels b1,b5,b6,b3,b7]

Each variant is the tree's source (lightgbm_tpu_torch/csrc) with a few
text patches (to the source or to a header it includes), built by its own
nvcc under build/variants/ (all at once; a variant that does not build is
reported and left out), loaded in place of the tree's library and driven
through the port's wrapper (lightgbm_tpu_torch.ops.cuda_segment), so the
launch is the one training makes.
  - B1 (segment_histogram) and B4 (segment_histogram_quant), the body of
    csrc/segment_hist.cuh: rows per chunk (64, 128, 256), the flush with
    one scalar atomic per element instead of 16-byte ones, no feature
    groups (chunks alone split a small segment), and probes that are not
    right and are not checked: no count atomic, and the loads and flush
    alone (no cell updates).  At the main path's root (1,015,808 x 28)
    and at segments of 1,024, 4,096, 16,384 and 131,072 rows (device us
    per call of the kernel, torch.profiler); B4 at the root.  Every
    checked variant is first held to the plain histogram.
  - B5 (segment_histogram_batched) and B4, the body's int32 instance:
    the flush one element a thread against one cell a thread; B5 int32
    and f32 over 8 segments (a quarter of the rows down to 1/64), B4 at
    the root and per call at the same sizes, each first held bit for bit.
  - B6 (partition_segment_hist), whose histogram launch runs the same
    body: the chunk and group variants, at the root on fresh rows and at
    the same segment sizes, each first held to the plain version.
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

B1_CHUNK = "constexpr int kHistChunkRows = 128;"
B1_VARIANTS = {
    "tree": [],
    "chunk64": [(B1_CHUNK, "constexpr int kHistChunkRows = 64;")],
    "chunk256": [(B1_CHUNK, "constexpr int kHistChunkRows = 256;")],
    "scalar_flush": [(
        "      atomicAdd(reinterpret_cast<float4*>(dst + k), v);",
        "      atomicAdd(dst + k, v.x);\n      atomicAdd(dst + k + 1, v.y);\n"
        "      atomicAdd(dst + k + 2, v.z);\n      atomicAdd(dst + k + 3, v.w);")],
    "no_groups": [("  int g = s.chunks > 0 ? grid / s.chunks : grid;",
                   "  int g = 1;")],
    # (grad, hess, count) in one 16-byte cell, one 128-bit compare-and-swap
    # a row and feature; B + 0 cells a feature so 28 features fit two
    # blocks an SM (right for F <= 28 only)
    "cell128": [
        ("""  float2* gh;
  int* cnt;
  __device__ HistCells(unsigned char* smem, int ncell)
      : gh(reinterpret_cast<float2*>(smem)),
        cnt(reinterpret_cast<int*>(gh + ncell)) {}
  __device__ void clear(int ncell) {
    for (int i = threadIdx.x; i < ncell; i += blockDim.x) {
      gh[i] = make_float2(0.f, 0.f);
      cnt[i] = 0;
    }
  }
  __device__ void add(int k, float g, float h, float c) {
    add_pair(gh + k, g, h);
    atomicAdd(cnt + k, __float2int_rn(c));
  }
  __device__ float get(int k, int ch) const {
    return ch == 0 ? gh[k].x
                   : (ch == 1 ? gh[k].y : static_cast<float>(cnt[k]));
  }""", """  float4* cell;
  __device__ HistCells(unsigned char* smem, int ncell)
      : cell(reinterpret_cast<float4*>(smem)) {}
  __device__ void clear(int ncell) {
    for (int i = threadIdx.x; i < ncell; i += blockDim.x) {
      cell[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ void add(int k, float g, float h, float c) {
    unsigned __int128* p = reinterpret_cast<unsigned __int128*>(cell + k);
    unsigned __int128 old = *p;
    unsigned __int128 assumed;
    do {
      assumed = old;
      float4 v;
      memcpy(&v, &assumed, sizeof(v));
      v.x += g;
      v.y += h;
      v.z += c;
      unsigned __int128 next;
      memcpy(&next, &v, sizeof(next));
      old = atomicCAS(p, assumed, next);
    } while (old != assumed);
  }
  __device__ float get(int k, int ch) const {
    return ch == 0 ? cell[k].x : (ch == 1 ? cell[k].y : cell[k].z);
  }"""),
        ("  return cap * (B + 1) * 12;", "  return (cap < 28 ? cap : 28) * B * 16;"),
        ("  const int stride = B + 1;\n  HistCells<T> cells",
         "  const int stride = B;\n  HistCells<T> cells"),
        ("  return cells.get(j * (B + 1) + b, rem - 3 * b);",
         "  return cells.get(j * B + b, rem - 3 * b);")],
    "probe_no_count": [("    add_pair(gh + k, g, h);\n"
                        "    atomicAdd(cnt + k, __float2int_rn(c));",
                        "    add_pair(gh + k, g, h);")],
    "probe_loads_only": [("          if (b >= 0 && b < B) cells.add(",
                          "          if (b < -1) cells.add(")],
}
B1_CHECKED = ("tree", "chunk64", "chunk256", "scalar_flush", "no_groups",
              "cell128")

#: the int32 instance's flush (B4, B5 int32): the tree's, one element a
#: thread with two divisions each, against one cell a thread (one
#: division) adding its three channels
B5_VARIANTS = {
    "tree": [],
    "int_flush_cells": [("""  const int n = fn * B * 3;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int v = cell_value(cells, k, B);
    if (v != 0) atomicAdd(dst + k, v);
  }""", """  const int n = fn * B;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int j = i / B;
    const int k = j * (B + 1) + i - j * B;
    const int2 gh = cells.gh[k];
    const int c = cells.cnt[k];
    int* d = dst + 3 * i;
    if (gh.x != 0) atomicAdd(d, gh.x);
    if (gh.y != 0) atomicAdd(d + 1, gh.y);
    if (c != 0) atomicAdd(d + 2, c);
  }""")],
}
B6_VARIANTS = ("tree", "chunk256", "no_groups", "cell128")
B1_SIZES = (1024, 4096, 16384, 131072)

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
    source beside a copy of the csrc headers (a patch applies to the one
    file, source or header, that holds its target) and builds all at once;
    returns {tag: library path} of the variants that built, and prints
    the compiler's output of those that did not."""
    procs, paths = [], {}
    for tag, (name, patches) in specs.items():
        d = VARIANT_DIR / tag
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        files = {p.name: p.read_text() for p in
                 [build.CSRC / (name + ".cu")] + sorted(
                     build.CSRC.glob("*.cuh"))}
        for old, new in patches:
            if isinstance(old, tuple):  # the region from one marker to another
                hits = [f for f, text in files.items() if old[0] in text]
                text = files[hits[0]] if len(hits) == 1 else ""
                i = text.index(old[0]) if hits else 0
                old = text[i:text.index(old[1], i) + len(old[1])]
            else:
                hits = [f for f, text in files.items() if old in text]
            if len(hits) != 1 or files[hits[0]].count(old) != 1:
                raise RuntimeError("%s: patch target not found once: %r"
                                   % (tag, old[:60]))
            files[hits[0]] = files[hits[0]].replace(old, new)
        for f, text in files.items():
            (d / f).write_text(text)
        paths[tag] = d / ("lib%s.so" % name)
        procs.append((tag, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(paths[tag]),
             str(d / (name + ".cu"))], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    logs = {tag: p.communicate()[0] for tag, p in procs}
    for tag, p in procs:
        if p.returncode != 0:
            print("variant %s did not build:\n%s" % (tag, logs[tag][-3000:]),
                  flush=True)
            del paths[tag]
    return paths


def use(name: str, path) -> None:
    """Serve the wrappers of source `name` from the library at `path`."""
    build._libs[name] = ctypes.CDLL(str(path))
    cuda_segment._tile_rows.cache_clear()
    cuda_segment._colblock_features.cache_clear()


def b1_phase(paths: dict, seed: int, dev) -> dict:
    """B1 and B4 variants at the main path's root and B1 at B1_SIZES."""
    i32 = dict(dtype=torch.int32, device=dev)
    n = ROOT_ROWS
    pay = c.make_payload(n, c.F, c.P, seed, dev)
    qpay = c.quantize_columns(pay, n, 127, seed + 127)
    hk = dict(num_features=c.F, num_bins=B, grad_col=c.COLS["grad"],
              hess_col=c.COLS["hess"], cnt_col=c.COLS["cnt"])
    start0 = torch.zeros((), **i32)
    out = {}
    for tag, path in paths.items():
        use("segment_hist", path)
        f32 = cuda_segment.segment_histogram
        if tag in B1_CHECKED:
            for rows in (n, 4096, 37):
                got = f32(pay, 0, rows, **hk)
                torch.cuda.synchronize()
                c.hist_errors(pay, 0, rows, c.F, got)
            got = cuda_segment.segment_histogram_quant(qpay, 0, n, **hk)
            c.check(torch.equal(got, seg.segment_histogram(
                qpay, 0, n, quantized=True, **hk)),
                "B4 variant %s differs from plain" % tag)
            del got
        count = torch.tensor(n, **i32)
        rec = dict(root_ms=c.time_ms(lambda: f32(pay, start0, count, **hk),
                                     20),
                   b4_root_ms=c.time_ms(
                       lambda: cuda_segment.segment_histogram_quant(
                           qpay, start0, count, **hk), 20))
        for rows in B1_SIZES:
            ct = torch.tensor(rows, **i32)
            rec["us_%d" % rows] = sum(c.kernel_breakdown(
                lambda: f32(pay, start0, ct, **hk), pay, 0, rows,
                20).values())
        out[tag] = rec
    return out


def b5_phase(paths: dict, seed: int, dev) -> dict:
    """The int32 instance's variants: B5 int32 and f32 at the 8-segment
    shape chip_smoke.py times (a quarter of the rows down to 1/64), B4 at
    the main path's root and per call at B1_SIZES; every variant first
    held bit for bit to the plain int32 histograms."""
    i32 = dict(dtype=torch.int32, device=dev)
    n = ROOT_ROWS
    pay = c.make_payload(n, c.F, c.P, seed, dev)
    qpay = c.quantize_columns(pay, n, 127, seed + 127)
    hk = dict(num_features=c.F, num_bins=B, grad_col=c.COLS["grad"],
              hess_col=c.COLS["hess"], cnt_col=c.COLS["cnt"])
    starts, counts = c.batch_segments(n, [n // d for d in (4, 5, 8, 10, 16,
                                                           20, 32, 64)])
    st, ct = torch.tensor(starts, **i32), torch.tensor(counts, **i32)
    start0, count = torch.zeros((), **i32), torch.tensor(n, **i32)
    bat = cuda_segment.segment_histogram_batched
    quant = cuda_segment.segment_histogram_quant
    out = {}
    for tag, path in paths.items():
        use("segment_hist", path)
        c.check(torch.equal(bat(qpay, st, ct, quantized=True, **hk),
                            seg.segment_histogram_batched(
                                qpay, starts, counts, quantized=True, **hk)),
                "B5 int32 variant %s differs from plain" % tag)
        for rows in (n, 4096, 37):
            c.check(torch.equal(quant(qpay, 0, rows, **hk),
                                seg.segment_histogram(qpay, 0, rows,
                                                      quantized=True, **hk)),
                    "B4 variant %s differs from plain at %d rows"
                    % (tag, rows))
        rec = dict(
            b5_int32_ms=c.time_ms(lambda: bat(qpay, st, ct, quantized=True,
                                              **hk), 20),
            b5_f32_ms=c.time_ms(lambda: bat(pay, st, ct, **hk), 20),
            b4_root_ms=c.time_ms(lambda: quant(qpay, start0, count, **hk),
                                 20))
        for rows in B1_SIZES:
            cr = torch.tensor(rows, **i32)
            rec["b4_us_%d" % rows] = sum(c.kernel_breakdown(
                lambda: quant(qpay, start0, cr, **hk), pay, 0, rows,
                20).values())
        out[tag] = rec
    return out


def b6_phase(paths: dict, seed: int, dev) -> dict:
    """B6 variants at the main path's root (fresh rows) and at B1_SIZES."""
    i32 = dict(dtype=torch.int32, device=dev)
    n = ROOT_ROWS
    pay = c.make_payload(n, c.F, c.P, seed, dev)
    aux = torch.zeros_like(pay)
    hk = dict(num_features=c.F, grad_col=c.COLS["grad"],
              hess_col=c.COLS["hess"], cnt_col=c.COLS["cnt"])
    pred = c.predicates(dev)["numerical"]
    lv, rv = torch.tensor(-0.25, device=dev), torch.tensor(0.75, device=dev)
    start0 = torch.zeros((), **i32)
    fn = cuda_segment.partition_segment_hist
    out = {}
    for tag, path in paths.items():
        use("segment_partition_hist", path)
        a = fn(pay.clone(), c.aux_like(pay), 0, n, pred, lv, rv,
               c.COLS["value"], B, **hk)
        torch.cuda.synchronize()
        b = seg.partition_segment_hist(pay.clone(), c.aux_like(pay), 0, n,
                                       pred, lv, rv, c.COLS["value"], B, **hk)
        c.same_partition("B6 variant " + tag, a[:3], b[:3], 0, n,
                         full_aux=False)
        nl = int(b[2])
        c.hist_errors(b[0], 0, nl, c.F, a[3])
        c.hist_errors(b[0], nl, n - nl, c.F, a[4])
        del a, b
        rec = {}
        for rows in B1_SIZES + (n,):
            ct = torch.tensor(rows, **i32)
            run = (lambda: fn(pay, aux, start0, ct, pred, lv, rv,
                              c.COLS["value"], B, **hk))
            key = "root" if rows == n else str(rows)
            rec["us_" + key] = c.kernel_breakdown(run, pay, 0, rows, 20)
        count = torch.tensor(n, **i32)
        rec["root_ms"] = c.time_fresh_ms(
            lambda: fn(pay, aux, start0, count, pred, lv, rv,
                       c.COLS["value"], B, **hk), pay, 0, n, 20)
        out[tag] = rec
    return out


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
    ap.add_argument("--kernels", default="b1,b5,b6,b3,b7",
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
    if "b1" in kernels:
        specs.update({"b1_" + k: ("segment_hist", v)
                      for k, v in B1_VARIANTS.items()})
    if "b5" in kernels:
        specs.update({"b5_" + k: ("segment_hist", v)
                      for k, v in B5_VARIANTS.items()})
    if "b6" in kernels:
        specs.update({"b6_" + k: ("segment_partition_hist", B1_VARIANTS[k])
                      for k in B6_VARIANTS})
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
            if tag.startswith(("b7_", "b1_tree", "b6_tree"))}}), flush=True)
    if "b1" in kernels:
        b1 = b1_phase({k[3:]: v for k, v in paths.items()
                       if k.startswith("b1_")}, args.seed, dev)
        print("B1 variants (B4 at the root), ms at the root and kernel us "
              "per call at %s rows (%s): %s"
              % (B1_SIZES, smi, json.dumps(b1)), flush=True)
    if "b5" in kernels:
        b5 = b5_phase({k[3:]: v for k, v in paths.items()
                       if k.startswith("b5_")}, args.seed, dev)
        print("B5 / B4 int32 variants, ms of B5 at the 8-segment shape and "
              "of B4 at the root, B4 kernel us per call at %s rows (%s): %s"
              % (B1_SIZES, smi, json.dumps(b5)), flush=True)
    if "b6" in kernels:
        b6 = b6_phase({k[3:]: v for k, v in paths.items()
                       if k.startswith("b6_")}, args.seed, dev)
        print("B6 variants, ms at the root (fresh rows) and kernel us per "
              "call at %s rows and the root (%s): %s"
              % (B1_SIZES, smi, json.dumps(b6)), flush=True)
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
