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
    csrc/segment_hist.cuh: rows per chunk (128, 256), no feature groups
    (chunks alone split a small segment), the fixed-point cell as one
    16-byte int64 pair under a 128-bit compare-and-swap, and probes that
    are not right and are not checked: no count add, and the loads and
    flush alone (no cell updates).  At the main path's root (1,015,808 x
    28) and at segments of 1,024, 4,096, 16,384 and 131,072 rows (device
    us per call of the kernel, torch.profiler); B4 at the root.  Every
    checked variant is first held bit for bit to the plain fixed-point
    histogram.
  - B5 (segment_histogram_batched) and B4: the chunk and group variants;
    B5 int32 and f32 over 8 segments (a quarter of the rows down to
    1/64), B4 at the root and per call at the same sizes, each first held
    bit for bit.
  - B6 (partition_segment_hist), whose histogram launch runs the same
    body: the chunk, group and cell variants, at the root on fresh rows
    and at the same segment sizes, each first held to the plain version.
  - B3 (partition_segment_rmw): threads per move block x staging bytes
    per buffer, at P = 513, 978 and 1664 on 1,015,808 rows (fresh rows, the
    numerical split of chip_smoke.py, ~40 % left), with each kernel's
    device time; every variant is first held to the plain partition.
  - B7 (segment_histogram_colblock): the tree's kernel (one 1024-thread
    block an SM, 32 columns), two 512-thread blocks an SM (19 columns at
    255 bins), the 128-bit compare-and-swap cell, and a timing probe that
    is not right and is not checked: staging alone (no accumulation).
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
#: the fixed-point cell as one 16-byte (grad, hess) int64 pair updated by
#: one 128-bit compare-and-swap loop (integer sums: any order of retries
#: gives the same bits), and the count by a native add
CAS128 = [(("struct FixedCells {",
            "return fixed_value(h_lo[k], h_hi[k]); }\n};"), """struct FixedCells {
  unsigned long long* gh;
  int* cnt;
  float mg, mh;
  __device__ FixedCells(unsigned char* smem, int ncell, float mg_, float mh_)
      : gh(reinterpret_cast<unsigned long long*>(smem)),
        cnt(reinterpret_cast<int*>(gh + 2 * ncell)),
        mg(mg_),
        mh(mh_) {}
  __device__ void clear(int ncell) {
    unsigned* w = reinterpret_cast<unsigned*>(gh);
    for (int i = threadIdx.x; i < 5 * ncell; i += blockDim.x) w[i] = 0u;
  }
  __device__ void add_q(int k, long long qg, long long qh, int c) {
    unsigned __int128* p = reinterpret_cast<unsigned __int128*>(gh + 2 * k);
    unsigned __int128 old = *p;
    unsigned __int128 assumed;
    do {
      assumed = old;
      const unsigned long long lo =
          static_cast<unsigned long long>(assumed) + qg;
      const unsigned long long hi =
          static_cast<unsigned long long>(assumed >> 64) + qh;
      old = atomicCAS(p, assumed,
                      (static_cast<unsigned __int128>(hi) << 64) | lo);
    } while (old != assumed);
    if (c) atomicAdd(cnt + k, c);
  }
  __device__ void add(int k, float g, float h, float c) {
    add_q(k, to_fixed(g, mg), to_fixed(h, mh), __float2int_rn(c));
  }
  __device__ long long grad(int k) const {
    return static_cast<long long>(gh[2 * k]);
  }
  __device__ long long hess(int k) const {
    return static_cast<long long>(gh[2 * k + 1]);
  }
};""")]
B1_VARIANTS = {
    "tree": [],
    "chunk256": [(B1_CHUNK, "constexpr int kHistChunkRows = 256;")],
    # chunks alone split a small segment (one feature group)
    "no_groups": [("  int g = chunks > 0 ? grid / chunks : grid;",
                   "  int g = 1;")],
    "cas128": CAS128,
    # probes, not right: no count add; the loads and flush alone
    "probe_no_count": [("    if (c) atomicAdd(cnt + k, c);\n  }\n  __device__ "
                        "void add(", "  }\n  __device__ void add(")],
    "probe_loads_only": [("          if (b >= 0 && b < B) cells.add(",
                          "          if (b < -1) cells.add(")],
}
B1_CHECKED = ("tree", "chunk256", "no_groups", "cas128")

#: B5's variants: the tree's chunks and groups against 256-row chunks and
#: no feature groups, in f32 and int32
B5_VARIANTS = {k: B1_VARIANTS[k] for k in ("tree", "chunk256", "no_groups")}
B6_VARIANTS = ("tree", "chunk256", "no_groups", "cas128")
B1_SIZES = (1024, 4096, 16384, 131072)

B3_THREADS = "constexpr int kRmwMoveThreads = 512;"
B3_STAGE = "constexpr int kRmwStageBytes = 32 * 1024;"
B3_GEOMETRY = [(t, kb) for t in (256, 512, 1024) for kb in (32, 48, 64, 96)]
B3_WIDTHS = (513, 978, 1664)
ROOT_ROWS = 1_015_808

B7_VARIANTS = {
    "tree": [],
    # two 512-thread blocks per SM, 19 columns a block at 255 bins
    "two_blocks_512": [
        ("constexpr int kThreads = 1024;", "constexpr int kThreads = 512;"),
        ("constexpr int kBlocksPerSm = 1;", "constexpr int kBlocksPerSm = 2;"),
        ("constexpr int kMaxSmemBytes = 220 * 1024;",
         "constexpr int kMaxSmemBytes = 110 * 1024;")],
    "cas128": CAS128,
    "probe_staging_only": [("    if (lane < fn) {\n      for (int rr = warp",
                            "    if (false) {\n      for (int rr = warp")],
}
B7_CHECKED = ("tree", "two_blocks_512", "cas128")

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
                c.hist_exact(pay, 0, rows, c.F, got)
            got = cuda_segment.segment_histogram_quant(qpay, 0, n, **hk)
            c.check(torch.equal(got, seg.segment_histogram(
                qpay, 0, n, quantized=True, **hk)),
                "B4 variant %s differs from plain" % tag)
            del got
        count = torch.tensor(n, **i32)
        sc = c.scale_kw(f32, pay, 0, n, c.F)
        rec = dict(root_ms=c.time_ms(lambda: f32(pay, start0, count, **hk,
                                                 **sc), 20),
                   b4_root_ms=c.time_ms(
                       lambda: cuda_segment.segment_histogram_quant(
                           qpay, start0, count, **hk), 20))
        for rows in B1_SIZES:
            ct = torch.tensor(rows, **i32)
            rec["us_%d" % rows] = sum(c.kernel_breakdown(
                lambda: f32(pay, start0, ct, **hk, **sc), pay, 0, rows,
                20).values())
        out[tag] = rec
    return out


def b5_phase(paths: dict, seed: int, dev) -> dict:
    """B5's variants: B5 int32 and f32 at the 8-segment shape
    chip_smoke.py times (a quarter of the rows down to 1/64), B4 at the
    main path's root and per call at B1_SIZES; every variant first held
    bit for bit to the plain int32 and fixed-point histograms."""
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
        got = bat(pay, st, ct, **hk)
        sc = seg.fixed_scale(pay, starts, counts, c.COLS["grad"],
                             c.COLS["hess"])
        for k, (s0, c0) in enumerate(zip(starts, counts)):
            c.hist_exact(pay, s0, c0, c.F, got[k], scale=sc)
        del got
        for rows in (n, 4096, 37):
            c.check(torch.equal(quant(qpay, 0, rows, **hk),
                                seg.segment_histogram(qpay, 0, rows,
                                                      quantized=True, **hk)),
                    "B4 variant %s differs from plain at %d rows"
                    % (tag, rows))
        rec = dict(
            b5_int32_ms=c.time_ms(lambda: bat(qpay, st, ct, quantized=True,
                                              **hk), 20),
            b5_f32_ms=c.time_ms(lambda: bat(pay, st, ct, **hk, scale=sc),
                                20),
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
        psc = seg.fixed_scale(pay, 0, n, c.COLS["grad"], c.COLS["hess"])
        c.hist_exact(b[0], 0, nl, c.F, a[3], scale=psc)
        c.hist_exact(b[0], nl, n - nl, c.F, a[4], scale=psc)
        del a, b
        rec = {}
        for rows in B1_SIZES + (n,):
            ct = torch.tensor(rows, **i32)
            sc = c.scale_kw(fn, pay, 0, rows, c.F)
            run = (lambda: fn(pay, aux, start0, ct, pred, lv, rv,
                              c.COLS["value"], B, **hk, **sc))
            key = "root" if rows == n else str(rows)
            rec["us_" + key] = c.kernel_breakdown(run, pay, 0, rows, 20)
        count = torch.tensor(n, **i32)
        rec["root_ms"] = c.time_fresh_ms(
            lambda: fn(pay, aux, start0, count, pred, lv, rv,
                       c.COLS["value"], B, **hk, scale=psc), pay, 0, n, 20)
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
            sc = seg.fixed_scale(pay, 0, n, cols["grad"], cols["hess"])
            for tag, path in paths.items():
                use("segment_hist_colblock", path)
                if tag in B7_CHECKED:
                    m = c.WIDE_CMP_ROWS
                    got = fn(pay, 0, m, **hk)
                    torch.cuda.synchronize()
                    c.hist_exact(pay, 0, m, f, got)
                    del got
                out.setdefault(tag, {})["%d_%s" % (f, kind)] = c.time_ms(
                    lambda: fn(pay, start0, count, **hk, scale=sc), 10)
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
