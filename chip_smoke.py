"""Chip smoke test of the PyTorch/CUDA port (lightgbm_tpu_torch) on one GPU.

    python3 chip_smoke.py [--rows N] [--iters N] [--seed N]

Builds the hand-written kernels from lightgbm_tpu_torch/csrc with nvcc,
holds each against its plain PyTorch version at main-path shapes, checks
that CUDA and CPU training agree on a small problem, then trains the main
path (binary objective, 28 dense features, max_bin 255, 255 leaves,
lr 0.1) through lightgbm_tpu_torch.train on the card, predicts held-out
rows with Booster.predict, and times two more iterations, the second
under torch.profiler.  Every phase always runs and prints one line; any
failed check exits non-zero.  The last line is the device record
{"ok": true, "device": {...}}.  Imports nothing of JAX or lightgbm_tpu.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# the port, from this checkout only: alone in a directory this script fails
import lightgbm_tpu_torch as lt  # noqa: E402
import torch  # noqa: E402
from lightgbm_tpu_torch.ops import build, cuda_segment  # noqa: E402
from lightgbm_tpu_torch.ops import segment as seg  # noqa: E402
from lightgbm_tpu_torch.ops.segment import SplitPredicate  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# f32 (non-tensor-core) operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

F, B = 28, 256
G = F
COLS = dict(label=G, weight=G + 1, cnt=G + 2, idx=G + 3, score=G + 4,
            grad=G + 5, hess=G + 6, value=G + 7)
P = G + 10


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def synth(n_rows: int, n_feat: int, seed: int):
    """bench.py's synthetic Higgs-shaped workload (synth_higgs)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_rows, n_feat)).astype(np.float32)
    w = rng.standard_normal(n_feat)
    logit = (X @ w) * 0.5
    logit += 0.4 * X[:, 0] * X[:, 1] + 0.3 * np.abs(X[:, 2]) \
        - 0.2 * (X[:, 3] > 0.5)
    logit += rng.standard_normal(n_rows).astype(np.float32) * 0.8
    return X, (logit > 0).astype(np.float64)


def auc_score(y, p) -> float:
    order = np.argsort(p)
    ranks = np.empty(len(p))
    ranks[order] = np.arange(1, len(p) + 1)
    npos = y.sum()
    nneg = len(y) - npos
    return float((ranks[y > 0].sum() - npos * (npos + 1) / 2)
                 / max(npos * nneg, 1))


def time_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps launches (CUDA events,
    after two warm-up calls)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------

def make_payload(n: int, f: int, p: int, seed: int, dev) -> torch.Tensor:
    """A main-path-shaped payload: integer bins < B in [0, f), random
    value columns, 0/1 count mask, guard rows zero."""
    rng = np.random.default_rng(seed)
    pay = np.zeros((n + seg.GUARD, p), np.float32)
    pay[:n, :f] = rng.integers(0, B, size=(n, f))
    pay[:n, f:] = rng.standard_normal((n, p - f))
    pay[:n, f + 2] = (rng.random(n) < 0.9).astype(np.float32)
    return torch.from_numpy(pay).to(dev)


def predicates(dev):
    """The routing cases of the partition: numerical, NaN-missing with
    default_left, zero-missing, categorical bitset, EFB offset decode."""
    def pred(col, threshold, default_left=False, is_cat=False, bitset=None,
             missing_type=0, num_bin=B, default_bin=0, offset=0,
             identity=True):
        i32 = dict(dtype=torch.int32, device=dev)
        return SplitPredicate(
            col=torch.tensor(col, **i32),
            threshold=torch.tensor(threshold, **i32),
            default_left=torch.tensor(default_left, device=dev),
            is_cat=torch.tensor(is_cat, device=dev),
            bitset=torch.as_tensor(bitset if bitset is not None
                                   else np.zeros(B, bool), device=dev),
            missing_type=torch.tensor(missing_type, **i32),
            num_bin=torch.tensor(num_bin, **i32),
            default_bin=torch.tensor(default_bin, **i32),
            offset=torch.tensor(offset, **i32),
            identity=torch.tensor(identity, device=dev))

    cat = np.random.default_rng(5).random(B) < 0.4
    return {
        "numerical": pred(3, 100),
        "nan_missing_default_left": pred(5, 50, default_left=True,
                                         missing_type=2),
        "zero_missing": pred(7, 120, missing_type=1, default_bin=30),
        "categorical": pred(9, 0, is_cat=True, bitset=cat),
        "efb_offset": pred(11, 20, identity=False, offset=40, num_bin=64),
        "all_left": pred(3, B),
        "all_right": pred(3, -1),
    }


def hist_errors(pay, start, count, f, got) -> float:
    """Max |kernel - f64 sum| per cell; raises past the stated bound."""
    s, c = int(start), int(count)
    rows = pay[s:s + c].double()
    cell = (rows[:, :f].long()
            + torch.arange(f, device=pay.device)[None, :] * B).reshape(-1)
    vals = torch.stack([rows[:, f + 5], rows[:, f + 6], rows[:, f + 2]], 1)
    upd = vals[:, None, :].expand(c, f, 3).reshape(-1, 3)
    ref = torch.zeros(f * B, 3, dtype=torch.float64, device=pay.device)
    ref.index_add_(0, cell, upd)
    mag = torch.zeros_like(ref).index_add_(0, cell, upd.abs())
    got = got.reshape(f * B, 3).double()
    err = (got - ref).abs()
    check(torch.equal(got[:, 2], ref[:, 2]),
          "histogram count channel differs at (%d, %d)" % (s, c))
    check(bool((err[:, :2] <= 1e-5 * mag[:, :2] + 1e-6).all()),
          "histogram grad/hess past 1e-5*sum|v|+1e-6 at (%d, %d)" % (s, c))
    return float(err.max()) if err.numel() else 0.0


def kernels_phase(n: int, seed: int, dev) -> dict:
    pay = make_payload(n, F, P, seed, dev)
    hk = dict(num_features=F, num_bins=B, grad_col=COLS["grad"],
              hess_col=COLS["hess"], cnt_col=COLS["cnt"])
    i32 = dict(dtype=torch.int32, device=dev)

    # histogram: segments full / unaligned / empty / mid, plus F = 137
    hist_err = 0.0
    for s, c in ((0, n), (100, 37), (500, 0), (12345, n // 3)):
        got = cuda_segment.segment_histogram(
            pay, torch.tensor(s, **i32), torch.tensor(c, **i32), **hk)
        torch.cuda.synchronize()
        plain = seg.segment_histogram(pay, s, c, **hk)
        check(torch.equal(got[..., 2], plain[..., 2]),
              "histogram count channel vs plain at (%d, %d)" % (s, c))
        hist_err = max(hist_err, hist_errors(pay, s, c, F, got))
    f_wide, n_wide = 137, 200_000
    pay_w = make_payload(n_wide, f_wide, f_wide + 10, seed + 1, dev)
    got = cuda_segment.segment_histogram(
        pay_w, 0, n_wide, num_features=f_wide, num_bins=B,
        grad_col=f_wide + 5, hess_col=f_wide + 6, cnt_col=f_wide + 2)
    torch.cuda.synchronize()
    hist_err = max(hist_err, hist_errors(pay_w, 0, n_wide, f_wide, got))
    del pay_w

    # partition: every predicate on the full segment, plus the unaligned,
    # empty and mid segments; payload, aux segment and num_left must be
    # byte-identical to the plain version
    lv, rv = torch.tensor(-0.25, device=dev), torch.tensor(0.75, device=dev)
    preds = predicates(dev)
    cases = [(name, 0, n) for name in preds] + [
        ("numerical", 100, 37), ("nan_missing_default_left", 500, 0),
        ("categorical", 777, n // 2), ("efb_offset", 12345, n // 3)]
    for name, s, c in cases:
        a_pay, a_aux = pay.clone(), torch.zeros_like(pay)
        b_pay, b_aux = pay.clone(), torch.zeros_like(pay)
        a_pay, a_aux, a_nl = cuda_segment.partition_segment(
            a_pay, a_aux, torch.tensor(s, **i32), torch.tensor(c, **i32),
            preds[name], lv, rv, COLS["value"])
        torch.cuda.synchronize()
        b_pay, b_aux, b_nl = seg.partition_segment(
            b_pay, b_aux, s, c, preds[name], lv, rv, COLS["value"])
        check(int(a_nl) == int(b_nl),
              "partition num_left %s (%d, %d): %d vs %d"
              % (name, s, c, int(a_nl), int(b_nl)))
        check(torch.equal(a_pay.view(torch.int32), b_pay.view(torch.int32)),
              "partition payload not byte-identical: %s (%d, %d)"
              % (name, s, c))
        check(torch.equal(a_aux[s:s + c].view(torch.int32),
                          b_aux[s:s + c].view(torch.int32)),
              "partition aux not byte-identical: %s (%d, %d)" % (name, s, c))
        if name == "all_left":
            check(int(a_nl) == c, "all_left routed a row right")
        if name == "all_right":
            check(int(a_nl) == 0, "all_right routed a row left")

    # times at the root segment of the main path (n rows, F = 28, P = 38)
    reps = 20
    start0, count = torch.zeros((), **i32), torch.tensor(n, **i32)
    hist_ms = time_ms(lambda: cuda_segment.segment_histogram(
        pay, start0, count, **hk), reps)
    hist_plain_ms = time_ms(lambda: seg.segment_histogram(
        pay, 0, n, **hk), 3)
    rows = pay[:n]
    lib_idx = (rows[:, :F].long()
               + torch.arange(F, device=dev)[None, :] * B).reshape(-1)
    lib_vals = torch.stack([rows[:, COLS["grad"]], rows[:, COLS["hess"]],
                            rows[:, COLS["cnt"]]], 1)[:, None, :] \
        .expand(n, F, 3).reshape(-1, 3).contiguous()
    lib_out = torch.zeros(F * B, 3, device=dev)
    hist_lib_ms = time_ms(lambda: lib_out.index_add_(0, lib_idx, lib_vals),
                          reps)
    del lib_idx, lib_vals

    pred = preds["numerical"]
    aux = torch.zeros_like(pay)
    part_ms = time_ms(lambda: cuda_segment.partition_segment(
        pay, aux, start0, count, pred, lv, rv, COLS["value"]), reps)
    part_plain_ms = time_ms(lambda: seg.partition_segment(
        pay, aux, 0, n, pred, lv, rv, COLS["value"]), 3)

    hist_bytes = n * (F + 3) * 4
    hist_ops = n * F * 3
    # read the segment's rows once and write them once; aux is scratch
    # that the grower never reads, so its traffic is not part of the bound
    part_bytes = 2 * n * P * 4
    return {
        "segment_histogram": dict(
            name="segment_histogram", route="cuda",
            source="lightgbm_tpu_torch/csrc/segment_hist.cu",
            replaces="lightgbm_tpu/ops/pallas_segment.py:473",
            max_abs_err=hist_err, ms=hist_ms, plain_ms=hist_plain_ms,
            bound_ms=max(hist_bytes / HBM_BYTES_PER_S,
                         hist_ops / F32_OPS_PER_S) * 1e3,
            bound_by=("bytes" if hist_bytes / HBM_BYTES_PER_S
                      >= hist_ops / F32_OPS_PER_S else "operations"),
            library_ms=hist_lib_ms),
        "partition_segment": dict(
            name="partition_segment", route="cuda",
            source="lightgbm_tpu_torch/csrc/segment_partition.cu",
            replaces="lightgbm_tpu/ops/pallas_segment.py:1616",
            max_abs_err=0.0, ms=part_ms, plain_ms=part_plain_ms,
            bound_ms=part_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None),
    }


# ---------------------------------------------------------------------------
# phases: parity and main path
# ---------------------------------------------------------------------------

def train_params(num_leaves: int, **extra) -> dict:
    return dict(objective="binary", num_leaves=num_leaves, max_bin=255,
                learning_rate=0.1, verbose=-1, **extra)


def parity_phase(seed: int) -> str:
    X, y = synth(25_000, F, seed + 11)
    Xt, yt, Xv, yv = X[:20_000], y[:20_000], X[20_000:], y[20_000:]
    runs = {}
    for dev in ("cuda", "cpu"):
        params = train_params(63) if dev == "cuda" \
            else train_params(63, device_type="cpu")
        bst = lt.train(params, lt.Dataset(Xt, label=yt), 10,
                       verbose_eval=False)
        check(bst.device.type == dev, "parity run on %s" % bst.device)
        t0 = bst._model.trees[0]
        runs[dev] = (int(t0.split_feature[0]), int(t0.threshold_in_bin[0]),
                     auc_score(yv, bst.predict(Xv)))
    check(runs["cuda"][:2] == runs["cpu"][:2],
          "first split differs: cuda %s vs cpu %s" % (runs["cuda"][:2],
                                                      runs["cpu"][:2]))
    d_auc = abs(runs["cuda"][2] - runs["cpu"][2])
    check(d_auc <= 0.002, "|dAUC| %.6f > 0.002" % d_auc)
    return ("parity: 20000x28, 63 leaves, 10 iters: first split %s on both, "
            "AUC cuda %.6f cpu %.6f |dAUC| %.6f"
            % (runs["cuda"][:2], runs["cuda"][2], runs["cpu"][2], d_auc))


def main_path_phase(rows: int, iters: int, seed: int) -> tuple:
    n_valid = 100_000
    X, y = synth(rows + n_valid, F, seed)
    Xt, yt, Xv, yv = X[:rows], y[:rows], X[rows:], y[rows:]
    params = train_params(255)
    t0 = time.perf_counter()
    ds = lt.Dataset(Xt, label=yt)
    ds.construct(lt.Config(params))
    t_bin = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    cuda_segment.segment_histogram.launches = 0
    cuda_segment.partition_segment.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = lt.train(params, ds, iters, verbose_eval=False)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = {"segment_histogram": cuda_segment.segment_histogram.launches,
                "partition_segment": cuda_segment.partition_segment.launches}
    peak = torch.cuda.max_memory_allocated()

    check(bst.device.type == "cuda", "main path ran on %s" % bst.device)
    check(bst.current_iteration() == iters, "trained %d of %d iterations"
          % (bst.current_iteration(), iters))
    check(launches["segment_histogram"] >= iters,
          "histogram kernel launched %d times" % launches["segment_histogram"])
    check(launches["partition_segment"] > 0, "partition kernel never ran")
    t0 = time.perf_counter()
    pred = bst.predict(Xv)
    t_pred = time.perf_counter() - t0
    check(pred.shape == (n_valid,) and bool(np.isfinite(pred).all()),
          "held-out predictions malformed")
    auc = auc_score(yv, pred)
    check(auc > 0.8, "held-out AUC %.4f too low" % auc)
    syncs = bst.host_syncs_per_tree()
    leaves = [t.num_leaves for t in bst._model.trees]
    line = ("main path: %dx%d, max_bin 255, 255 leaves, lr 0.1, %d iters: "
            "%.4f s/iter (train %.3f s, binning %.3f s), syncs/tree %s, "
            "leaves/tree %s, max_memory_allocated %d B, held-out AUC %.6f "
            "on %d rows (predict %.3f s), launches %s"
            % (rows, F, iters, t_train / iters, t_train, t_bin,
               syncs, leaves, peak, auc, n_valid, t_pred,
               json.dumps(launches)))
    return line, launches, bst


def profile_phase(bst) -> str:
    """Two more boosting iterations of the main-path booster: one timed
    on the host clock alone, then one under torch.profiler.  Prints both
    walls, the profiled iteration's summed kernel time, the device's idle
    share against each wall (the unprofiled one is the reading; the
    profiler slows the host) and the kernels that take the most device
    time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst.update()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    check(busy > 0, "the profiler saw no device time")
    ported = {}
    for prefix, name in (("segment_hist_kernel", "segment_histogram"),
                         ("part_", "partition_segment")):
        hits = [e for e in kernels if prefix in e.key]
        ported[name] = [sum(e.count for e in hits),
                        round(sum(e.self_device_time_total
                                  for e in hits) / 1e3, 4)]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return ("profile: one iteration %.4f s wall unprofiled, %.4f s wall "
            "profiled, %.4f s summed kernel time (profiled), device idle "
            "share %.4f against the unprofiled wall (%.4f against the "
            "profiled), %d kernel launches; ported kernels [launches, ms]: "
            "%s; top [name, launches, ms]: %s"
            % (wall, wall_prof, busy, 1.0 - busy / wall,
               1.0 - busy / wall_prof, sum(e.count for e in kernels),
               json.dumps(ported),
               json.dumps([[e.key[:60], e.count,
                            round(e.self_device_time_total / 1e3, 4)]
                           for e in top])))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    if not 1 <= args.rows <= 10_500_000:
        ap.error("--rows must be in [1, 10500000]")

    if not os.path.abspath(lt.__file__).startswith(HERE + os.sep):
        print("lightgbm_tpu_torch is not this checkout's", file=sys.stderr)
        return 2
    if "jax" in sys.modules or "lightgbm_tpu" in sys.modules:
        print("JAX or lightgbm_tpu was imported", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the GPU only",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    build_s, build_logs = build.build_all()
    print("device: %s | %s | torch %s CUDA %s | kernel build %.2f s"
          % (torch.cuda.get_device_name(0), smi, torch.__version__,
             torch.version.cuda, build_s), flush=True)
    for name, log in build_logs.items():
        info = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "smem" in ln]
        print("ptxas %s: %s" % (name, " / ".join(info)), flush=True)

    kernels = kernels_phase(1_015_808, args.seed, dev)
    print("kernels: checked against the plain versions at n=1015808, "
          "F=28, P=38, B=256 (+ F=137): %s"
          % json.dumps({k: {kk: v[kk] for kk in ("ms", "plain_ms",
                                                 "library_ms", "bound_ms",
                                                 "max_abs_err")}
                        for k, v in kernels.items()}), flush=True)
    print(parity_phase(args.seed), flush=True)
    line, launches, bst = main_path_phase(args.rows, args.iters, args.seed)
    print(line, flush=True)
    print(profile_phase(bst), flush=True)
    record = [dict(v, launches=launches[k]) for k, v in kernels.items()]
    print(json.dumps({"kernels": record}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
