"""Chip smoke test of the PyTorch/CUDA port (lightgbm_tpu_torch) on one GPU.

    python3 chip_smoke.py [--rows N] [--iters N] [--seed N]

Builds the hand-written kernels from lightgbm_tpu_torch/csrc with nvcc,
holds each against its plain PyTorch version at main-path shapes (the f32
histogram B1, the int32 histogram B4 at the int8 and int16 grids, the
batched histogram B5 in f32 and int32, the partition B2 whole and as its
stage and commit halves, and the merged partition + histogram B6, also
at 137 features and 64 bins) and at the wide shapes (Bosch: 968 features,
Epsilon: 2,000; the column-block histogram B7, the RMW partition B3 and
the column-block partition B8, and B1, B2, B4, B5 and the stage and
commit there too), times each beside its bound and a PyTorch yardstick
(B1 and B2 at the wide shapes too; the partitions on fresh rows, B2 and
B8 also at 90/10 and 10/90 splits), checks that CUDA
and CPU training agree on small problems at 28, 968 and 2,000 features,
then trains through lightgbm_tpu_torch.train on the card (binary
objective, max_bin 255, 255 leaves, lr 0.1): on 28 dense features the f32
main path (then three iterations of it with every B2 call held against
the plain partition), the grower's merged mode (B6 on every split, with
lightgbm_tpu_torch.ops.cuda_segment.PARTITION_HIST_VALIDATED set once B6
has been held) and its histogram pool (histogram_pool_size=2, parents
rebuilt), then quantized gradients (int8, int16), the frontier-batched
grower (tpu_frontier_batch=8) and the two together; then the wide paths,
1M x 968 (a fifth of every other feature NaN) and 400k x 2,000, each with
a 100k-row validation set scored every iteration (metric auc).
The whole partitions B2 and B8 are held to the Pallas kernels' contract
(payload and num_left byte for byte, aux untouched outside the segment,
scratch inside it; ten runs on fresh copies of the root per predicate);
the stage, stage + commit, B3 and B6 also to the plain version's aux.
Each training path resets the kernels' launch counts before it and reads
them after it; the quantized paths must not launch the f32 histogram, the
frontier paths must take fewer rounds than splits, the quantized
frontier path must write the quantized one-leaf loop's model byte for
byte, no path on 28 features may launch B3, B7 or B8, the merged path
must launch B6 once per split, B1 once per tree and no other partition,
the pooled path must rebuild parents, and the wide paths must launch B7
with B3 (968) or B8 (2,000) and never B1 or the whole B2.
Held-out AUC is checked on every path (within 0.002 of the f32 main path
for its variants; on the wide paths the device's valid scores must equal
predict(raw_score=True) and the last valid AUC the AUC of that
prediction).  After the main, merged, quantized int8, frontier and wide
paths, two more iterations are timed, the second under torch.profiler.
Every phase always runs and prints one line, prefixed with the seconds
since start; any failed check exits non-zero.  The last line is the
device record {"ok": true, "device": {...}}.  Imports nothing of JAX or
lightgbm_tpu.
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
from lightgbm_tpu_torch.metric import create_metrics  # noqa: E402
from lightgbm_tpu_torch.ops import build, cuda_segment, quantize  # noqa: E402
from lightgbm_tpu_torch.ops import segment as seg  # noqa: E402
from lightgbm_tpu_torch.ops.segment import SplitPredicate  # noqa: E402
from lightgbm_tpu_torch.ops.split import (FeatureMeta,  # noqa: E402
                                          dequantize_hist,
                                          find_best_split_batched)

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# f32 (non-tensor-core) operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

F, B = 28, 256


def cols_of(f: int) -> dict:
    """The fast path's value columns after f bin columns (P = f + 10)."""
    return dict(label=f, weight=f + 1, cnt=f + 2, idx=f + 3, score=f + 4,
                grad=f + 5, hess=f + 6, value=f + 7)


COLS = cols_of(F)
P = F + 10
#: the wide shapes: Bosch (968 features) and Epsilon (2,000), with the
#: rows of their training paths
WIDE = ((968, 1_000_000), (2000, 400_000))
#: rows on which the wide kernels are held against the plain versions
#: (the plain histogram's index tensor is rows * F * 3 int64)
WIDE_CMP_ROWS = 65_536


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


def time_fresh_ms(fn, pay: torch.Tensor, s: int, c: int, reps: int) -> float:
    """Mean device milliseconds of fn() on fresh rows.  An in-place
    partition repeated on rows it has already partitioned finds its larger
    side in place, so before each of reps calls (and two warm-up calls)
    payload rows [s, s + c) are restored from a pristine copy, outside the
    timed window; a pair of CUDA events around each call times its own
    span, and the spans are summed.  A device sleep holds the card while
    the host queues every rep, so no span waits on the host."""
    rows = pay[s:s + c]
    pristine = rows.clone()
    for _ in range(2):
        rows.copy_(pristine)
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for e0, e1 in events:
        rows.copy_(pristine)
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    ms = sum(e0.elapsed_time(e1) for e0, e1 in events) / reps
    rows.copy_(pristine)
    return ms


def kernel_breakdown(fn, pay: torch.Tensor, s: int, c: int,
                     reps: int = 5) -> dict:
    """Device microseconds per call of each of the port's kernels that
    fn() launches (torch.profiler over reps calls on fresh rows, restored
    as time_fresh_ms restores them; PyTorch's own kernels are left out)."""
    from torch.profiler import ProfilerActivity, profile
    rows = pay[s:s + c]
    pristine = rows.clone()
    fn()
    rows.copy_(pristine)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
            rows.copy_(pristine)
        torch.cuda.synchronize()
    return {e.key.split("::")[1].split("(")[0]:
            round(e.self_device_time_total / reps, 3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key.startswith("(anonymous namespace)::")}


T_START = time.perf_counter()


def say(line: str) -> None:
    """Print one phase's line, prefixed with the seconds since start."""
    print("[%.1f s] %s" % (time.perf_counter() - T_START, line), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------

def make_payload(n: int, f: int, p: int, seed: int, dev,
                 num_bins: int = B) -> torch.Tensor:
    """A main-path-shaped payload: integer bins < num_bins in [0, f),
    random value columns, 0/1 count mask, guard rows zero."""
    rng = np.random.default_rng(seed)
    pay = np.zeros((n + seg.GUARD, p), np.float32)
    pay[:n, :f] = rng.integers(0, num_bins, size=(n, f))
    pay[:n, f:] = rng.standard_normal((n, p - f))
    pay[:n, f + 2] = (rng.random(n) < 0.9).astype(np.float32)
    return torch.from_numpy(pay).to(dev)


def make_pred(dev, nb: int, col: int, threshold: int, default_left=False,
              is_cat=False, bitset=None, missing_type=0, num_bin=None,
              default_bin=0, offset=0, identity=True) -> SplitPredicate:
    """One split predicate at nb bins, its scalars on `dev`."""
    i32 = dict(dtype=torch.int32, device=dev)
    return SplitPredicate(
        col=torch.tensor(col, **i32),
        threshold=torch.tensor(threshold, **i32),
        default_left=torch.tensor(default_left, device=dev),
        is_cat=torch.tensor(is_cat, device=dev),
        bitset=torch.as_tensor(bitset if bitset is not None
                               else np.zeros(nb, bool), device=dev),
        missing_type=torch.tensor(missing_type, **i32),
        num_bin=torch.tensor(nb if num_bin is None else num_bin, **i32),
        default_bin=torch.tensor(default_bin, **i32),
        offset=torch.tensor(offset, **i32),
        identity=torch.tensor(identity, device=dev))


def predicates(dev, nb: int = B):
    """The routing cases of the partition at nb bins: numerical,
    NaN-missing with default_left, zero-missing, categorical bitset, EFB
    offset decode, all rows left, all rows right."""
    cat = np.random.default_rng(5).random(nb) < 0.4
    return {
        "numerical": make_pred(dev, nb, 3, 100 * nb // B),
        "nan_missing_default_left": make_pred(dev, nb, 5, 50 * nb // B,
                                              default_left=True,
                                              missing_type=2),
        "zero_missing": make_pred(dev, nb, 7, 120 * nb // B, missing_type=1,
                                  default_bin=30 * nb // B),
        "categorical": make_pred(dev, nb, 9, 0, is_cat=True, bitset=cat),
        "efb_offset": make_pred(dev, nb, 11, 20 * nb // B, identity=False,
                                offset=40 * nb // B, num_bin=nb // 4),
        "all_left": make_pred(dev, nb, 3, nb),
        "all_right": make_pred(dev, nb, 3, -1),
    }


#: the splits the whole partitions (B2, B8) are timed at, as thresholds on
#: column 3 of uniform bins in [0, 256): the numerical predicate (~40 %
#: left), 90/10 and 10/90, so both walk directions are timed
TIMED_SPLITS = {"": 100, "_90_10": 229, "_10_90": 25}


def hist_errors(pay, start, count, f, got, nb: int = B) -> float:
    """Max |kernel - f64 sum| per cell of an nb-bin histogram; raises past
    the stated bound."""
    s, c = int(start), int(count)
    rows = pay[s:s + c].double()
    cell = (rows[:, :f].long()
            + torch.arange(f, device=pay.device)[None, :] * nb).reshape(-1)
    vals = torch.stack([rows[:, f + 5], rows[:, f + 6], rows[:, f + 2]], 1)
    upd = vals[:, None, :].expand(c, f, 3).reshape(-1, 3)
    ref = torch.zeros(f * nb, 3, dtype=torch.float64, device=pay.device)
    ref.index_add_(0, cell, upd)
    mag = torch.zeros_like(ref).index_add_(0, cell, upd.abs())
    got = got.reshape(f * nb, 3).double()
    err = (got - ref).abs()
    check(torch.equal(got[:, 2], ref[:, 2]),
          "histogram count channel differs at (%d, %d)" % (s, c))
    check(bool((err[:, :2] <= 1e-5 * mag[:, :2] + 1e-6).all()),
          "histogram grad/hess past 1e-5*sum|v|+1e-6 at (%d, %d)" % (s, c))
    return float(err.max()) if err.numel() else 0.0


def quantize_columns(pay: torch.Tensor, n: int, qmax: int, seed: int,
                     cols: dict = COLS) -> torch.Tensor:
    """A copy of `pay` whose grad/hess columns hold quantized gradients:
    integers on the grid of half-range qmax (hessians in [0, qmax]), zero
    where the count mask is 0."""
    out = pay.clone()
    gen = torch.Generator(device=pay.device)
    gen.manual_seed(seed)
    mask = out[:n, cols["cnt"]]
    g = torch.randint(-qmax, qmax + 1, (n,), generator=gen,
                      device=pay.device).to(torch.float32)
    h = torch.randint(0, qmax + 1, (n,), generator=gen,
                      device=pay.device).to(torch.float32)
    out[:n, cols["grad"]] = g * mask
    out[:n, cols["hess"]] = h * mask
    return out


def batch_segments(n: int, sizes) -> tuple:
    """Disjoint (start, count) segments of the given sizes, laid out one
    after another from row 0 with a gap of 17 rows between them."""
    starts, s = [], 0
    for c in sizes:
        starts.append(s)
        s += c + 17
    check(s <= n, "batched segments do not fit in %d rows" % n)
    return starts, list(sizes)


def bound(n_bytes: float, n_ops: float) -> tuple:
    """(bound_ms, bound_by) against the H100's HBM and f32 peaks."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def kernels_phase(n: int, seed: int, dev) -> dict:
    pay = make_payload(n, F, P, seed, dev)
    hk = dict(num_features=F, num_bins=B, grad_col=COLS["grad"],
              hess_col=COLS["hess"], cnt_col=COLS["cnt"])
    i32 = dict(dtype=torch.int32, device=dev)
    segments = ((0, n), (100, 37), (500, 0), (12345, n // 3))

    # B1 histogram: segments full / unaligned / empty / mid, plus F = 137
    hist_err = 0.0
    for s, c in segments:
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

    # B4 int32 histogram at the int8 grid and at the int16 grid's qmax
    # for n rows: bit-identical to the plain version on every segment
    qmax16 = quantize.derive_qmax(n, "int16")
    qpays = {}
    for qmax in (127, qmax16):
        qpay = quantize_columns(pay, n, qmax, seed + qmax)
        qpays[qmax] = qpay
        for s, c in segments:
            got = cuda_segment.segment_histogram_quant(
                qpay, torch.tensor(s, **i32), torch.tensor(c, **i32), **hk)
            torch.cuda.synchronize()
            plain = seg.segment_histogram(qpay, s, c, quantized=True, **hk)
            check(got.dtype == torch.int32 and torch.equal(got, plain),
                  "int32 histogram differs from plain at qmax %d (%d, %d)"
                  % (qmax, s, c))

    # B5 batched histogram: K = 8 disjoint segments of uneven sizes, one
    # empty and one of a single row; f32 held to B1's bound per slice with
    # an exact count channel, int32 bit for bit
    starts, counts = batch_segments(n, (n // 5, 1, 0, 37, n // 9, 4099,
                                        n // 3, n // 10 + 3))
    st_t, ct_t = torch.tensor(starts, **i32), torch.tensor(counts, **i32)
    got = cuda_segment.segment_histogram_batched(pay, st_t, ct_t, **hk)
    torch.cuda.synchronize()
    plain = seg.segment_histogram_batched(pay, starts, counts, **hk)
    check(torch.equal(got[..., 2], plain[..., 2]),
          "batched histogram count channel differs from plain")
    batched_err = 0.0
    for k, (s, c) in enumerate(zip(starts, counts)):
        batched_err = max(batched_err, hist_errors(pay, s, c, F, got[k]))
    for qmax, qpay in qpays.items():
        got = cuda_segment.segment_histogram_batched(qpay, st_t, ct_t,
                                                     quantized=True, **hk)
        torch.cuda.synchronize()
        plain = seg.segment_histogram_batched(qpay, starts, counts,
                                              quantized=True, **hk)
        check(got.dtype == torch.int32 and torch.equal(got, plain),
              "int32 batched histogram differs from plain at qmax %d" % qmax)

    # the split search gives each histogram the same bits at any batch
    # size (the frontier grower searches 2K children at once, the one-leaf
    # loop 2): 16 dequantized int32 histograms at once against 8 pairs
    qh = seg.segment_histogram_batched(qpays[127], starts + starts,
                                       counts + counts, quantized=True, **hk)
    sums = dequantize_hist(qh[:, 0].sum(dim=1), 0.01, 0.002)
    meta = FeatureMeta(
        num_bin=torch.full((F,), B, **i32),
        missing_type=torch.tensor([0, 1, 2, 0] * (F // 4), **i32),
        default_bin=torch.full((F,), 7, **i32),
        is_trivial=torch.zeros(F, dtype=torch.bool, device=dev),
        is_categorical=torch.zeros(F, dtype=torch.bool, device=dev),
        penalty=torch.ones(F, device=dev),
        monotone=torch.zeros(F, **i32))
    search = dict(meta=meta, l1=0.0, l2=0.0, max_delta_step=0.0,
                  min_data_in_leaf=1, min_sum_hessian_in_leaf=1e-3,
                  min_gain_to_split=0.0)
    fmask = torch.ones(F, dtype=torch.bool, device=dev)
    res16 = find_best_split_batched(
        dequantize_hist(qh, 0.01, 0.002), sums[:, 0], sums[:, 1],
        sums[:, 2], fmask, **search)
    for q in range(0, 16, 2):
        res2 = find_best_split_batched(
            dequantize_hist(qh[q:q + 2], 0.01, 0.002), sums[q:q + 2, 0],
            sums[q:q + 2, 1], sums[q:q + 2, 2], fmask, **search)
        for field, a, b in zip(res2._fields, res16, res2):
            a = a[q:q + 2]
            if a.is_floating_point():  # bits: a leaf with no split has NaN
                a, b = a.view(torch.int32), b.view(torch.int32)
            check(torch.equal(a, b),
                  "split search %s differs between Q = 16 and Q = 2" % field)
    del qh, sums

    # partition: every predicate on the full segment, plus the unaligned,
    # empty, one-row and mid segments, each against one plain partition.
    # B2 whole has the Pallas kernels' contract: payload and num_left byte
    # for byte, aux outside the segment untouched, the root partitioned
    # WHOLE_REPEATS times on fresh copies.  Stage then commit keeps the
    # full contract (the frontier grower reads the staged aux): aux over
    # the segment too, and the stage alone leaves the payload untouched.
    lv, rv = torch.tensor(-0.25, device=dev), torch.tensor(0.75, device=dev)
    preds = predicates(dev)
    cases = [(name, 0, n) for name in preds] + [
        ("numerical", 100, 37), ("nan_missing_default_left", 500, 0),
        ("zero_missing", 4097, 1), ("categorical", 777, n // 2),
        ("efb_offset", 12345, n // 3)]
    pay_bytes = pay.view(torch.int32)
    for name, s, c in cases:
        st, ct = torch.tensor(s, **i32), torch.tensor(c, **i32)
        plain = seg.partition_segment(pay.clone(), aux_like(pay), s, c,
                                      preds[name], lv, rv, COLS["value"])
        for _ in range(WHOLE_REPEATS if (s, c) == (0, n) else 1):
            got = cuda_segment.partition_segment(
                pay.clone(), aux_like(pay), st, ct, preds[name], lv, rv,
                COLS["value"])
            torch.cuda.synchronize()
            same_partition("B2 whole %s (%d, %d)" % (name, s, c), got, plain,
                           s, c, full_aux=False)
        c_pay, c_aux = pay.clone(), aux_like(pay)
        nl_vec = torch.full((4,), -1, **i32)
        c_aux, c_nl = cuda_segment.partition_segment_stage(
            c_pay, c_aux, st, ct, preds[name], nl_vec, 2)
        torch.cuda.synchronize()
        check(torch.equal(c_pay.view(torch.int32), pay_bytes),
              "partition stage wrote the payload: %s (%d, %d)" % (name, s, c))
        check(nl_vec[[0, 1, 3]].tolist() == [-1, -1, -1],
              "partition stage wrote outside its num_left slot")
        c_pay = cuda_segment.partition_segment_commit(
            c_pay, c_aux, st, ct, c_nl, lv, rv, COLS["value"])
        torch.cuda.synchronize()
        same_partition("B2 stage+commit %s (%d, %d)" % (name, s, c),
                       (c_pay, c_aux, c_nl), plain, s, c)
        if name == "all_left":
            check(int(got[2]) == c, "all_left routed a row right")
        if name == "all_right":
            check(int(got[2]) == 0, "all_right routed a row left")
        del plain, got, c_pay, c_aux
    # a commit of count 0 (a staged candidate that did not commit) is a
    # no-op
    z_pay = pay.clone()
    cuda_segment.partition_segment_commit(
        z_pay, torch.zeros_like(pay), torch.tensor(7, **i32),
        torch.tensor(0, **i32), torch.tensor(5, **i32), lv, rv,
        COLS["value"])
    torch.cuda.synchronize()
    check(torch.equal(z_pay.view(torch.int32), pay_bytes),
          "a partition commit of count 0 wrote the payload")
    del z_pay

    # times at the root segment of the main path (n rows, F = 28, P = 38)
    reps = 20
    start0, count = torch.zeros((), **i32), torch.tensor(n, **i32)
    rows = pay[:n]
    flat = (rows[:, :F].long()
            + torch.arange(F, device=dev)[None, :] * B).reshape(-1)

    def lib_vals(src, dtype):
        r = src[:n]
        return torch.stack([r[:, COLS["grad"]], r[:, COLS["hess"]],
                            r[:, COLS["cnt"]]], 1)[:, None, :] \
            .expand(n, F, 3).reshape(-1, 3).to(dtype).contiguous()

    hist_ms = time_ms(lambda: cuda_segment.segment_histogram(
        pay, start0, count, **hk), reps)
    hist_plain_ms = time_ms(lambda: seg.segment_histogram(
        pay, 0, n, **hk), 3)
    vals = lib_vals(pay, torch.float32)
    lib_out = torch.zeros(F * B, 3, device=dev)
    hist_lib_ms = time_ms(lambda: lib_out.index_add_(0, flat, vals), reps)

    qpay = qpays[127]
    quant_ms = time_ms(lambda: cuda_segment.segment_histogram_quant(
        qpay, start0, count, **hk), reps)
    quant_plain_ms = time_ms(lambda: seg.segment_histogram(
        qpay, 0, n, quantized=True, **hk), 3)
    vals = lib_vals(qpay, torch.int32)
    lib_out = torch.zeros(F * B, 3, **i32)
    quant_lib_ms = time_ms(lambda: lib_out.index_add_(0, flat, vals), reps)
    del vals, lib_out, flat

    # B5 at K = 8 disjoint segments from a quarter of the rows down to 1/64
    tstarts, tcounts = batch_segments(n, [n // d for d in (4, 5, 8, 10, 16,
                                                           20, 32, 64)])
    ts_t, tc_t = torch.tensor(tstarts, **i32), torch.tensor(tcounts, **i32)
    bat_ms = time_ms(lambda: cuda_segment.segment_histogram_batched(
        pay, ts_t, tc_t, **hk), reps)
    bat_q_ms = time_ms(lambda: cuda_segment.segment_histogram_batched(
        qpay, ts_t, tc_t, quantized=True, **hk), reps)
    bat_plain_ms = time_ms(lambda: seg.segment_histogram_batched(
        pay, tstarts, tcounts, **hk), 3)
    seg_rows = torch.cat([pay[s:s + c] for s, c in zip(tstarts, tcounts)])
    seg_id = torch.cat([torch.full((c,), k, dtype=torch.long, device=dev)
                        for k, c in enumerate(tcounts)])
    flat = ((seg_id[:, None] * F + torch.arange(F, device=dev)[None, :]) * B
            + seg_rows[:, :F].long()).reshape(-1)
    m = seg_rows.shape[0]
    vals = torch.stack([seg_rows[:, COLS["grad"]], seg_rows[:, COLS["hess"]],
                        seg_rows[:, COLS["cnt"]]], 1)[:, None, :] \
        .expand(m, F, 3).reshape(-1, 3).contiguous()
    lib_out = torch.zeros(len(tcounts) * F * B, 3, device=dev)
    bat_lib_ms = time_ms(lambda: lib_out.index_add_(0, flat, vals), reps)
    del seg_rows, seg_id, flat, vals, lib_out, qpays, qpay

    # B2 whole on fresh rows: at the root at the TIMED_SPLITS, and on the
    # first WIDE_SEGMENT_ROWS rows with the numerical split; each beside
    # its plain version and its yardstick, a stable argsort of the routing
    # (computed beforehand) and one index_select of the rows into aux.
    # Then B2 as stage + commit at the root.
    aux = torch.zeros_like(pay)
    part = {}
    for suffix, thr, rows_t in [(k, v, n) for k, v in TIMED_SPLITS.items()] \
            + [("_%d_rows" % WIDE_SEGMENT_ROWS, TIMED_SPLITS[""],
                WIDE_SEGMENT_ROWS)]:
        pred = make_pred(dev, B, 3, thr)
        ct = torch.tensor(rows_t, **i32)
        part["ms" + suffix] = time_fresh_ms(
            lambda: cuda_segment.partition_segment(
                pay, aux, start0, ct, pred, lv, rv, COLS["value"]),
            pay, 0, rows_t, reps)
        part["plain_ms" + suffix] = time_fresh_ms(
            lambda: seg.partition_segment(pay, aux, 0, rows_t, pred, lv, rv,
                                          COLS["value"]), pay, 0, rows_t, 3)
        right = (~seg.go_left_chunk(pay[:rows_t], pred)).to(torch.uint8)
        part["library_ms" + suffix] = time_ms(lambda: torch.index_select(
            pay[:rows_t], 0, torch.argsort(right, stable=True),
            out=aux[:rows_t]), reps)
        part["left_share" + suffix] = 1.0 - float(right.float().mean())
        part["bound_ms" + suffix] = bound(2 * rows_t * P * 4, 0)[0]
        del right
    pred = preds["numerical"]
    part["breakdown_us"] = kernel_breakdown(
        lambda: cuda_segment.partition_segment(pay, aux, start0, count, pred,
                                               lv, rv, COLS["value"]),
        pay, 0, n)
    part["stage_commit_ms"] = time_fresh_ms(
        lambda: stage_commit(pay, aux, start0, count, pred, lv, rv,
                             COLS["value"]), pay, 0, n, reps)
    del aux

    hist_bytes = n * (F + 3) * 4
    hist_ops = n * F * 3
    # read the segment's rows once and write them once; aux is scratch
    # that the grower never reads, so its traffic is not part of the bound
    part_bytes = 2 * n * P * 4
    bat_rows = sum(tcounts)
    records = {
        "segment_histogram": dict(
            name="segment_histogram", route="cuda",
            source="lightgbm_tpu_torch/csrc/segment_hist.cu",
            replaces="lightgbm_tpu/ops/pallas_segment.py:473",
            max_abs_err=hist_err, ms=hist_ms, plain_ms=hist_plain_ms,
            library_ms=hist_lib_ms),
        "partition_segment": dict(
            part, name="partition_segment", route="cuda",
            source="lightgbm_tpu_torch/csrc/segment_partition.cu",
            replaces="lightgbm_tpu/ops/pallas_segment.py:1616",
            max_abs_err=0.0, repeats_identical=WHOLE_REPEATS),
        "segment_histogram_quant": dict(
            name="segment_histogram_quant", route="cuda",
            source="lightgbm_tpu_torch/csrc/segment_hist.cu",
            replaces="lightgbm_tpu/ops/pallas_segment.py:786",
            max_abs_err=0.0, ms=quant_ms, plain_ms=quant_plain_ms,
            library_ms=quant_lib_ms),
        "segment_histogram_batched": dict(
            name="segment_histogram_batched", route="cuda",
            source="lightgbm_tpu_torch/csrc/segment_hist.cu",
            replaces="lightgbm_tpu/ops/pallas_segment.py:649",
            max_abs_err=batched_err, ms=bat_ms, ms_int32=bat_q_ms,
            plain_ms=bat_plain_ms, library_ms=bat_lib_ms),
    }
    for key, (nb, no) in {
            "segment_histogram": (hist_bytes, hist_ops),
            "partition_segment": (part_bytes, 0),
            "segment_histogram_quant": (hist_bytes, hist_ops),
            "segment_histogram_batched": (bat_rows * (F + 3) * 4,
                                          bat_rows * F * 3)}.items():
        records[key]["bound_ms"], records[key]["bound_by"] = bound(nb, no)
    return records


# ---------------------------------------------------------------------------
# phase: the merged partition + histogram kernel (B6)
# ---------------------------------------------------------------------------

#: the shapes B6 is held at: the main path's root, and 137 features at 64
#: bins (MSLR-WEB30K's width, which its gate admits), on 200,000 rows
MERGED_SHAPES = ((None, F, B), (200_000, 137, 64))


def merged_kernel_phase(n: int, seed: int, dev) -> dict:
    """B6 against its plain version (ops/segment.partition_segment_hist)
    on every predicate kind of `predicates()` over the whole segment, and
    on unaligned, empty, one-row and mid segments, at MERGED_SHAPES:
    payload, aux over the segment and num_left byte for byte, both
    children's count channels exact, grad / hess within B1's bound.  Then
    B6 is timed on the main path's root and on WIDE_SEGMENT_ROWS rows,
    beside what it replaces per split (B2, then B1 on the smaller child),
    its plain version and a library composition.  Returns its record."""
    i32 = dict(dtype=torch.int32, device=dev)
    lv, rv = torch.tensor(-0.25, device=dev), torch.tensor(0.75, device=dev)
    err = 0.0
    for rows, f, nb in MERGED_SHAPES:
        rows = rows or n
        cols = cols_of(f)
        hk = dict(num_features=f, grad_col=cols["grad"],
                  hess_col=cols["hess"], cnt_col=cols["cnt"])
        pay = make_payload(rows, f, f + 10, seed + f, dev, num_bins=nb)
        preds = predicates(dev, nb)
        cases = [(name, 0, rows) for name in preds] + [
            ("numerical", 100, 37), ("nan_missing_default_left", 500, 0),
            ("zero_missing", 777, 1), ("efb_offset", 12345, rows // 3)]
        for name, s, c in cases:
            what = "B6 %s at F=%d, B=%d (%d, %d)" % (name, f, nb, s, c)
            a_pay, a_aux = pay.clone(), aux_like(pay)
            a_pay, a_aux, a_nl, a_hl, a_hr = \
                cuda_segment.partition_segment_hist(
                    a_pay, a_aux, torch.tensor(s, **i32),
                    torch.tensor(c, **i32), preds[name], lv, rv,
                    cols["value"], nb, **hk)
            torch.cuda.synchronize()
            b_pay, b_aux = pay.clone(), aux_like(pay)
            b_pay, b_aux, b_nl, b_hl, b_hr = seg.partition_segment_hist(
                b_pay, b_aux, s, c, preds[name], lv, rv, cols["value"], nb,
                **hk)
            same_partition(what, (a_pay, a_aux, a_nl), (b_pay, b_aux, b_nl),
                           s, c)
            nl = int(b_nl)
            for got, plain, hs, hc in ((a_hl, b_hl, s, nl),
                                       (a_hr, b_hr, s + nl, c - nl)):
                check(torch.equal(got[..., 2], plain[..., 2]),
                      "%s: count channel vs plain" % what)
                err = max(err, hist_errors(b_pay, hs, hc, f, got, nb))
            del a_pay, a_aux, b_pay, b_aux, a_hl, a_hr, b_hl, b_hr
        del pay

    # times on fresh rows at the main path's root (n rows, F = 28, P = 38),
    # numerical split
    pay = make_payload(n, F, P, seed, dev)
    aux = torch.zeros_like(pay)
    hk = dict(num_features=F, grad_col=COLS["grad"], hess_col=COLS["hess"],
              cnt_col=COLS["cnt"])
    pred = predicates(dev)["numerical"]
    start0 = torch.zeros((), **i32)
    reps = 20
    rec = {}
    for suffix, rows in (("", n), ("_%d_rows" % WIDE_SEGMENT_ROWS,
                                   WIDE_SEGMENT_ROWS)):
        ct = torch.tensor(rows, **i32)
        rec["ms" + suffix] = time_fresh_ms(
            lambda: cuda_segment.partition_segment_hist(
                pay, aux, start0, ct, pred, lv, rv, COLS["value"], B, **hk),
            pay, 0, rows, reps)
        # what B6 replaces per split: B2, then B1 on the smaller child
        nl = int(seg.go_left_chunk(pay[:rows], pred).sum())
        h_st, h_ct = (0, nl) if nl <= rows - nl else (nl, rows - nl)
        h_st, h_ct = torch.tensor(h_st, **i32), torch.tensor(h_ct, **i32)

        def b2_b1():
            cuda_segment.partition_segment(pay, aux, start0, ct, pred, lv, rv,
                                           COLS["value"])
            cuda_segment.segment_histogram(pay, h_st, h_ct, num_bins=B, **hk)

        rec["b2_b1_ms" + suffix] = time_fresh_ms(b2_b1, pay, 0, rows, reps)
    rec["plain_ms"] = time_fresh_ms(lambda: seg.partition_segment_hist(
        pay, aux, 0, n, pred, lv, rv, COLS["value"], B, **hk), pay, 0, n, 3)
    # yardstick, a composition (no one PyTorch call computes B6): a
    # stable argsort of the routing (computed beforehand), an index_select
    # of the rows into aux, and one index_add_ per child (its cells and
    # values computed beforehand)
    rows = pay[:n]
    right = (~seg.go_left_chunk(rows, pred)).to(torch.uint8)
    order = torch.argsort(right, stable=True)
    nl = int((right == 0).sum())
    lib = []
    for part in (order[:nl], order[nl:]):
        r = rows[part]
        flat = (r[:, :F].long() + torch.arange(F, device=dev)[None, :] * B) \
            .reshape(-1)
        vals = torch.stack([r[:, COLS["grad"]], r[:, COLS["hess"]],
                            r[:, COLS["cnt"]]], 1)[:, None, :] \
            .expand(len(part), F, 3).reshape(-1, 3).contiguous()
        lib.append((torch.zeros(F * B, 3, device=dev), flat, vals))
    del order, r

    def library():
        torch.index_select(rows, 0, torch.argsort(right, stable=True),
                           out=aux[:n])
        for out, flat, vals in lib:
            out.index_add_(0, flat, vals)

    rec["library_ms"] = time_ms(library, reps)
    del lib, right, aux, pay
    rec["bound_ms"], rec["bound_by"] = bound(2 * n * P * 4 + 2 * F * B * 12,
                                             n * F * 3)
    rec.update(name="partition_segment_hist", route="cuda",
               source="lightgbm_tpu_torch/csrc/segment_partition_hist.cu",
               replaces="lightgbm_tpu/ops/pallas_segment.py:1682",
               max_abs_err=err,
               library="stable argsort + index_select + two index_add_")
    return rec


# ---------------------------------------------------------------------------
# phase: the wide kernels
# ---------------------------------------------------------------------------

def device_payload(n: int, f: int, p: int, seed: int, dev) -> torch.Tensor:
    """make_payload's layout drawn on the device (the wide payloads are
    gigabytes): integer bins < B in [0, f), normal value columns, a 0/1
    count mask, guard rows zero."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pay = torch.zeros((n + seg.GUARD, p), device=dev)
    pay[:n, :f].random_(0, B, generator=gen)
    pay[:n, f:].normal_(generator=gen)
    pay[:n, f + 2] = (torch.rand(n, generator=gen, device=dev) < 0.9).float()
    return pay


def stage_commit(pay, aux, start, count, pred, left_value, right_value,
                 value_col: int):
    """B2 as the frontier grower runs it: the stage, then the commit."""
    aux, nl = cuda_segment.partition_segment_stage(pay, aux, start, count,
                                                   pred)
    pay = cuda_segment.partition_segment_commit(pay, aux, start, count, nl,
                                                left_value, right_value,
                                                value_col)
    return pay, aux, nl


#: aux's fill before every checked partition, so a write outside the
#: segment shows
AUX_FILL = -7.5
#: runs of B2 whole and B8 on fresh copies of the root segment per
#: predicate, each held to the plain partition, so an ordering race shows
WHOLE_REPEATS = 10


def aux_like(pay: torch.Tensor) -> torch.Tensor:
    return torch.full_like(pay, AUX_FILL)


def whole_partition(fn) -> bool:
    """True for the whole partitions with the Pallas kernels' contract
    (B2 whole, B8): aux over the segment is scratch."""
    return fn in (cuda_segment.partition_segment,
                  cuda_segment.partition_segment_blocks)


def partition_equal(fns, pay, pred, s: int, c: int, vcol: int,
                    repeats: int = 1) -> None:
    """Run each partition wrapper in `fns` (a whole partition `repeats`
    times) and the plain version on copies of `pay`; raises unless they
    agree as same_partition holds them."""
    i32 = dict(dtype=torch.int32, device=pay.device)
    lv = torch.tensor(-0.25, device=pay.device)
    rv = torch.tensor(0.75, device=pay.device)
    plain = seg.partition_segment(pay.clone(), aux_like(pay), s, c, pred, lv,
                                  rv, vcol)
    for fn in fns:
        whole = whole_partition(fn)
        for _ in range(repeats if whole else 1):
            got = fn(pay.clone(), aux_like(pay), torch.tensor(s, **i32),
                     torch.tensor(c, **i32), pred, lv, rv, vcol)
            torch.cuda.synchronize()
            same_partition("%s (%d, %d)" % (fn.__name__, s, c), got, plain,
                           s, c, full_aux=not whole)
            del got


def same_partition(what: str, got, plain, s: int, c: int,
                   full_aux: bool = True) -> None:
    """Raises unless two (payload, aux, num_left) results, both from aux
    filled alike, agree byte for byte: num_left, the whole payload, aux
    outside the segment [s, s + c) and, with full_aux, aux over it."""
    (a_pay, a_aux, a_nl), (b_pay, b_aux, b_nl) = got, plain
    check(int(a_nl) == int(b_nl), "%s: num_left %d vs %d"
          % (what, int(a_nl), int(b_nl)))
    check(torch.equal(a_pay.view(torch.int32), b_pay.view(torch.int32)),
          "%s: payload not byte-identical" % what)
    check(torch.equal(a_aux[:s].view(torch.int32), b_aux[:s].view(torch.int32))
          and torch.equal(a_aux[s + c:].view(torch.int32),
                          b_aux[s + c:].view(torch.int32)),
          "%s: aux written outside the segment" % what)
    if full_aux:
        check(torch.equal(a_aux[s:s + c].view(torch.int32),
                          b_aux[s:s + c].view(torch.int32)),
              "%s: aux not byte-identical" % what)


def plain_hist_chunked(pay, n: int, hk: dict, chunk: int = WIDE_CMP_ROWS):
    """The plain histogram of rows [0, n), summed over row chunks that fit
    its rows * F * 3 index tensor on the card."""
    out = seg.segment_histogram(pay, 0, min(chunk, n), **hk)
    for s in range(chunk, n, chunk):
        out += seg.segment_histogram(pay, s, min(chunk, n - s), **hk)
    return out


#: the kernels timed at the wide shapes: B7, B3, B8, and B1 / B2 beside
#: them for the crossover
WIDE_TIMED = ("segment_histogram_colblock", "partition_segment_rmw",
              "partition_segment_blocks", "segment_histogram",
              "partition_segment")
#: a segment size between the root and the small leaves at which the wide
#: phase times them again (CUDA events on smaller segments time the
#: wrapper's host cost, not the kernel)
WIDE_SEGMENT_ROWS = 131_072


def wide_kernels_phase(seed: int, dev) -> dict:
    """At the Bosch (F = 968, P = 978) and Epsilon (F = 2000, P = 2010)
    shapes, every kernel a training path can launch there is held against
    its plain version on segments of the first 65,536 rows: B7 and B1 to
    B1's bound with an exact count channel, B4 at the int8 and int16 grids
    and B5 in int32 bit for bit, B5 in f32 to B1's bound, and B3, B8, B2
    and B2's stage + commit on every predicate as same_partition holds
    them; B8 also WHOLE_REPEATS times on the full root segment of the wide
    path's padded rows under every predicate.  Then the kernels of
    WIDE_TIMED are timed on that root, with bound, plain and library
    times, and on a segment of WIDE_SEGMENT_ROWS rows (the partitions on
    fresh rows), and B8 at the other TIMED_SPLITS.  Returns {kernel: {F:
    record}}."""
    preds = predicates(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = {}
    reps = 10
    for f, rows in WIDE:
        n = -(-rows // 16384) * 16384      # the Dataset's padded rows
        p = f + 10
        cols = cols_of(f)
        hk = dict(num_features=f, num_bins=B, grad_col=cols["grad"],
                  hess_col=cols["hess"], cnt_col=cols["cnt"])
        pay = device_payload(n, f, p, seed + f, dev)
        m = WIDE_CMP_ROWS
        small = pay[:m + 4096 + seg.GUARD].clone()
        small[m + 4096:] = 0.0
        segments = ((0, m), (100, 37), (500, 0), (12345, m // 3))
        rec = {}

        for name in ("segment_histogram_colblock", "segment_histogram"):
            fn, err = getattr(cuda_segment, name), 0.0
            for s, c in segments:
                got = fn(small, torch.tensor(s, **i32), torch.tensor(c, **i32),
                         **hk)
                torch.cuda.synchronize()
                plain = seg.segment_histogram(small, s, c, **hk)
                check(torch.equal(got[..., 2], plain[..., 2]),
                      "%s count channel vs plain at F=%d (%d, %d)"
                      % (name, f, s, c))
                err = max(err, hist_errors(small, s, c, f, got))
                del got, plain
            rec[name] = dict(max_abs_err=err)

        # the quantized and frontier paths keep B4, B5 and B2's stage /
        # commit at every width
        qpays = {qmax: quantize_columns(small, m + 4096, qmax, seed + qmax,
                                        cols)
                 for qmax in (127, quantize.derive_qmax(n, "int16"))}
        for qmax, qpay in qpays.items():
            for s, c in segments:
                got = cuda_segment.segment_histogram_quant(
                    qpay, torch.tensor(s, **i32), torch.tensor(c, **i32), **hk)
                torch.cuda.synchronize()
                plain = seg.segment_histogram(qpay, s, c, quantized=True, **hk)
                check(got.dtype == torch.int32 and torch.equal(got, plain),
                      "int32 histogram differs from plain at F=%d, qmax %d "
                      "(%d, %d)" % (f, qmax, s, c))
                del got, plain
        rec["segment_histogram_quant"] = dict(max_abs_err=0.0)
        starts, counts = batch_segments(m, (m // 5, 1, 0, 37, m // 9,
                                            m // 16 + 3, m // 3, m // 10 + 3))
        st_t, ct_t = torch.tensor(starts, **i32), torch.tensor(counts, **i32)
        got = cuda_segment.segment_histogram_batched(small, st_t, ct_t, **hk)
        torch.cuda.synchronize()
        plain = seg.segment_histogram_batched(small, starts, counts, **hk)
        check(torch.equal(got[..., 2], plain[..., 2]),
              "batched histogram count channel differs from plain at F=%d"
              % f)
        del plain
        err = max(hist_errors(small, s, c, f, got[k])
                  for k, (s, c) in enumerate(zip(starts, counts)))
        del got
        for qmax, qpay in qpays.items():
            got = cuda_segment.segment_histogram_batched(
                qpay, st_t, ct_t, quantized=True, **hk)
            torch.cuda.synchronize()
            plain = seg.segment_histogram_batched(qpay, starts, counts,
                                                  quantized=True, **hk)
            check(got.dtype == torch.int32 and torch.equal(got, plain),
                  "int32 batched histogram differs from plain at F=%d, "
                  "qmax %d" % (f, qmax))
            del got, plain
        rec["segment_histogram_batched"] = dict(max_abs_err=err,
                                                max_abs_err_int32=0.0)
        del qpays

        cases = [(name, 0, m) for name in preds] + [
            ("numerical", 100, 37), ("nan_missing_default_left", 500, 0),
            ("categorical", 777, m // 2), ("efb_offset", 12345, m // 3)]
        for name, s, c in cases:
            partition_equal((cuda_segment.partition_segment_rmw,
                             cuda_segment.partition_segment_blocks,
                             cuda_segment.partition_segment, stage_commit),
                            small, preds[name], s, c, cols["value"])
        for name in ("partition_segment_rmw", "partition_segment_blocks",
                     "partition_segment"):
            rec[name] = dict(max_abs_err=0.0)
        rec["partition_segment"]["stage_commit_max_abs_err"] = 0.0
        del small
        for r in rec.values():
            r["checked_rows"] = m

        # B8 partitioned WHOLE_REPEATS times on fresh copies of the root
        # under every predicate kind
        for name in preds:
            partition_equal((cuda_segment.partition_segment_blocks,), pay,
                            preds[name], 0, n, cols["value"],
                            repeats=WHOLE_REPEATS)
        rec["partition_segment_blocks"]["repeats_identical"] = WHOLE_REPEATS
        torch.cuda.empty_cache()

        start0, count = torch.zeros((), **i32), torch.tensor(n, **i32)
        part_ct = torch.tensor(WIDE_SEGMENT_ROWS, **i32)
        lv = torch.tensor(-0.25, device=dev)
        rv = torch.tensor(0.75, device=dev)
        aux = torch.zeros_like(pay)
        for name in WIDE_TIMED:
            fn = getattr(cuda_segment, name)
            for key, ct in (("ms", n), ("ms_%d_rows" % WIDE_SEGMENT_ROWS,
                                        WIDE_SEGMENT_ROWS)):
                ct_t = torch.tensor(ct, **i32)
                if name.startswith("segment_histogram"):
                    rec[name][key] = time_ms(
                        lambda: fn(pay, start0, ct_t, **hk), reps)
                else:
                    rec[name][key] = time_fresh_ms(lambda: fn(
                        pay, aux, start0, ct_t, preds["numerical"], lv, rv,
                        cols["value"]), pay, 0, ct, reps)
            rec[name].update(n=n, P=p)
        hist_plain_ms = time_ms(lambda: plain_hist_chunked(pay, n, hk), 1)
        flat = (pay[:n, :f].long()
                + torch.arange(f, device=dev)[None, :] * B).reshape(-1)
        vals = torch.stack([pay[:n, cols["grad"]], pay[:n, cols["hess"]],
                            pay[:n, cols["cnt"]]], 1)[:, None, :] \
            .expand(n, f, 3).reshape(-1, 3).contiguous()
        lib_out = torch.zeros(f * B, 3, device=dev)
        hist_lib_ms = time_ms(lambda: lib_out.index_add_(0, flat, vals), reps)
        del flat, vals, lib_out
        hist_bound = bound(n * (f + 3) * 4 + f * B * 3 * 4, n * f * 3)
        for name in ("segment_histogram_colblock", "segment_histogram"):
            rec[name].update(plain_ms=hist_plain_ms, library_ms=hist_lib_ms,
                             bound_ms=hist_bound[0], bound_by=hist_bound[1])
        # the partitions' plain version and yardstick at the root, at each
        # of the TIMED_SPLITS; B8 timed there too
        part_bound = bound(2 * n * p * 4, 0)
        for suffix, thr in TIMED_SPLITS.items():
            pred = make_pred(dev, B, 3, thr)
            plain_ms = time_fresh_ms(lambda: seg.partition_segment(
                pay, aux, 0, n, pred, lv, rv, cols["value"]), pay, 0, n, 1)
            right = (~seg.go_left_chunk(pay[:n], pred)).to(torch.uint8)
            lib_ms = time_ms(lambda: torch.index_select(
                pay[:n], 0, torch.argsort(right, stable=True), out=aux[:n]),
                reps)
            left_share = 1.0 - float(right.float().mean())
            del right
            for name in ("partition_segment_rmw", "partition_segment_blocks",
                         "partition_segment"):
                rec[name].update({"plain_ms" + suffix: plain_ms,
                                  "library_ms" + suffix: lib_ms,
                                  "left_share" + suffix: left_share,
                                  "bound_ms" + suffix: part_bound[0]})
            if not suffix:
                for name in ("partition_segment_rmw",
                             "partition_segment_blocks"):
                    fn = getattr(cuda_segment, name)
                    rec[name]["breakdown_us"] = kernel_breakdown(
                        lambda: fn(pay, aux, start0, count, pred, lv, rv,
                                   cols["value"]), pay, 0, n)
            else:
                rec["partition_segment_blocks"]["ms" + suffix] = \
                    time_fresh_ms(
                        lambda: cuda_segment.partition_segment_blocks(
                            pay, aux, start0, count, pred, lv, rv,
                            cols["value"]), pay, 0, n, reps)
        for name in ("partition_segment_rmw", "partition_segment_blocks",
                     "partition_segment"):
            rec[name]["bound_ms_%d_rows" % WIDE_SEGMENT_ROWS] = bound(
                2 * WIDE_SEGMENT_ROWS * p * 4, 0)[0]
            rec[name]["bound_by"] = part_bound[1]
        del aux, pay
        for name, r in rec.items():
            out.setdefault(name, {})[f] = r
        torch.cuda.empty_cache()
    return out


WIDE_SOURCES = {
    "segment_histogram_colblock": (
        "lightgbm_tpu_torch/csrc/segment_hist_colblock.cu",
        "lightgbm_tpu/ops/pallas_segment.py:1005"),
    "partition_segment_rmw": (
        "lightgbm_tpu_torch/csrc/segment_partition_wide.cu",
        "lightgbm_tpu/ops/pallas_segment.py:1210"),
    "partition_segment_blocks": (
        "lightgbm_tpu_torch/csrc/segment_partition_wide.cu",
        "lightgbm_tpu/ops/pallas_segment.py:2062"),
}


# ---------------------------------------------------------------------------
# phases: parity and main path
# ---------------------------------------------------------------------------

def train_params(num_leaves: int, **extra) -> dict:
    return dict(dict(objective="binary", num_leaves=num_leaves, max_bin=255,
                     learning_rate=0.1, verbose=-1), **extra)


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


#: the wrappers whose launch counts each training path reads
COUNTED = ("segment_histogram", "segment_histogram_quant",
           "segment_histogram_batched", "partition_segment",
           "partition_segment_stage", "partition_segment_commit",
           "segment_histogram_colblock", "partition_segment_rmw",
           "partition_segment_blocks", "partition_segment_hist")
#: the kernels of the wide paths, which no narrow path may launch
WIDE_ONLY = ("segment_histogram_colblock", "partition_segment_rmw",
             "partition_segment_blocks")


def reset_counts() -> None:
    for name in COUNTED:
        getattr(cuda_segment, name).launches = 0


def read_counts() -> dict:
    return {name: getattr(cuda_segment, name).launches for name in COUNTED}


def make_main_data(rows: int, seed: int, params: dict) -> tuple:
    """The main path's data: `rows` training rows binned once (every
    training path shares the binned Dataset) and 100k held-out rows."""
    n_valid = 100_000
    X, y = synth(rows + n_valid, F, seed)
    t0 = time.perf_counter()
    ds = lt.Dataset(X[:rows], label=y[:rows])
    ds.construct(lt.Config(params))
    return ds, X[rows:], y[rows:], time.perf_counter() - t0


def train_path(name: str, ds, Xv, yv, params: dict, iters: int) -> dict:
    """Train one configuration of the main path through
    lightgbm_tpu_torch.train on the card, with every launch count set to
    0 just before and read just after; predict the held-out rows."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = lt.train(params, ds, iters, verbose_eval=False)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(bst.device.type == "cuda", "%s ran on %s" % (name, bst.device))
    check(bst.current_iteration() == iters, "%s trained %d of %d iterations"
          % (name, bst.current_iteration(), iters))
    check(not any(launches[k] for k in WIDE_ONLY),
          "%s launched a wide kernel: %s"
          % (name, {k: launches[k] for k in WIDE_ONLY}))
    t0 = time.perf_counter()
    pred = bst.predict(Xv)
    t_pred = time.perf_counter() - t0
    check(pred.shape == (len(yv),) and bool(np.isfinite(pred).all()),
          "%s: held-out predictions malformed" % name)
    auc = auc_score(yv, pred)
    check(auc > 0.8, "%s: held-out AUC %.4f too low" % (name, auc))
    leaves = [t.num_leaves for t in bst._model.trees]
    syncs = bst.host_syncs_per_tree()
    t0 = bst._model.trees[0]
    return dict(name=name, bst=bst, model_text=bst.model_to_string(),
                launches=launches, auc=auc, splits=sum(leaves) - len(leaves),
                first_split=(int(t0.split_feature[0]),
                             int(t0.threshold_in_bin[0])),
                s_per_iter=t_train / iters, t_train=t_train, t_pred=t_pred,
                peak=peak, syncs=syncs, leaves=leaves,
                splits_per_tree=float(np.mean(leaves)) - 1.0,
                rounds_per_tree=bst.split_rounds_per_tree())


def path_line(r: dict, rows: int, iters: int, extra: str = "") -> str:
    return ("%s: %dx%d, max_bin 255, 255 leaves, lr 0.1, %d iters: "
            "%.4f s/iter (train %.3f s), syncs/tree %s (mean %.2f), split "
            "rounds/tree %.2f, splits/tree %.2f, max_memory_allocated %d B, "
            "held-out AUC %.6f on %d rows (predict %.3f s)%s, launches %s"
            % (r["name"], rows, F, iters, r["s_per_iter"], r["t_train"],
               r["syncs"], float(np.mean(r["syncs"])), r["rounds_per_tree"],
               r["splits_per_tree"], r["peak"], r["auc"], 100_000,
               r["t_pred"], extra, json.dumps(r["launches"])))


def main_path_phase(rows: int, iters: int, seed: int) -> tuple:
    params = train_params(255)
    ds, Xv, yv, t_bin = make_main_data(rows, seed, params)
    r = train_path("main path", ds, Xv, yv, params, iters)
    launches = r["launches"]
    check(launches["segment_histogram"] >= iters,
          "histogram kernel launched %d times" % launches["segment_histogram"])
    check(launches["partition_segment"] > 0, "partition kernel never ran")
    check(launches["partition_segment_hist"] == 0,
          "the main path launched the merged kernel")
    line = path_line(r, rows, iters, ", binning %.3f s" % t_bin)
    return line, r, (ds, Xv, yv)


def checked_partition_phase(data, rows: int, iters: int) -> str:
    """The main path again for `iters` iterations, every B2 call held
    against the plain partition on copies of its inputs: payload and
    num_left byte for byte and aux untouched outside the segment, so an
    ordering race in training shows.  Its launches are not counted
    against any path."""
    ds, Xv, yv = data
    whole = cuda_segment.partition_segment
    calls = []

    def checked(payload, aux, start, count, pred, left_value, right_value,
                value_col):
        before, aux_before = payload.clone(), aux.clone()
        out = whole(payload, aux, start, count, pred, left_value,
                    right_value, value_col)
        plain = seg.partition_segment(before, aux_before, int(start),
                                      int(count), pred, left_value,
                                      right_value, value_col)
        same_partition("B2 in training (%d, %d)" % (int(start), int(count)),
                       out, plain, int(start), int(count), full_aux=False)
        calls.append(int(count))
        return out

    checked.launches = 0
    cuda_segment.partition_segment = checked
    try:
        bst = lt.train(train_params(255), ds, iters, verbose_eval=False)
    finally:
        cuda_segment.partition_segment = whole
    splits = sum(t.num_leaves - 1 for t in bst._model.trees)
    check(len(calls) == splits, "checked %d B2 calls for %d splits"
          % (len(calls), splits))
    auc = auc_score(yv, bst.predict(Xv))
    return ("B2 in training: %dx%d, %d iters, %d calls on segments of %d to "
            "%d rows, each byte-identical to the plain partition; held-out "
            "AUC %.6f" % (rows, F, iters, len(calls), min(calls), max(calls),
                          auc))


#: the partition wrappers the merged mode retires
SPLIT_PARTITIONS = ("partition_segment", "partition_segment_stage",
                    "partition_segment_commit", "partition_segment_rmw",
                    "partition_segment_blocks")


def histogram_mode_phases(data, f32: dict, rows: int, iters: int) -> dict:
    """The grower's two other histogram modes at full width, on the main
    path's params and data.  Merged: with
    cuda_segment.PARTITION_HIST_VALIDATED set in-process once the kernels
    phase has held B6 (as bench.py sets the JAX package's flag after its
    probe), every split runs B6 and nothing else of the partition, B1
    runs once per tree (the root), and the first split is the f32 main
    path's; profiled like the main path.  Pooled: histogram_pool_size=2
    (MB) leaves a few dozen slots for 255 leaves, so evicted parents are
    rebuilt by B1 from their rows.  Both within 0.002 of the main path's
    AUC.  Prints one line per path; returns the results by name."""
    ds, Xv, yv = data
    runs = {}
    cuda_segment.PARTITION_HIST_VALIDATED = True
    r = train_path("merged", ds, Xv, yv, train_params(255), iters)
    n = r["launches"]
    g = r["bst"]._engine.grower
    check((g.hist_engine, g.part_engine) == ("partition_segment_hist",) * 2,
          "merged path took %s" % ((g.hist_engine, g.part_engine),))
    check(n["partition_segment_hist"] == r["splits"],
          "merged path: B6 launched %d times for %d splits"
          % (n["partition_segment_hist"], r["splits"]))
    check(not any(n[k] for k in SPLIT_PARTITIONS),
          "merged path launched a partition kernel: %s"
          % {k: n[k] for k in SPLIT_PARTITIONS})
    check(n["segment_histogram"] == iters,
          "merged path: B1 launched %d times for %d trees"
          % (n["segment_histogram"], iters))
    check(r["first_split"] == f32["first_split"],
          "merged path: first split %s vs %s on the f32 main path"
          % (r["first_split"], f32["first_split"]))
    note = ", first split %s as on the f32 main path" % (r["first_split"],)
    say(path_line(r, rows, iters, note + auc_note(r, f32)))
    say(profile_phase(r["bst"], "merged"))
    cuda_segment.PARTITION_HIST_VALIDATED = False
    runs["merged"] = r
    del r["bst"]

    r = train_path("pooled", ds, Xv, yv,
                   train_params(255, histogram_pool_size=2), iters)
    n = r["launches"]
    slots = r["bst"]._engine.grower_cfg.hist_pool_slots
    rebuilds = n["segment_histogram"] - iters - r["splits"]
    check(0 < slots < 255, "pooled path: %d pool slots" % slots)
    check(rebuilds > 0, "pooled path: no parent rebuilt (B1 %d, %d splits)"
          % (n["segment_histogram"], r["splits"]))
    check(n["partition_segment_hist"] == 0,
          "pooled path launched the merged kernel")
    say(path_line(r, rows, iters, ", %d pool slots, %d parent rebuilds"
                  % (slots, rebuilds) + auc_note(r, f32)))
    runs["pooled"] = r
    del r["bst"]
    return runs


def auc_note(r: dict, f32: dict) -> str:
    """Raises unless the path's AUC is within 0.002 of the f32 main
    path's; returns the note its line carries."""
    d_auc = abs(r["auc"] - f32["auc"])
    check(d_auc <= 0.002, "%s: |dAUC| %.6f against f32 > 0.002"
          % (r["name"], d_auc))
    return ", |dAUC| vs f32 main path %.6f" % d_auc


def quantized_phases(data, f32: dict, rows: int, iters: int) -> dict:
    """The new paths at full width: int8 and int16 quantized gradients,
    f32 with tpu_frontier_batch=8, and int8 with tpu_frontier_batch=8.
    Prints one line per path (and a profile of the int8 and frontier
    paths) as it goes; returns the results by name."""
    ds, Xv, yv = data
    runs = {}
    for name, extra in (
            ("quantized int8", dict(gradient_quantization=True,
                                    gradient_quant_dtype="int8")),
            ("quantized int16", dict(gradient_quantization=True,
                                     gradient_quant_dtype="int16")),
            ("frontier 8", dict(tpu_frontier_batch=8)),
            ("quantized int8 + frontier 8", dict(
                gradient_quantization=True, gradient_quant_dtype="int8",
                tpu_frontier_batch=8))):
        r = train_path(name, ds, Xv, yv, train_params(255, **extra), iters)
        runs[name] = r
        n = r["launches"]
        note = auc_note(r, f32)
        if "quantized" in name:
            check(n["segment_histogram"] == 0,
                  "%s launched the f32 histogram %d times"
                  % (name, n["segment_histogram"]))
            check(n["segment_histogram_quant"] >= iters,
                  "%s: int32 histogram launched %d times"
                  % (name, n["segment_histogram_quant"]))
            note += ", qmax %d" % r["bst"].quant_report["qmax"]
        if "frontier" in name:
            check(n["segment_histogram_batched"] > 0,
                  "%s: batched histogram never ran" % name)
            check(n["partition_segment_stage"] > 0
                  and n["partition_segment_commit"] > 0,
                  "%s: partition stage/commit never ran" % name)
            check(r["rounds_per_tree"] < r["splits_per_tree"],
                  "%s: %.2f rounds/tree not below %.2f splits/tree"
                  % (name, r["rounds_per_tree"], r["splits_per_tree"]))
        if name == "quantized int8 + frontier 8":
            # integer histograms: the trees must be those of the one-leaf
            # loop, node for node
            ref = runs["quantized int8"]
            same = r["model_text"] == ref["model_text"]
            first = next((i for i, (a, b) in enumerate(zip(
                r["model_text"].split("Tree="), ref["model_text"]
                .split("Tree="))) if a != b), None)
            check(same, "quantized frontier trees differ from the one-leaf "
                  "loop's, first at tree %s" % first)
            note += ", model text identical to quantized int8: %s" % same
        say(path_line(r, rows, iters, note))
        if name in ("quantized int8", "frontier 8"):
            say(profile_phase(r["bst"], name))
        del r["bst"]
    return runs


# ---------------------------------------------------------------------------
# phases: the wide paths
# ---------------------------------------------------------------------------

def wide_synth(n_rows: int, n_feat: int, seed: int, dev, nan_frac: float):
    """Bosch- / Epsilon-shaped binary data, drawn on `dev` from `seed`:
    n_feat standard normal features on a grid of 1/64 (a few hundred
    distinct values each), with a nan_frac share of the values of every
    other feature NaN.  The label's signal sits on 32 features spread
    evenly over all n_feat, so every column block matters: a linear term,
    one interaction, one absolute value, one step, and noise.  Returns the
    host float64 [n_rows, n_feat] matrix (column-major, so the binner
    reads each feature contiguously) and the 0/1 labels."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=dev)
    xt = torch.randn((n_feat, n_rows), generator=gen, **f64)
    xt.mul_(64).round_().div_(64)
    xs = xt[torch.linspace(0, n_feat - 1, 32, device=dev).round().long()]
    w = torch.randn(32, generator=gen, **f64)
    logit = (w @ xs) * 0.5 + 0.4 * xs[0] * xs[1] + 0.3 * xs[2].abs() \
        - 0.2 * (xs[3] > 0.5) + 0.8 * torch.randn(n_rows, generator=gen,
                                                  **f64)
    del xs
    if nan_frac > 0:
        xt[1::2].masked_fill_(torch.rand((n_feat // 2, n_rows), generator=gen,
                                         device=dev) < nan_frac, np.nan)
    X = xt.cpu().numpy().T
    y = (logit > 0).double().cpu().numpy()
    del xt, logit
    torch.cuda.empty_cache()
    return X, y


#: NaN share of every other feature on the Bosch-shaped path
WIDE_NAN = {968: 0.2, 2000: 0.0}
#: the wide engines each wide path must take: (histogram, partition)
WIDE_ENGINES = {968: ("segment_histogram_colblock", "partition_segment_rmw"),
                2000: ("segment_histogram_colblock",
                       "partition_segment_blocks")}


def wide_parity_phase(seed: int, dev) -> str:
    """CUDA against CPU training at both wide widths: 10,000 rows, max_bin
    63, 31 leaves, 5 iterations; the first split must agree and the AUC on
    2,000 held-out rows within 0.002; the CUDA run must take the wide
    engines."""
    parts = []
    for f, _ in WIDE:
        X, y = wide_synth(12_000, f, seed + 31 + f, dev, WIDE_NAN[f])
        Xt, yt, Xv, yv = X[:10_000], y[:10_000], X[10_000:], y[10_000:]
        runs = {}
        for d in ("cuda", "cpu"):
            # max_bin 63 keeps the CPU run's split search (plain PyTorch
            # over [2, F, B, 3]) to a quarter of its 255-bin time
            params = train_params(31, max_bin=63) if d == "cuda" \
                else train_params(31, max_bin=63, device_type="cpu")
            bst = lt.train(params, lt.Dataset(Xt, label=yt), 5,
                           verbose_eval=False)
            check(bst.device.type == d, "wide parity run on %s" % bst.device)
            g = bst._engine.grower
            t0 = bst._model.trees[0]
            runs[d] = (int(t0.split_feature[0]), int(t0.threshold_in_bin[0]),
                       auc_score(yv, bst.predict(Xv)),
                       (g.hist_engine, g.part_engine))
        check(runs["cuda"][3] == WIDE_ENGINES[f],
              "wide parity F=%d took %s" % (f, runs["cuda"][3]))
        check(runs["cuda"][:2] == runs["cpu"][:2],
              "wide parity F=%d: first split cuda %s vs cpu %s"
              % (f, runs["cuda"][:2], runs["cpu"][:2]))
        d_auc = abs(runs["cuda"][2] - runs["cpu"][2])
        check(d_auc <= 0.002, "wide parity F=%d: |dAUC| %.6f > 0.002"
              % (f, d_auc))
        parts.append("F=%d first split %s on both, AUC cuda %.6f cpu %.6f "
                     "|dAUC| %.6f" % (f, runs["cuda"][:2], runs["cuda"][2],
                                      runs["cpu"][2], d_auc))
    return ("wide parity: 10000 rows (+2000 held out), max_bin 63, 31 "
            "leaves, 5 iters: "
            + "; ".join(parts))


#: held-out AUC the last iteration of each wide path must pass.  A CPU
#: rehearsal of the same generator read 0.8481 after 10 iterations at
#: 100,000 x 968 (255 leaves) and 0.8200 after 3 at 20,000 x 2,000 (63
#: leaves); the full paths have more rows and iterations.
WIDE_AUC_FLOOR = 0.8


def wide_path_phase(f: int, rows: int, iters: int, seed: int, dev) -> tuple:
    """One wide path through lightgbm_tpu_torch.train at full size, with a
    100,000-row validation set scored every iteration (metric auc).  The
    launch counts are set to 0 just before and read just after.  Returns
    its line and its result."""
    name = "wide %d" % f
    n_valid = 100_000
    t0 = time.perf_counter()
    X, y = wide_synth(rows + n_valid, f, seed + f, dev, WIDE_NAN[f])
    t_gen = time.perf_counter() - t0
    params = train_params(255, metric="auc")
    t0 = time.perf_counter()
    ds = lt.Dataset(X[:rows], label=y[:rows])
    ds.construct(lt.Config(params))
    dv = lt.Dataset(X[rows:], label=y[rows:], reference=ds)
    dv.construct(lt.Config(params))
    t_bin = time.perf_counter() - t0
    Xv, yv = X[rows:], y[rows:]
    del X
    evals = {}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = lt.train(params, ds, iters, valid_sets=[dv], valid_names=["valid"],
                   evals_result=evals, verbose_eval=False)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(bst.device.type == "cuda", "%s ran on %s" % (name, bst.device))
    check(bst.current_iteration() == iters, "%s trained %d of %d iterations"
          % (name, bst.current_iteration(), iters))
    g = bst._engine.grower
    check((g.hist_engine, g.part_engine) == WIDE_ENGINES[f],
          "%s took %s" % (name, (g.hist_engine, g.part_engine)))
    hist_name, part_name = WIDE_ENGINES[f]
    check(launches[hist_name] >= iters and launches[part_name] > 0,
          "%s: %s %d, %s %d launches" % (name, hist_name,
                                         launches[hist_name], part_name,
                                         launches[part_name]))
    check(launches["segment_histogram"] == 0
          and launches["partition_segment"] == 0,
          "%s launched B1 %d and B2 %d times" % (
              name, launches["segment_histogram"],
              launches["partition_segment"]))
    # the valid scores kept on the card against the host model's prediction
    score_dev = bst._engine.raw_valid_score(0)[0]
    t0 = time.perf_counter()
    raw = bst.predict(Xv, raw_score=True)
    t_pred = time.perf_counter() - t0
    check(raw.shape == (len(yv),) and bool(np.isfinite(raw).all()),
          "%s: held-out predictions malformed" % name)
    score_err = float(np.max(np.abs(score_dev - raw)
                             / np.maximum(np.abs(raw), 1.0)))
    check(score_err <= 1e-5, "%s: valid score vs predict %.3g > 1e-5"
          % (name, score_err))
    aucs = evals["valid"]["auc"]
    check(len(aucs) == iters, "%s: %d AUCs for %d iterations"
          % (name, len(aucs), iters))
    auc_metric = create_metrics(["auc"], bst.config)[0]
    auc_metric.init(yv, None, None)
    auc_pred = auc_metric.eval(raw, bst._objective)
    check(abs(aucs[-1] - auc_pred) <= 1e-6,
          "%s: last valid AUC %.8f vs AUC of predict %.8f"
          % (name, aucs[-1], auc_pred))
    check(aucs[-1] > WIDE_AUC_FLOOR, "%s: held-out AUC %.4f not above %.2f"
          % (name, aucs[-1], WIDE_AUC_FLOOR))
    syncs = bst.host_syncs_per_tree()
    line = ("%s: %dx%d (+%d valid), NaN share %.2f on every other feature, "
            "max_bin 255, 255 leaves, lr 0.1, %d iters: %.4f s/iter (train "
            "%.3f s), syncs/tree %s, max_memory_allocated %d B, data %.3f s, "
            "binning %.3f s, predict %.3f s, valid score vs predict max rel "
            "%.3g, valid AUC per iteration %s, AUC of predict %.8f, launches "
            "%s" % (name, rows, f, n_valid, WIDE_NAN[f], iters,
                    t_train / iters, t_train, syncs, peak, t_gen, t_bin,
                    t_pred, score_err, json.dumps(aucs), auc_pred,
                    json.dumps(launches)))
    return line, dict(bst=bst, launches=launches, ds=ds, dv=dv)


def profile_phase(bst, label: str, launched=(), retired=()) -> str:
    """Two more boosting iterations of a trained booster: one timed
    on the host clock alone, then one under torch.profiler.  Prints both
    walls, the profiled iteration's summed kernel time, the device's idle
    share against each wall (the unprofiled one is the reading; the
    profiler slows the host), the ported kernels' launches and device
    time, the wrappers' calls and each partition's device time per call,
    and the kernels that take the most device time.  Raises unless a
    kernel named by each of `launched` ran and none named by `retired`
    did.  Only device activity is recorded: with the ~90k host ops of an
    iteration recorded too, reading the profile took over a minute."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst.update()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    before = read_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    calls = {k: v - before[k] for k, v in read_counts().items()
             if v != before[k]}
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    check(busy > 0, "the profiler saw no device time")
    for name in launched:
        check(any(name in e.key for e in kernels),
              "profile (%s): no %s kernel ran" % (label, name))
    for name in retired:
        check(not any(name in e.key for e in kernels),
              "profile (%s): a %s kernel ran" % (label, name))
    # the histogram kernels share one template: <float> serves B1 and the
    # f32 B5, <int> B4 and the int32 B5; B3 and B8 share their routing.
    # "partition" is B2's kernels (whole, or the stage and commit), and
    # B6's on the merged path
    ported = {}
    for prefixes, name in (
            (("segment_hist_kernel<float>",), "histogram f32"),
            (("segment_hist_kernel<int>",), "histogram int32"),
            (("hist_colblock",), "histogram colblock"),
            (("part_",), "partition"),
            (("part_hist_scatter",), "partition + histogram scatter"),
            (("route_", "rmw_scatter", "flat_copyback", "write_values",
              "block_move", "wide_copy_side"), "partition wide")):
        hits = [e for e in kernels if any(p in e.key for p in prefixes)]
        ported[name] = [sum(e.count for e in hits),
                        round(sum(e.self_device_time_total
                                  for e in hits) / 1e3, 4)]
    # device microseconds per call of the whole partition wrappers
    per_call = {}
    for wrapper, group in (("partition_segment", "partition"),
                           ("partition_segment_rmw", "partition wide"),
                           ("partition_segment_blocks", "partition wide")):
        if calls.get(wrapper):
            per_call[wrapper] = round(ported[group][1] * 1e3
                                      / calls[wrapper], 3)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return ("profile (%s): one iteration %.4f s wall unprofiled, %.4f s "
            "wall profiled, %.4f s summed kernel time (profiled), device idle "
            "share %.4f against the unprofiled wall (%.4f against the "
            "profiled), %d kernel launches; ported kernels [launches, ms]: "
            "%s; wrapper calls %s; partition device us per call %s; top "
            "[name, launches, ms]: %s"
            % (label, wall, wall_prof, busy, 1.0 - busy / wall,
               1.0 - busy / wall_prof, sum(e.count for e in kernels),
               json.dumps(ported), json.dumps(calls), json.dumps(per_call),
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
    say("device: %s | %s | torch %s CUDA %s | kernel build %.2f s"
        % (torch.cuda.get_device_name(0), smi, torch.__version__,
           torch.version.cuda, build_s))
    for name, log in build_logs.items():
        info = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "smem" in ln]
        print("ptxas %s: %s" % (name, " / ".join(info)), flush=True)

    kernels = kernels_phase(1_015_808, args.seed, dev)
    say("kernels: checked against the plain versions at n=1015808, "
        "F=28, P=38, B=256 (+ F=137): %s"
        % json.dumps({k: {kk: v[kk] for kk in ("ms", "plain_ms",
                                               "library_ms", "bound_ms",
                                               "max_abs_err")}
                      for k, v in kernels.items()}))
    merged = merged_kernel_phase(1_015_808, args.seed, dev)
    kernels["partition_segment_hist"] = merged
    say("merged kernel: B6 checked against its plain version on every "
        "predicate kind at n=1015808, F=28, B=256 and n=200000, F=137, "
        "B=64; timed on the root and on %d rows beside B2 + B1 on the "
        "smaller child: %s" % (WIDE_SEGMENT_ROWS, json.dumps(merged)))
    wide = wide_kernels_phase(args.seed, dev)
    say("wide kernels: B7, B3, B8 (and B1, B2, stage + commit, B4, B5) "
        "checked against the plain versions on %d rows, timed with B1 and "
        "B2 on the root segment and on %d rows (Bosch F=968 P=978, Epsilon "
        "F=2000 P=2010, B=256): %s"
        % (WIDE_CMP_ROWS, WIDE_SEGMENT_ROWS, json.dumps(wide)))
    say(parity_phase(args.seed))
    say(wide_parity_phase(args.seed, dev))
    line, main_run, data = main_path_phase(args.rows, args.iters, args.seed)
    say(line)
    # B2 whole runs its count, scan, move and smaller-side copy, never the
    # stage's scatter or the full-segment copy-back
    say(profile_phase(main_run["bst"], "main path",
                      launched=("part_move", "part_copy_side"),
                      retired=("part_scatter", "part_copyback")))
    del main_run["bst"]
    say(checked_partition_phase(data, args.rows, 3))
    runs = histogram_mode_phases(data, main_run, args.rows, args.iters)
    runs.update(quantized_phases(data, main_run, args.rows, args.iters))
    del data
    # each kernel's launches are read from the path it serves; every
    # path's counts stand beside them
    paths = {"main path": main_run["launches"]}
    paths.update({k: v["launches"] for k, v in runs.items()})
    for f, rows in WIDE:
        line, r = wide_path_phase(f, rows, args.iters, args.seed, dev)
        say(line)
        # B8 moves in place and copies the smaller side back; B3 keeps its
        # scatter, copy-back and value pass
        say(profile_phase(r["bst"], "wide %d" % f, **(
            dict(launched=("block_move", "wide_copy_side"),
                 retired=("write_values", "flat_copyback"))
            if f == 2000 else
            dict(launched=("rmw_scatter", "flat_copyback", "write_values"),
                 retired=("block_move",)))))
        paths["wide %d" % f] = r["launches"]
        del r
        torch.cuda.empty_cache()
    serves = {"segment_histogram": "main path",
              "partition_segment": "main path",
              "segment_histogram_quant": "quantized int8",
              "segment_histogram_batched": "frontier 8",
              "segment_histogram_colblock": "wide 968",
              "partition_segment_rmw": "wide 968",
              "partition_segment_blocks": "wide 2000",
              "partition_segment_hist": "merged"}
    for key, (source, replaces) in WIDE_SOURCES.items():
        at = wide[key][int(serves[key].split()[1])]
        kernels[key] = dict(
            {k: at[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                                "bound_ms", "bound_by")},
            name=key, route="cuda", source=source, replaces=replaces)
    record = []
    for key, rec in kernels.items():
        rec = dict(rec, launches=paths[serves[key]][key], path=serves[key],
                   launches_by_path={p: c[key] for p, c in paths.items()})
        if key in wide:
            # its checks at both wide shapes (B1 and B2 timed there too)
            rec["wide_by_shape"] = wide[key]
        if key == "partition_segment":
            for half in ("stage", "commit"):
                name = "partition_segment_" + half
                rec[half + "_launches"] = paths["frontier 8"][name]
                rec[half + "_launches_by_path"] = {
                    p: c[name] for p, c in paths.items()}
        record.append(rec)
    print(json.dumps({"kernels": record}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
