"""Chip smoke test of the PyTorch/CUDA port (lightgbm_tpu_torch) on one GPU.

    python3 chip_smoke.py [--rows N] [--iters N] [--seed N]

Builds the hand-written kernels from lightgbm_tpu_torch/csrc with nvcc
(and, beside them, the C ABI's two libraries with g++: capi.ensure_built),
holds each against its plain PyTorch version at main-path shapes: the f32
histograms B1, B5 f32 and B6's bit for bit to the fixed-point plain
version (ops/segment.segment_histogram_fixed; they sum in fixed point, so
no order of the adds shows), the int32 histogram B4 at the int8 and int16
grids and B5 int32 bit for bit to the int32 plain version, B5 at K = 1, 3
and 8 segments with empty and one-row ones, the partition B2 whole and as
its stage and commit halves, and the merged partition + histogram B6 (also
at 137 features and 64 bins); and at the wide shapes
(Bosch: 968 features, Epsilon: 2,000; the column-block histogram B7,
bit for bit also on both full roots, the RMW partition B3 and the
column-block partition B8, and B1, B2, B4, B5 and the stage and commit
there too).  It times each beside its bound and a PyTorch yardstick (B1
and B2 at the wide shapes too; the partitions on fresh rows, B2, B3 and
B8 also at 90/10 and 10/90 splits; B7 also with wide 968's NaN share;
B4, B5 and the stage + commit with a per-kernel breakdown), holds the
kernels' work split to its Python form and B1, B4, B5, B6 and B7 to their
plain versions at the segment sizes the grower passes and at those that
give each of the histogram's row layouts, times B1, B6 and B1's
index_add_ yardstick at the segment sizes the grower passes (1,024 to
131,072 rows; device us per call), sweeps the whole partitions over
payload widths and the f32 histograms over feature counts for the card's
crossovers, checks that CUDA and CPU training agree on small problems at
28, 968 and 2,000 features, then trains through lightgbm_tpu_torch.train
on the card (binary objective, max_bin 255, 255 leaves, lr 0.1): on 28
dense features the f32 main path (then two iterations of it with every
B2 call held against the plain partition, and the census of its trees'
B1 and B6 segment sizes with their byte bound per iteration), the
grower's merged mode (B6 on every split, with
lightgbm_tpu_torch.ops.cuda_segment.PARTITION_HIST_VALIDATED set once B6
has been held) and its histogram pool (histogram_pool_size=2, parents
rebuilt), then quantized gradients (int8, int16), the frontier-batched
grower (tpu_frontier_batch=8) and the two together; then the wide paths,
1M x 968 (a fifth of every other feature NaN) and 400k x 2,000, each with
a 100k-row validation set scored every iteration (metric auc).
The repeat check trains the main, merged and frontier 8 paths, and wide
968 for 3 iterations, twice more from the same binned data, the first
run under torch.use_deterministic_algorithms(True, warn_only=True) (its
warnings are printed): the model texts must be byte-identical (and the
path's own run's), every f32 histogram, every split search's outputs and
the final scores bit-identical; the model text's sha256 is printed so
that calls can be compared.
The whole partitions B2, B3, B8 and B6's partition are held to the
Pallas kernels' contract (payload and num_left byte for byte, aux
untouched outside the segment, scratch inside it; ten runs on fresh
copies of the root per predicate, B3 on the Bosch root); the stage and
stage + commit also to the plain version's aux.
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
prediction).  After the main, merged, quantized int8, frontier, int8 +
frontier and wide paths, two more iterations are timed, the second under
torch.profiler (each histogram's and partition's device us per call; after the merged
path, whether its B6 takes less device time per iteration than the main
path's B1 + B2).
Each tree is one device program (lightgbm_tpu_torch/runtime/graphs.py):
every training path's grow() runs under
torch.cuda.set_sync_debug_mode("error") and must show one blocking sync
per tree; each kernel is held on a count-0 segment (payload and aux bit
for bit, num_left 0, histograms zero); one captured split step is
replayed twice on the same input, bit for bit; the main path's model
text with jit=False (the same steps eagerly) must be the graphs'; an
early-stopping path (min_data_in_leaf=50000, trees near 16 leaves) is
held to jit=False too and prints the steps it enqueued and the device
and host cost of a no-op step.  Each path line gives its graph replays,
each profile line its host enqueue calls (kernel and graph launches,
copies and fills) beside the device kernels and the idle share.
Prediction on the card (lightgbm_tpu_torch/models/device_predictor.py):
the main path's model predicts the held-out rows with device=True against
the host's f64 predict (rtol 1e-5 / atol 1e-6, AUC within 1e-6, binary
early stop, out_dtype=float32 the exact downcast); at bench.py's serving
shape (1,000,000 x 28 rows, a 500-tree x 255-leaf synthetic model) the
steady rows/s, the host's on 20,000 rows (max |diff| within 1e-5), depth
iterations, captures per bucket, micro-batches, peak memory and the bound
per depth level are printed, every bucket from 16 to 2^15 rows and
batch_rows=128 must equal the full call bit for bit and int8 leaves stay
within their grid bound; the predict calls run under
torch.cuda.set_sync_debug_mode("error") but for one output fetch per
micro-batch.  Categorical training: airline-shaped data (the ASA Data
Expo 2009 flights as szilard/benchm-ml uses them: six categorical columns
of 12 to 300 levels, DepTime, Distance; 1,000,000 rows, 100,000 held out)
must make categorical splits, launch B1 and B2 and no wide kernel, beat
the same columns treated as numeric on held-out AUC, keep valid scores
equal to predict(raw_score=True) and predict(device=True) equal to the
host's, pass the repeat check, write the same model text at frontier 8,
hold every B2 call of one iteration (bitset predicates among them) to
the plain partition and agree with the CPU on a 20,000-row cut; its
device kernels per split step are printed beside the main path's.
Every single-model objective: B1 at the year path's width (F = 90,
P = 100) held against its plain version and timed; the main path's data
bagged (bagging_fraction=0.5, bagging_freq=1; the repeat check, the
count column against the host RNG's bag, held-out AUC of at least 0.8,
frontier 8 writing the one-leaf model text, and with int8 gradients and
its repeat check); objective=regression on YearPredictionMSD-shaped data
(463,715 x 90, 51,630 held out, a year-like label; valid scores equal
to predict(raw_score=True), held-out RMSE below 0.9 of the label's std,
the repeat check, device kernels per split step); objective=regression_l1
on it for 5 iterations with leaf renewal (two blocking syncs per tree,
one tree's leaf values renew_leaf_values of its fetched partition and
pre-tree scores bit for bit, the repeat check).
K trees per iteration and ranking: objective=multiclass (num_class 7) on
Covertype-shaped data (581,012 x 54: 10 numeric columns, 4 wilderness and
40 soil one-hot columns, 7 cover types in the real shares; 100,000 rows
held out, enable_bundle=false) with the held-out rows scored every
iteration (7 trees an iteration, one blocking sync per tree, B1 and B2
and no other kernel, multi_error below the majority class's, valid
scores equal to predict(raw_score=True), predict(device=True) [N, 7]
against the host's, the gradient fill's cost, the no-op step's, B1 on
the path's own payload (P = 77) against its plain version, one
iteration's profile), then 3 iterations each of multiclassova, the
one-leaf loop, frontier 8 (the one-leaf model text byte for byte; B5 and
the stage + commit) and int8 (B4), one iteration with every B2 call
(P = 77) held against the plain partition, and the path's repeat check;
objective=lambdarank (ndcg at 1, 3, 5, 10) on MSLR-WEB30K-shaped data
(2,270,296 x 136 in ~18,900 queries of up to 1,251 documents, relevance
0-4 in the real shares; the last 2,000 queries held out and scored every
iteration: NDCG@10 above the first iteration's and a random ranking's,
the gradient fill's ms and kernels, B1 on the path's own payload
(F = 136, P = 146) against its plain version, one iteration with every
B2 call held against the plain partition, the repeat check); and every
objective but binary on a 20,000-row cut, 2 iterations (multiclass and
multiclassova at K = 3, lambdarank on 20-row queries),
card against CPU (structure equal, leaf values within 3e-4 of a tree's
largest).
Continued training and the Booster / Dataset surface, on the main path's
binned data: init_model (5 iterations saved to a file, 5 more from the
file with the held-out rows scored every iteration: the loaded trees'
text unchanged, the replay's ms and no blocking sync in it, one per new
tree, valid scores equal to predict(raw_score=True), AUC within 0.002 of
the main path's, the same trees from init_model as a Booster, the repeat
check); a host numpy logloss fobj against the builtin binary objective
with boost_from_average=false (the root split equal, AUC within 0.002,
two blocking syncs per tree by label); rollback_one_iter under
bagging_fraction=0.5, bagging_freq=2 (the scores back within 1e-6 of
max(1, |s|), the payload rebuilt in its storage with the graph captures
it cost, the count column the host's bag) and a learning_rates schedule
(each tree's shrinkage); cv with three stratified folds over the 1M
rows, 3 iterations (the keys, each fold's last valid logloss against its
booster's prediction of its test rows within 1e-5, every fold's B1 and
B2 launches); refit of the main model on the held-out rows (decay 1
keeps every leaf, the default decay lowers their logloss).
Boosting variants, forced splits and monotone constraints, on the main
path's binned data (B1 and B2 and no other kernel, one blocking sync a
tree, a repeat check each): boosting=goss (top_rate 0.2, other_rate 0.1,
15 iterations, the last 5 sampled; the first sampled iteration's gweight
and count columns against a numpy selection of the fetched gradients
with the host's threefry, bit for bit, top_k + other_k rows give or
take the ties, the selection's device ms; AUC above 0.8), then GOSS on
the covtype-shaped data (K 7, lr 0.5, 4 iterations, its
once-an-iteration selection checked alike); boosting=dart with its
defaults (the drop lists against a host replay of Random(4), the
training scores of the first 100,000 rows and the validation scores
against predict(raw_score=True) within 1e-5 of max(1, |raw|), the drop
replay's device ms an iteration); boosting=rf (bagging_fraction 0.632,
bagging_freq 1, feature_fraction 0.7; the scores against the averaged
predict, AUC above 0.8, the fold's device ms); forcedsplits_filename with
the root and both children forced on features 0, 1 and 2 at their
median bin edges (every tree's first three nodes, real gains), and a
left child made infeasible under min_data_in_leaf=20,000 (it falls back,
the right child stays forced); monotone_constraints +1 on features 0-3
and -1 on 4-5 (the walk over every dumped tree, a 64-point sweep of
each constrained feature for 1,000 held-out rows, tpu_frontier_batch=8
writing the same model text); DART and RF continued for 5 iterations
from 5 saved ones (the loaded trees' text, the running average).
The data side: the main path again with the row index split in
radix-4096 halves (its model text and sha256 unchanged); the main
path's Dataset through save_binary and back, 40,000 of its rows as CSV
and LibSVM read by Dataset(path), its rows pushed in 8 positioned
chunks into a stream made by reference and 40,000 through push_rows /
push_rows_csr (bins, and the 3-iteration model text, as in memory);
Expo (1M x 700 one-hot blocks, 100k held out) EFB-bundled to 76 storage
columns, 10 iterations (B1 on its payload; 3 iterations unbundled at
P 710 through B3 beside it, peak memory and the two models compared;
one iteration with every bundle-decoding B2 call held against the plain
partition; the repeat check; 3 iterations of int8); the covtype-shaped
data bundled (3 iterations, then one of frontier 8 writing the one-leaf
model's text); 17,000,000 Higgs-shaped rows (past 2^24), 3 iterations,
the training scores in original order against predict; and one B2 and
one B1 call past the payload's rows, each in a child process, refused
by the kernels' device check.
What the JAX package trains on its masked grower, which the port trains
on the payload with GOSS's selection drawn over the rows in original
order (held bit for bit against the host's), and the scikit-learn
estimators: GOSS with the numpy logloss fobj on the main path's data (lr
0.5, 4 iterations; tree 1 the GBDT fobj run's; AUC above iteration 1's);
LGBMClassifier(n_estimators=10, num_leaves=255) fitted with scikit-learn
absent or hidden (its trees the main path's, predict_proba[:, 1] the main
path's Booster.predict within 1e-6); GOSS with regression_l1 on the year
data (held-out L1 below the constant median's, the host renewal's ms a
tree); GOSS with lambdarank on the rank data (trees 1 and 2 the GBDT
lambdarank run's at lr 0.5, NDCG@10 above iteration 1's and a random
ranking's; the card against the CPU on a 20,000-row cut) and RF with
lambdarank (NDCG@10 above a random ranking's); a repeat check each.
The training runtime's seams, after the main path's repeat check, on
its 1M-row Dataset: `phases` (tpu_profile_phases=true: the model's
sha256 the unprofiled main path's, the phase table with its sum within
the wall time, the profile_sync waits by label); `observe` (telemetry,
tracing and the program ledger on against off, runs in the order off,
on, on, off: the same model text, 10 iterations counted, 1 blocking sync
in the last, no capture, build or cache miss after the first iteration,
one `tree dispatch` instant per tree in the Chrome trace, s/iter of each
run); `profile hook` (LGBM_TPU_PROFILE's torch.profiler trace of 2
iterations, whose device kernels must include B1's and B2's);
`sentinel` (a NaN burst from a host custom objective and nan_grad:3 on
the builtin one: abort raises naming iteration 3 with the JAX package's
field, `leaf values`, rollback returns finished with 3 iterations of
trees and the training and validation scores the pre-iteration ones bit
for bit, syncs per tree printed; without the sentinel, on 20,000 rows,
iteration 3's tree on the card is the CPU's, a stump whose leaf value is
NaN); `resume` (the main path and bagging, snapshots every
iteration with keep-last 3 and their ms: resumed from iteration 5
byte-identical, bagging also from the scan past its truncated last
snapshot) and `cli resume` (`python -m lightgbm_tpu_torch task=train
snapshot_freq=1` on a binary cache of 200,000 rows, a child under
LGBM_TPU_FAULT=sigterm_at_iter:3, exits 0 with its snapshot; task=train
resume=true here writes the uninterrupted run's save_model file byte for
byte).  Depth cuts that paid for them (each keeps its checks): the files
phase writes and parses 40,000 rows (200,000 before), the categorical
parity 3 iterations (10), and cv 3 iterations (5).
The entry layers, in the files phase on its 1M-row binary cache and CSV
(3 iterations, the files phase's reference run): `cli` (task=train in
this process, B1 and B2 only, its model file the reference run's
save_model file byte for byte; `python -m lightgbm_tpu_torch
task=predict` of the held-out rows as children, the host predictor's raw
scores (predict_device=false) NativeBooster.predict_for_file's byte for
byte, the device predictor's (the default) within rtol 1e-5; task=train on the CSV; parse_dense against
the numpy reader), `c abi` (TrainDataset / TrainBooster through ctypes in
this process, B1 and B2 only; a compiled C program as a child, updating
on a thread of its own while predicting through the handle, its model
file save_model's byte for byte) and `doctor` (task=doctor probe=true
names the card; a crashing task leaves a bundle).  Depth cuts that pay
for them (each keeps its checks): the main path's jit=False run 3
iterations (10), the profiler hook 1 (2), the CUDA vs CPU parity 3 (10),
the wide parity 1 (2) and the main path's every-B2-call check 1 (2).
The distributed learners, in the files phase on its 1M-row binary cache:
B1's and B7's raw int64 cells (the exchange's) bit for bit to
segment.fixed_cells at the main and the Bosch roots (kernels and wide
kernels lines), and `distributed` (two rank processes on cuda:0 over
gloo, `--dist-child`, train tree_learner=data, feature, voting at top_k
20 (2 top_k >= F: every feature voted) and 5 (10 of the 28 features
summed), and data with int8, 3 iterations each, then data at 131,072 x
968 for 2 beside this process's serial run: every rank's model rank 0's,
data / feature / voting top_k 20 / wide data the serial cut byte for
byte, voting top_k 5 within VOTE_AUC and int8 within 0.002 AUC of their
serial runs; s/iter, syncs and exchange bytes a tree, each rank's peak
MiB, launches).  The repeat checks of the merged, frontier 8, bagging,
bagging int8, rf, forced, monotone, categorical, year, renewal,
multiclass and rank paths run SHORT_ITERS iterations against the path's
model cut there (`model_cut`, `repeat_cut`, the line giving the path's
own sha256 too); the main path's and the others' run the path's
iterations.
Serving and online training (runtime/continuous.py, runtime/serving.py):
`online` runs ContinuousTrainer in process over the main path's 1M x 28
rows as a TSV (a `--tsv-child` writes it during the kernel phases), 3
cycles of 2 rounds with the gate on, B1 and B2 counted per cycle;
`serve` a ServingRuntime over its publish dir, 8 client threads and ~2M
rows of ragged requests with a 500 x 255 model published mid-stream,
every response held to the offline device predict of its generation;
`wire` the same runtime behind WireTCPServer and WireUnixServer, ~500k
rows of the same slices over TCP, the Unix socket and the shared-memory
ring, each answer the JSON path's byte for byte, and two torn-frame
classes; `loadgen` LoadGenerator's open loop on it, every answer
verified; `die_at_ring` a ring client killed with frames in flight,
its session reclaimed; `serve fault` die_at_predict and slow_predict on
one batch each; `cli serve / cli online` the task=serve and
task=train_online children; `fleet` a FleetController of two replicas
(spawned with the children, die_at_spawn:2 relaunched), 200 requests on
the wire and 200 on the ring, a graceful stop.
Every phase always runs and prints one line, prefixed with the seconds
since start; any failed check exits non-zero.  The last line is the
device record {"ok": true, "device": {...}}.  Imports nothing of JAX or
lightgbm_tpu.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# the port, from this checkout only: alone in a directory this script fails
import lightgbm_tpu_torch as lt  # noqa: E402
import torch  # noqa: E402
from lightgbm_tpu_torch import convert  # noqa: E402
from lightgbm_tpu_torch.boosting import gbdt as tgbdt  # noqa: E402
from lightgbm_tpu_torch.boosting import grower2  # noqa: E402
from lightgbm_tpu_torch.io.dataset import BinnedDataset  # noqa: E402
from lightgbm_tpu_torch.metric import create_metrics  # noqa: E402
from lightgbm_tpu_torch.models.gbdt_model import GBDTModel  # noqa: E402
from lightgbm_tpu_torch.ops import build, cuda_segment, quantize  # noqa: E402
from lightgbm_tpu_torch.ops import segment as seg  # noqa: E402
from lightgbm_tpu_torch.ops.segment import SplitPredicate  # noqa: E402
from lightgbm_tpu_torch.ops.split import (FeatureMeta,  # noqa: E402
                                          dequantize_hist,
                                          find_best_split_batched)
try:  # a parent tree (chip_compare.py) may predate the device loop
    from lightgbm_tpu_torch.runtime import graphs  # noqa: E402
except ImportError:
    graphs = None
try:  # ... or the device predictor
    from lightgbm_tpu_torch.models import device_predictor  # noqa: E402
    from lightgbm_tpu_torch.runtime import syncs  # noqa: E402
except ImportError:
    device_predictor = syncs = None
try:  # ... or the boosting variants
    from lightgbm_tpu_torch.boosting import variants  # noqa: E402
    from lightgbm_tpu_torch.utils import threefry  # noqa: E402
except ImportError:
    variants = threefry = None
from lightgbm_tpu_torch.utils.random import Random  # noqa: E402

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
    return {e.key.split("(anonymous namespace)::")[1].split("(")[0]:
            round(e.self_device_time_total / reps, 3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "(anonymous namespace)::" in e.key}


def all_kernels_us(fn, reps: int = 20) -> float:
    """Device microseconds per call of every kernel fn() launches, the
    port's and PyTorch's (torch.profiler over reps calls, after one
    warm-up call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / reps


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


def hist_cols(f: int, cols=None) -> tuple:
    """(grad, hess, count) columns: `cols`, else the K = 1 layout's."""
    return cols or (f + 5, f + 6, f + 2)


def hist_errors(pay, start, count, f, got, nb: int = B,
                cols=None) -> float:
    """Max |kernel - f64 sum| per cell of an nb-bin histogram of the
    (grad, hess, count) columns `cols` (by default the K = 1 layout's);
    raises past the stated bound."""
    s, c = int(start), int(count)
    rows = pay[s:s + c].double()
    cell = (rows[:, :f].long()
            + torch.arange(f, device=pay.device)[None, :] * nb).reshape(-1)
    vals = rows[:, list(hist_cols(f, cols))]
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


def hist_exact(pay, start, count, f, got, nb: int = B, scale=None,
               cols=None) -> float:
    """Raises unless an f32 kernel histogram of rows [start, start + count)
    is the plain fixed-point version's bit for bit
    (seg.segment_histogram_fixed at `scale`, by default the segment's own,
    as a wrapper called without one derives it) and within hist_errors'
    bound of the f64 sum; returns hist_errors' largest error."""
    g, h, c = hist_cols(f, cols)
    want = seg.segment_histogram_fixed(
        pay, int(start), int(count), num_features=f, num_bins=nb,
        grad_col=g, hess_col=h, cnt_col=c, scale=scale)
    check(torch.equal(got.reshape(want.shape).view(torch.int32),
                      want.view(torch.int32)),
          "f32 histogram not bit-identical to the fixed-point plain version "
          "at (%d, %d), F=%d: %d cells differ"
          % (int(start), int(count), f,
             int((got.reshape(want.shape) != want).sum())))
    del want
    return hist_errors(pay, start, count, f, got, nb, cols)


def scale_kw(fn, pay, starts, counts, f: int, cols=None) -> dict:
    """{"scale": the fixed-point exponents of the segments} when the f32
    wrapper `fn` takes them (this tree's), else {} (a parent tree's
    wrapper, which compare_phase drives too): computed here, outside the
    timed window, as the grower computes them once per tree."""
    if "scale" not in inspect.signature(fn).parameters:
        return {}
    g, h, _ = hist_cols(f, cols)
    return dict(scale=seg.fixed_scale(pay, starts, counts, g, h))


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


def raw_cells_check(label: str, fn, pay, n: int, f: int, hk: dict,
                    chunk: int = None) -> dict:
    """B1's or B7's raw output on the root segment [0, n) (the distributed
    learners' exchange): the int64 cells bit for bit to segment.fixed_cells
    (summed over row chunks of `chunk` rows where the index tensor would
    not fit), and their conversion bit for bit to the kernel's own f32
    output; both outputs timed (device ms, CUDA events)."""
    i32 = dict(dtype=torch.int32, device=pay.device)
    sc = seg.fixed_scale(pay, 0, n, hk["grad_col"], hk["hess_col"])
    zero, cnt = torch.zeros((), **i32), torch.tensor(n, **i32)
    raw = fn(pay, zero, cnt, scale=sc, raw=True, **hk)
    f32h = fn(pay, zero, cnt, scale=sc, **hk)
    torch.cuda.synchronize()
    step = chunk or n
    want = seg.fixed_cells(pay, 0, min(step, n), scale=sc, **hk)
    for s in range(step, n, step):
        want += seg.fixed_cells(pay, s, min(step, n - s), scale=sc, **hk)
    check(raw.dtype == torch.int64 and torch.equal(raw, want),
          "%s raw at the root F=%d: %d cells differ from fixed_cells"
          % (label, f, int((raw != want).sum())))
    check(torch.equal(seg.cells_to_hist(raw, sc).view(torch.int32),
                      f32h.view(torch.int32)),
          "%s raw at the root F=%d: the converted cells differ from the f32 "
          "output" % (label, f))
    del raw, f32h, want
    return dict(
        bit_identical=True,
        raw_ms=time_ms(lambda: fn(pay, zero, cnt, scale=sc, raw=True, **hk),
                       10),
        f32_ms=time_ms(lambda: fn(pay, zero, cnt, scale=sc, **hk), 10))


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
        hist_err = max(hist_err, hist_exact(pay, s, c, F, got))
    raw_root = raw_cells_check("B1", cuda_segment.segment_histogram, pay,
                               n, F, hk)
    f_wide, n_wide = 137, 200_000
    pay_w = make_payload(n_wide, f_wide, f_wide + 10, seed + 1, dev)
    got = cuda_segment.segment_histogram(
        pay_w, 0, n_wide, num_features=f_wide, num_bins=B,
        grad_col=f_wide + 5, hess_col=f_wide + 6, cnt_col=f_wide + 2)
    torch.cuda.synchronize()
    hist_err = max(hist_err, hist_exact(pay_w, 0, n_wide, f_wide, got))
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

    # B5 batched histogram: K = 1, 3 and 8 disjoint segments of uneven
    # sizes, empty and one-row ones among them, over one grid; f32 bit for
    # bit to the fixed-point plain version of each slice at the exponents
    # of all K segments (the wrapper's default), int32 bit for bit
    batched_err = 0.0
    for sizes in ((n // 3,), (0, 1, n // 7),
                  (n // 5, 1, 0, 37, n // 9, 4099, n // 3, n // 10 + 3)):
        starts, counts = batch_segments(n, sizes)
        st_t, ct_t = torch.tensor(starts, **i32), torch.tensor(counts, **i32)
        got = cuda_segment.segment_histogram_batched(pay, st_t, ct_t, **hk)
        torch.cuda.synchronize()
        sc = seg.fixed_scale(pay, starts, counts, COLS["grad"], COLS["hess"])
        for k, (s, c) in enumerate(zip(starts, counts)):
            batched_err = max(batched_err, hist_exact(pay, s, c, F, got[k],
                                                      scale=sc))
        for qmax, qpay in qpays.items():
            got = cuda_segment.segment_histogram_batched(
                qpay, st_t, ct_t, quantized=True, **hk)
            torch.cuda.synchronize()
            plain = seg.segment_histogram_batched(qpay, starts, counts,
                                                  quantized=True, **hk)
            check(got.dtype == torch.int32 and torch.equal(got, plain),
                  "int32 batched histogram differs from plain at qmax %d, "
                  "K = %d" % (qmax, len(sizes)))
        del got

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

    hsc = scale_kw(cuda_segment.segment_histogram, pay, 0, n, F)
    hist_ms = time_ms(lambda: cuda_segment.segment_histogram(
        pay, start0, count, **hk, **hsc), reps)
    hist_breakdown = kernel_breakdown(lambda: cuda_segment.segment_histogram(
        pay, start0, count, **hk, **hsc), pay, 0, n)
    hist_plain_ms = time_ms(lambda: seg.segment_histogram(
        pay, 0, n, **hk), 3)
    vals = lib_vals(pay, torch.float32)
    lib_out = torch.zeros(F * B, 3, device=dev)
    hist_lib_ms = time_ms(lambda: lib_out.index_add_(0, flat, vals), reps)

    qpay = qpays[127]
    quant_ms = time_ms(lambda: cuda_segment.segment_histogram_quant(
        qpay, start0, count, **hk), reps)
    quant_breakdown = kernel_breakdown(
        lambda: cuda_segment.segment_histogram_quant(qpay, start0, count,
                                                     **hk), pay, 0, n)
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
    bsc = scale_kw(cuda_segment.segment_histogram_batched, pay, tstarts,
                   tcounts, F)
    bat_ms = time_ms(lambda: cuda_segment.segment_histogram_batched(
        pay, ts_t, tc_t, **hk, **bsc), reps)
    bat_q_ms = time_ms(lambda: cuda_segment.segment_histogram_batched(
        qpay, ts_t, tc_t, quantized=True, **hk), reps)
    bat_breakdown = kernel_breakdown(
        lambda: cuda_segment.segment_histogram_batched(pay, ts_t, tc_t,
                                                       **hk, **bsc),
        pay, 0, 1)
    # B1 on as many rows in one segment, B5 f32's target
    b1_rows = torch.tensor(sum(tcounts), **i32)
    bat_b1_ms = time_ms(lambda: cuda_segment.segment_histogram(
        pay, start0, b1_rows, **hk, **bsc), reps)
    bat_q_breakdown = kernel_breakdown(
        lambda: cuda_segment.segment_histogram_batched(
            qpay, ts_t, tc_t, quantized=True, **hk), pay, 0, 1)
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
    # the int32 instance's yardstick: the same index_add_ in int32 on the
    # quantized rows
    qrows = torch.cat([qpay[s:s + c] for s, c in zip(tstarts, tcounts)])
    vals = torch.stack([qrows[:, COLS["grad"]], qrows[:, COLS["hess"]],
                        qrows[:, COLS["cnt"]]], 1)[:, None, :] \
        .expand(m, F, 3).reshape(-1, 3).to(torch.int32).contiguous()
    lib_out = torch.zeros(len(tcounts) * F * B, 3, **i32)
    bat_q_lib_ms = time_ms(lambda: lib_out.index_add_(0, flat, vals), reps)
    del seg_rows, seg_id, flat, vals, lib_out, qpays, qpay, qrows

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
    # the stage + commit (the frontier grower's): at the root and on
    # WIDE_SEGMENT_ROWS rows, with its kernels' breakdown.  Its contract
    # moves every row twice (payload -> aux, aux -> payload): its bound is
    # two passes, its yardstick the stage's one-pass library call plus one
    # copy_ of the segment for the commit
    sc_rec = dict(
        ms=time_fresh_ms(lambda: stage_commit(
            pay, aux, start0, count, pred, lv, rv, COLS["value"]),
            pay, 0, n, reps),
        breakdown_us=kernel_breakdown(lambda: stage_commit(
            pay, aux, start0, count, pred, lv, rv, COLS["value"]), pay, 0, n))
    ct = torch.tensor(WIDE_SEGMENT_ROWS, **i32)
    sc_rec["ms_%d_rows" % WIDE_SEGMENT_ROWS] = time_fresh_ms(
        lambda: stage_commit(pay, aux, start0, ct, pred, lv, rv,
                             COLS["value"]), pay, 0, WIDE_SEGMENT_ROWS, reps)
    sc_rec["plain_ms"] = time_fresh_ms(lambda: seg.partition_segment(
        pay, aux, 0, n, pred, lv, rv, COLS["value"]), pay, 0, n, 3)
    sc_rec["commit_copy_ms"] = time_ms(lambda: aux[:n].copy_(pay[:n]), reps)
    sc_rec["library_ms"] = part["library_ms"] + sc_rec["commit_copy_ms"]
    sc_rec["bound_ms"], sc_rec["bound_by"] = bound(4 * n * P * 4, 0)
    sc_rec["bound_ms_%d_rows" % WIDE_SEGMENT_ROWS] = bound(
        4 * WIDE_SEGMENT_ROWS * P * 4, 0)[0]
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
            library_ms=hist_lib_ms, breakdown_us=hist_breakdown,
            raw_root=raw_root),
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
            library_ms=quant_lib_ms, breakdown_us=quant_breakdown),
        "segment_histogram_batched": dict(
            name="segment_histogram_batched", route="cuda",
            source="lightgbm_tpu_torch/csrc/segment_hist.cu",
            replaces="lightgbm_tpu/ops/pallas_segment.py:649",
            max_abs_err=batched_err, ms=bat_ms, ms_int32=bat_q_ms,
            plain_ms=bat_plain_ms, library_ms=bat_lib_ms,
            library_ms_int32=bat_q_lib_ms, b1_same_rows_ms=bat_b1_ms,
            breakdown_us=bat_breakdown,
            breakdown_us_int32=bat_q_breakdown),
        "partition_segment_stage_commit": dict(
            sc_rec, name="partition_segment_stage_commit", route="cuda",
            source="lightgbm_tpu_torch/csrc/segment_partition.cu",
            replaces="lightgbm_tpu/ops/pallas_segment.py:1616",
            max_abs_err=0.0,
            library="stable argsort + index_select, then copy_"),
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
    on every predicate kind of `predicates()` over the whole segment
    (WHOLE_REPEATS times on fresh copies), and on unaligned, empty,
    one-row and mid segments, at MERGED_SHAPES: payload and num_left byte
    for byte, aux untouched outside the segment (it is scratch over it,
    as for the whole partitions), both children's count channels exact,
    grad / hess within B1's bound.  Then
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
            b_pay, b_aux = pay.clone(), aux_like(pay)
            b_pay, b_aux, b_nl, b_hl, b_hr = seg.partition_segment_hist(
                b_pay, b_aux, s, c, preds[name], lv, rv, cols["value"], nb,
                **hk)
            nl = int(b_nl)
            # both children round at the parent segment's exponents
            psc = seg.fixed_scale(pay, s, c, cols["grad"], cols["hess"])
            for _ in range(WHOLE_REPEATS if (s, c) == (0, rows) else 1):
                a_pay, a_aux = pay.clone(), aux_like(pay)
                a_pay, a_aux, a_nl, a_hl, a_hr = \
                    cuda_segment.partition_segment_hist(
                        a_pay, a_aux, torch.tensor(s, **i32),
                        torch.tensor(c, **i32), preds[name], lv, rv,
                        cols["value"], nb, **hk)
                torch.cuda.synchronize()
                same_partition(what, (a_pay, a_aux, a_nl),
                               (b_pay, b_aux, b_nl), s, c, full_aux=False)
                for got, hs, hc in ((a_hl, s, nl), (a_hr, s + nl, c - nl)):
                    err = max(err, hist_exact(b_pay, hs, hc, f, got, nb,
                                              scale=psc))
                del a_pay, a_aux, a_hl, a_hr
            del b_pay, b_aux, b_hl, b_hr
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
        msc = scale_kw(cuda_segment.partition_segment_hist, pay, 0, rows, F)
        rec["ms" + suffix] = time_fresh_ms(
            lambda: cuda_segment.partition_segment_hist(
                pay, aux, start0, ct, pred, lv, rv, COLS["value"], B, **hk,
                **msc), pay, 0, rows, reps)
        # what B6 replaces per split: B2, then B1 on the smaller child
        nl = int(seg.go_left_chunk(pay[:rows], pred).sum())
        h_st, h_ct = (0, nl) if nl <= rows - nl else (nl, rows - nl)
        h_st, h_ct = torch.tensor(h_st, **i32), torch.tensor(h_ct, **i32)

        def b2_b1():
            cuda_segment.partition_segment(pay, aux, start0, ct, pred, lv, rv,
                                           COLS["value"])
            cuda_segment.segment_histogram(pay, h_st, h_ct, num_bins=B, **hk,
                                           **msc)

        rec["b2_b1_ms" + suffix] = time_fresh_ms(b2_b1, pay, 0, rows, reps)
    msc = scale_kw(cuda_segment.partition_segment_hist, pay, 0, n, F)
    rec["breakdown_us"] = kernel_breakdown(
        lambda: cuda_segment.partition_segment_hist(
            pay, aux, start0, torch.tensor(n, **i32), pred, lv, rv,
            COLS["value"], B, **hk, **msc), pay, 0, n)
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
# phase: the segment sizes the grower really passes (B1, B6)
# ---------------------------------------------------------------------------

#: segment sizes at which B1, B6 and B1's yardstick are timed beside the
#: root: the smaller children and the parents the main path's trees have
#: (the census below) mostly hold a few thousand rows
CENSUS_SIZES = (1024, 4096, 16384, 131072)


def row_lanes(group_cols: int) -> int:
    """Lanes a row takes in one warp-wide load of the histogram body
    (csrc/segment_hist.cuh): its three values and its group's bins, in the
    smallest power of two from 4."""
    return next(w for w in (4, 8, 16, 32) if group_cols + 3 <= w or w == 32)


def layout_sizes(grid: int, f: int, nb: int = B) -> list:
    """Segment sizes that give each row layout of the histogram body at f
    features on `grid` blocks, by cuda_segment.hist_work_split: for each
    count of lanes a row takes, the fewest and the most chunks that give
    it, the first size with a last chunk of 5 rows, the second 3 rows
    short of whole chunks."""
    cap = cuda_segment.hist_group_cap(nb)
    r = cuda_segment.HIST_CHUNK_ROWS
    first, last = {}, {}
    for chunks in range(1, 2 * grid + 2):
        lanes = row_lanes(cuda_segment.hist_work_split(
            [chunks * r], grid, f, cap).group_cols)
        first.setdefault(lanes, chunks)
        last[lanes] = chunks
    return sorted({(c - 1) * r + 5 for c in first.values()}
                  | {c * r - 3 for c in last.values()})


#: the counts, feature counts and grids at which the CUDA split is held to
#: its Python form (those of tests/test_torch_hist_split.py and more), as
#: one segment, as B6's two children and as B5's K = 3 and 8
SPLIT_COUNTS = (0, 1, 37, 255, 256, 4095, 4096, 4097, 11_261, 131_072,
                1_015_808)


def split_cases():
    for c0 in SPLIT_COUNTS:
        yield [c0]
        yield [c0, c0 // 3]
        yield [c0, 4097]
        yield [0, c0, 1]
        yield [c0 // 8, 0, 37, 1, c0 // 3, 0, 4099, c0 // 5]


def census_check_phase(n: int, seed: int, dev) -> dict:
    """The histogram split and kernels at the sizes the grower passes.
    First the kernel's work split (`segment_hist_split` of the library:
    hist_split and each block's hist_run in csrc/segment_hist.cuh) against
    cuda_segment's hist_work_split / hist_run at SPLIT_COUNTS, alone, as
    B6's two children and as B5's K = 3 and 8 segments, at 1, 28, 137 and
    2,000 features, at the f32 and int32 cells' group caps, on the card's
    grid and on a grid of 7.  Then, at every census size and at the sizes
    that give each row layout at F = 28 on the card's grid
    (layout_sizes), each at row 0 and at row 777 of the main path's
    payload: B1, B7 and B5 (three segments of that size, the middle one
    empty) bit for bit to the fixed-point plain version, B4 bit for bit
    at the int8 grid, and B6 at the numerical split held as
    merged_kernel_phase holds it (payload and num_left byte for byte, aux
    untouched outside the segment, both children bit for bit at the
    parent's exponents).  Raises at the first failure; returns the sizes,
    the layouts and the largest error against the f64 sums."""
    i32 = dict(dtype=torch.int32, device=dev)
    lib = build.load("segment_hist")
    split_c = lib.segment_hist_split
    split_c.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    split_c.restype = ctypes.c_int
    sms = cuda_segment._sm_count(dev.index)
    n_split = 0
    for f in (1, F, 137, 2000):
        for cap in (cuda_segment.hist_group_cap(B),
                    cuda_segment.hist_group_cap(B, quantized=True)):
            for grid in (cuda_segment.hist_grid(sms, f, cap),
                         max(7, -(-f // cap))):
                got = (ctypes.c_int * (3 + 5 * grid))()
                for counts in split_cases():
                    arr = (ctypes.c_int * len(counts))(*counts)
                    split_c(ctypes.addressof(arr), len(counts), grid, f, cap,
                            ctypes.addressof(got))
                    want = cuda_segment.hist_work_split(counts, grid, f, cap)
                    flat = [want.groups, want.group_cols, want.chunks]
                    for b in range(grid):
                        r = cuda_segment.hist_run(want, b, grid)
                        flat += [r.group, r.first, r.last, r.workers,
                                 int(r.works)]
                    check(list(got) == flat,
                          "hist_split (%s, grid %d, F %d, cap %d): CUDA %s, "
                          "Python %s" % (counts, grid, f, cap, list(got)[:3],
                                         flat[:3]))
                    n_split += 1

    grid = cuda_segment.hist_grid(sms, F, cuda_segment.hist_group_cap(B))
    sizes = sorted(set(CENSUS_SIZES) | set(layout_sizes(grid, F)))
    pay = make_payload(n, F, P, seed, dev)
    qpay = quantize_columns(pay, n, 127, seed + 127)
    hk = dict(num_features=F, grad_col=COLS["grad"], hess_col=COLS["hess"],
              cnt_col=COLS["cnt"])
    pred = predicates(dev)["numerical"]
    lv, rv = torch.tensor(-0.25, device=dev), torch.tensor(0.75, device=dev)
    err = 0.0
    layouts = {}
    for rows in sizes:
        layouts[rows] = row_lanes(cuda_segment.hist_work_split(
            [rows], grid, F, cuda_segment.hist_group_cap(B)).group_cols)
        for s in (0, 777):
            st, ct = torch.tensor(s, **i32), torch.tensor(rows, **i32)
            for fn in (cuda_segment.segment_histogram,
                       cuda_segment.segment_histogram_colblock):
                got = fn(pay, st, ct, num_bins=B, **hk)
                torch.cuda.synchronize()
                err = max(err, hist_exact(pay, s, rows, F, got))
            starts = [s, s + rows + 5, s + rows + 10]
            counts = [rows, 0, rows]
            got = cuda_segment.segment_histogram_batched(
                pay, torch.tensor(starts, **i32), torch.tensor(counts, **i32),
                num_bins=B, **hk)
            torch.cuda.synchronize()
            bsc = seg.fixed_scale(pay, starts, counts, COLS["grad"],
                                  COLS["hess"])
            for k in range(3):
                err = max(err, hist_exact(pay, starts[k], counts[k], F,
                                          got[k], scale=bsc))
            got = cuda_segment.segment_histogram_quant(qpay, st, ct,
                                                       num_bins=B, **hk)
            check(torch.equal(got, seg.segment_histogram(
                qpay, s, rows, quantized=True, num_bins=B, **hk)),
                "B4 differs from plain at (%d, %d)" % (s, rows))
            what = "B6 at (%d, %d)" % (s, rows)
            psc = seg.fixed_scale(pay, s, rows, COLS["grad"], COLS["hess"])
            a = cuda_segment.partition_segment_hist(
                pay.clone(), aux_like(pay), st, ct, pred, lv, rv,
                COLS["value"], B, **hk)
            torch.cuda.synchronize()
            b = seg.partition_segment_hist(pay.clone(), aux_like(pay), s,
                                           rows, pred, lv, rv, COLS["value"],
                                           B, **hk)
            same_partition(what, a[:3], b[:3], s, rows, full_aux=False)
            nl = int(b[2])
            for k, hs, hc in ((3, s, nl), (4, s + nl, rows - nl)):
                err = max(err, hist_exact(b[0], hs, hc, F, a[k], scale=psc))
            del a, b, got
    return dict(split_cases=n_split, grid=grid, sizes=sizes,
                lanes_by_size=layouts, max_abs_err=err)


def sizes_phase(n: int, seed: int, dev, sizes=CENSUS_SIZES) -> dict:
    """B1, B6 and B1's yardstick (one index_add_ of the segment's cells,
    computed beforehand) on the first `rows` rows of the main path's
    payload, for each of `sizes` and the root (n): device microseconds
    per call from torch.profiler.  B1: its kernel alone (`b1_us`) and
    every launch of its wrapper (`b1_call_us`: the segment's packing and
    the output's allocation too; the fixed-point exponents are passed, as
    the grower passes them once per tree); B6: its kernels on fresh rows at
    the numerical split (~40 % left); each beside its byte bound.  It drives only the
    wrappers, so it times a parent tree's kernels as well.  Returns
    {rows: record}."""
    i32 = dict(dtype=torch.int32, device=dev)
    pay = make_payload(n, F, P, seed, dev)
    aux = torch.zeros_like(pay)
    hk = dict(num_features=F, grad_col=COLS["grad"], hess_col=COLS["hess"],
              cnt_col=COLS["cnt"])
    pred = predicates(dev)["numerical"]
    lv, rv = torch.tensor(-0.25, device=dev), torch.tensor(0.75, device=dev)
    start0 = torch.zeros((), **i32)
    out = {}
    for rows in tuple(sizes) + (n,):
        ct = torch.tensor(rows, **i32)
        # the tree's exponents, as the grower passes them (none to a
        # parent tree's wrappers)
        ssc = scale_kw(cuda_segment.segment_histogram, pay, 0, rows, F)

        def b1():
            cuda_segment.segment_histogram(pay, start0, ct, num_bins=B, **hk,
                                           **ssc)

        def b6():
            cuda_segment.partition_segment_hist(pay, aux, start0, ct, pred,
                                                lv, rv, COLS["value"], B,
                                                **hk, **ssc)

        rec = dict(b1_us=sum(kernel_breakdown(b1, pay, 0, rows, 20)
                             .values()),
                   b1_call_us=all_kernels_us(b1))
        b6_kernels = kernel_breakdown(b6, pay, 0, rows, 20)
        rec.update(b6_us=sum(b6_kernels.values()), b6_breakdown_us=b6_kernels)
        r = pay[:rows]
        flat = (r[:, :F].long() + torch.arange(F, device=dev)[None, :] * B) \
            .reshape(-1)
        vals = torch.stack([r[:, COLS["grad"]], r[:, COLS["hess"]],
                            r[:, COLS["cnt"]]], 1)[:, None, :] \
            .expand(rows, F, 3).reshape(-1, 3).contiguous()
        lib_out = torch.zeros(F * B, 3, device=dev)
        rec["library_us"] = all_kernels_us(
            lambda: lib_out.index_add_(0, flat, vals))
        rec["b1_bound_us"] = bound(rows * (F + 3) * 4 + F * B * 12, 0)[0] * 1e3
        rec["b6_bound_us"] = bound(2 * rows * P * 4 + 2 * F * B * 12,
                                   0)[0] * 1e3
        rec["b1_loses_to_library"] = rec["b1_us"] > rec["library_us"]
        out[rows] = rec
        del flat, vals, lib_out
    return out


def census(trees) -> tuple:
    """The segment sizes of B1's and B6's calls in a one-leaf model (no
    bagging, so a node's count is its rows): B1 on each tree's root and on
    each split's smaller child (the main path), B6 on each split's parent
    (the merged path).  Returns (b1 sizes, b6 sizes)."""
    b1, b6 = [], []
    for t in trees:
        ni = t.num_leaves - 1
        b1.append(int(t.internal_count[0] if ni else t.leaf_count[0]))
        for node in range(ni):
            kids = [int(t.internal_count[ch]) if ch >= 0
                    else int(t.leaf_count[~ch])
                    for ch in (t.left_child[node], t.right_child[node])]
            b1.append(min(kids))
            b6.append(int(t.internal_count[node]))
    return b1, b6


def census_line(trees) -> tuple:
    """The census of the main path's final model: per kernel the calls,
    rows, the distribution over sizes (calls with at most 1k, 4k, 16k,
    128k rows and more) and the byte bound per iteration (one tree) at
    3.35 TB/s (B1: rows * (F + 3) * 4 + F * B * 12 bytes a call; B6:
    2 * rows * P * 4 + 2 * F * B * 12).  Returns (line, {kernel: bound ms
    per iteration})."""
    b1, b6 = census(trees)
    out, bounds = {}, {}
    for name, sizes, per_row, per_call in (
            ("segment_histogram", b1, (F + 3) * 4, F * B * 12),
            ("partition_segment_hist", b6, 2 * P * 4, 2 * F * B * 12)):
        a = np.asarray(sizes)
        edges = (1024, 4096, 16384, 131072)
        buckets = np.searchsorted(np.asarray(edges), a, side="left")
        bounds[name] = bound(float((a * per_row + per_call).sum())
                             / len(trees), 0)[0]
        out[name] = dict(
            calls=int(a.size), rows=int(a.sum()), median=float(np.median(a)),
            max=int(a.max()), calls_by_size={
                lbl: int((buckets == k).sum()) for k, lbl in enumerate(
                    ("<=1k", "<=4k", "<=16k", "<=128k", ">128k"))},
            bound_ms_per_iter=bounds[name])
    return ("census: segment sizes of B1 (root + each split's smaller "
            "child) and B6 (each split's parent) in the main path's %d "
            "trees: %s" % (len(trees), json.dumps(out))), bounds


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
    (B2 whole, B3, B8, and B6's partition): aux over the segment is
    scratch."""
    return fn in (cuda_segment.partition_segment,
                  cuda_segment.partition_segment_rmw,
                  cuda_segment.partition_segment_blocks,
                  cuda_segment.partition_segment_hist)


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


def fixed_hist_chunked(pay, n: int, f: int, scale,
                       chunk: int = WIDE_CMP_ROWS) -> torch.Tensor:
    """seg.segment_histogram_fixed of rows [0, n) at `scale`, its exact
    integer sums taken over row chunks that fit the card."""
    hk = dict(num_features=f, num_bins=B, grad_col=f + 5, hess_col=f + 6,
              cnt_col=f + 2, scale=scale)
    gh, cnt = seg.fixed_sums(pay, 0, min(chunk, n), **hk)
    for s in range(chunk, n, chunk):
        g2, c2 = seg.fixed_sums(pay, s, min(chunk, n - s), **hk)
        gh += g2
        cnt += c2
    return seg.fixed_hist(gh, cnt, scale, f, B)


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
#: the whole partitions held WHOLE_REPEATS times on each wide root: B8 at
#: both, B3 at the Bosch shape, which it serves
WIDE_WHOLE = {968: (cuda_segment.partition_segment_rmw,
                    cuda_segment.partition_segment_blocks),
              2000: (cuda_segment.partition_segment_blocks,)}


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
                err = max(err, hist_exact(small, s, c, f, got))
                del got
            rec[name] = dict(max_abs_err=err)
        # B7 on the whole root, bit for bit
        root_sc = seg.fixed_scale(pay, 0, n, cols["grad"], cols["hess"])
        got = cuda_segment.segment_histogram_colblock(
            pay, torch.zeros((), **i32), torch.tensor(n, **i32), **hk,
            scale=root_sc)
        torch.cuda.synchronize()
        want = fixed_hist_chunked(pay, n, f, root_sc)
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              "B7 at the root F=%d: %d cells differ from the fixed-point "
              "plain version" % (f, int((got != want).sum())))
        rec["segment_histogram_colblock"]["root_bit_identical"] = True
        del got, want
        if f == DIST_WIDE_F:
            rec["segment_histogram_colblock"]["raw_root"] = raw_cells_check(
                "B7", cuda_segment.segment_histogram_colblock, pay, n, f, hk,
                chunk=WIDE_CMP_ROWS)

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
        bsc = seg.fixed_scale(small, starts, counts, cols["grad"],
                              cols["hess"])
        err = max(hist_exact(small, s, c, f, got[k], scale=bsc)
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

        # B8, and B3 at the Bosch shape it serves, partitioned
        # WHOLE_REPEATS times on fresh copies of the root under every
        # predicate kind
        whole = WIDE_WHOLE[f]
        for name in preds:
            partition_equal(whole, pay, preds[name], 0, n, cols["value"],
                            repeats=WHOLE_REPEATS)
        for fn in whole:
            rec[fn.__name__]["repeats_identical"] = WHOLE_REPEATS
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
                    wsc = scale_kw(fn, pay, 0, ct, f)
                    rec[name][key] = time_ms(
                        lambda: fn(pay, start0, ct_t, **hk, **wsc), reps)
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
        # B7 again with wide 968's NaN share: a fifth of every other
        # feature's rows in the last bin, the cells its warps contend on
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + f + 1)
        nan_pay = pay.clone()
        odd = nan_pay[:n, 1:f:2]
        odd[torch.rand(odd.shape, generator=gen, device=dev)
            < WIDE_NAN[968]] = B - 1
        del odd
        rec["segment_histogram_colblock"]["ms_nan_fifth"] = time_ms(
            lambda: cuda_segment.segment_histogram_colblock(
                nan_pay, start0, count, **hk, scale=root_sc), reps)
        del nan_pay
        hist_bound = bound(n * (f + 3) * 4 + f * B * 3 * 4, n * f * 3)
        for name in ("segment_histogram_colblock", "segment_histogram"):
            rec[name].update(plain_ms=hist_plain_ms, library_ms=hist_lib_ms,
                             bound_ms=hist_bound[0], bound_by=hist_bound[1])
        rec["segment_histogram_colblock"]["breakdown_us"] = kernel_breakdown(
            lambda: cuda_segment.segment_histogram_colblock(
                pay, start0, count, **hk, scale=root_sc), pay, 0, 1)
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
            for name in ("partition_segment_rmw", "partition_segment_blocks"):
                fn = getattr(cuda_segment, name)
                if not suffix:
                    rec[name]["breakdown_us"] = kernel_breakdown(
                        lambda: fn(pay, aux, start0, count, pred, lv, rv,
                                   cols["value"]), pay, 0, n)
                else:
                    rec[name]["ms" + suffix] = time_fresh_ms(
                        lambda: fn(pay, aux, start0, count, pred, lv, rv,
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


#: the card's crossovers: payload widths for the whole partitions B2, B3
#: and B8, feature counts for the histograms B1 and B7, each timed on the
#: root's rows and on WIDE_SEGMENT_ROWS
SWEEP_WIDTHS = (128, 256, 513, 978, 1664, 2010)
SWEEP_FEATURES = (256, 512, 889, 968, 2000)
SWEEP_ROWS = 1_015_808


def sweep_phase(seed: int, dev) -> dict:
    """Each whole partition at every width of SWEEP_WIDTHS and each f32
    histogram at every feature count of SWEEP_FEATURES, on SWEEP_ROWS
    rows and on WIDE_SEGMENT_ROWS (the partitions on fresh rows, at the
    numerical split).  The kernels are held elsewhere; this only times
    them, whatever width the route would give them.  Returns {kernel:
    {width or features: {rows: ms}}}."""
    i32 = dict(dtype=torch.int32, device=dev)
    lv = torch.tensor(-0.25, device=dev)
    rv = torch.tensor(0.75, device=dev)
    pred = make_pred(dev, B, 3, TIMED_SPLITS[""])
    start0 = torch.zeros((), **i32)
    out = {}
    for p in SWEEP_WIDTHS:
        pay = device_payload(SWEEP_ROWS, p - 10, p, seed + p, dev)
        aux = torch.zeros_like(pay)
        for name in ("partition_segment", "partition_segment_rmw",
                     "partition_segment_blocks"):
            fn = getattr(cuda_segment, name)
            for rows in (SWEEP_ROWS, WIDE_SEGMENT_ROWS):
                ct = torch.tensor(rows, **i32)
                out.setdefault(name, {}).setdefault(p, {})[rows] = \
                    time_fresh_ms(lambda: fn(pay, aux, start0, ct, pred, lv,
                                             rv, p - 3), pay, 0, rows, 5)
        del pay, aux
        torch.cuda.empty_cache()
    for f in SWEEP_FEATURES:
        cols = cols_of(f)
        hk = dict(num_features=f, num_bins=B, grad_col=cols["grad"],
                  hess_col=cols["hess"], cnt_col=cols["cnt"])
        pay = device_payload(SWEEP_ROWS, f, f + 10, seed + f, dev)
        for name in ("segment_histogram", "segment_histogram_colblock"):
            fn = getattr(cuda_segment, name)
            for rows in (SWEEP_ROWS, WIDE_SEGMENT_ROWS):
                ct = torch.tensor(rows, **i32)
                wsc = scale_kw(fn, pay, 0, rows, f)
                out.setdefault(name, {}).setdefault(f, {})[rows] = time_ms(
                    lambda: fn(pay, start0, ct, **hk, **wsc), 5)
        del pay
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

#: whether this tree grows each tree as one device program (a parent
#: tree, run by chip_compare.py, may read the device inside its trees)
DEVICE_LOOP = graphs is not None


class StrictGrow:
    """A grower each call of which runs under
    torch.cuda.set_sync_debug_mode("error"): a sync inside a tree (an
    .item(), a blocking copy, a nonzero) raises.  Each tree must also end
    at its loop condition: the stop flag its last step wrote (pinned host
    memory, final once the iteration's tree_fetch has waited for the
    tree) is clear, so a driver that stops a tree too soon fails the run.
    The next call checks the tree before, `stopped()` the last one.  Its
    attributes are the grower's."""

    def __init__(self, grow):
        self._grow = grow
        self._unchecked = False
        self.trees_stopped = 0

    def __call__(self, *args, **kwargs):
        self.stopped()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return self._grow(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            self._unchecked = True

    def stopped(self) -> int:
        """Checks the last tree grown, if not yet checked; returns the
        trees checked so far."""
        if self._unchecked:
            self._unchecked = False
            check(not int(self._grow.program.flag[0]),
                  "tree %d stopped before its loop condition did"
                  % self.trees_stopped)
            self.trees_stopped += 1
        return self.trees_stopped

    def __getattr__(self, name):
        return getattr(self._grow, name)


@contextlib.contextmanager
def grower_mode(jit: bool = True, strict: bool = True):
    """Training inside the block makes its growers with `jit` (graphs, or
    the same steps eagerly), each call under sync debug mode "error" when
    `strict`.  A parent tree's growers, which read the device per split,
    are left as they are."""
    real = tgbdt.make_partitioned_grower

    def make(*args, **kwargs):
        grow = real(*args, jit=jit, **kwargs)
        return StrictGrow(grow) if strict else grow

    if DEVICE_LOOP:
        tgbdt.make_partitioned_grower = make
    try:
        yield
    finally:
        tgbdt.make_partitioned_grower = real


def check_trees_stopped(label: str, bst, grown: int = None) -> None:
    """Raises unless each of the `grown` trees `bst` grew under StrictGrow
    ended at its loop condition (after training, the last tree's fetch
    has passed); by default the model's trees less those it was loaded
    with."""
    if not DEVICE_LOOP:
        return
    n = bst._engine.grower.stopped()
    eng = bst._engine
    trees = len(bst._model.trees) - getattr(eng, "num_init_iteration", 0) \
        * eng.num_tree_per_iteration if grown is None else grown
    check(n == trees, "%s: %d of %d trees checked at their loop condition"
          % (label, n, trees))


def graph_counts() -> dict:
    return graphs.counts() if DEVICE_LOOP else {}


def train_params(num_leaves: int, **extra) -> dict:
    return dict(dict(objective="binary", num_leaves=num_leaves, max_bin=255,
                     learning_rate=0.1, verbose=-1), **extra)


#: the CUDA vs CPU parity's iterations (10 before the entry layers joined
#: the script)
PARITY_ITERS = 3


def parity_phase(seed: int) -> str:
    X, y = synth(25_000, F, seed + 11)
    Xt, yt, Xv, yv = X[:20_000], y[:20_000], X[20_000:], y[20_000:]
    runs = {}
    for dev in ("cuda", "cpu"):
        params = train_params(63) if dev == "cuda" \
            else train_params(63, device_type="cpu")
        bst = lt.train(params, lt.Dataset(Xt, label=yt), PARITY_ITERS,
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
    return ("parity: 20000x28, 63 leaves, %d iters: first split %s on both, "
            "AUC cuda %.6f cpu %.6f |dAUC| %.6f"
            % (PARITY_ITERS, runs["cuda"][:2], runs["cuda"][2],
               runs["cpu"][2], d_auc))


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
        if hasattr(cuda_segment, name):  # a parent tree may lack one
            getattr(cuda_segment, name).launches = 0


def read_counts() -> dict:
    return {name: getattr(cuda_segment, name).launches
            if hasattr(cuda_segment, name) else 0 for name in COUNTED}


def make_main_data(rows: int, seed: int, params: dict) -> tuple:
    """The main path's data: `rows` training rows binned once (every
    training path shares the binned Dataset) and 100k held-out rows."""
    n_valid = 100_000
    X, y = synth(rows + n_valid, F, seed)
    t0 = time.perf_counter()
    ds = lt.Dataset(X[:rows], label=y[:rows])
    ds.construct(lt.Config(params))
    return ds, X[rows:], y[rows:], time.perf_counter() - t0


def train_path(name: str, ds, Xv, yv, params: dict, iters: int,
               auc_floor: float = 0.8, valid_sets=None,
               syncs_per_tree: int = 1, quality=None,
               evals_result=None, fobj=None, wide_ok: bool = False,
               callbacks=None) -> dict:
    """Train one configuration of the main path through
    lightgbm_tpu_torch.train on the card (with `valid_sets` scored every
    iteration, when given), with every launch count set to 0 just before
    and read just after; predict the held-out rows.  Each tree must take
    `syncs_per_tree` blocking syncs (2 where leaves are renewed or a
    custom objective `fobj` reads the scores).  The held-out check is AUC
    above `auc_floor`, or `quality(yv, pred)`, which returns (its value,
    whether it passes).  No wide kernel may launch unless `wide_ok`."""
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.max_memory_allocated()
    graphs_before = graph_counts()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with grower_mode():
        bst = lt.train(params, ds, iters, valid_sets=valid_sets,
                       evals_result=evals_result, verbose_eval=False,
                       fobj=fobj, callbacks=callbacks)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    replays = {k: v["replays"] - graphs_before.get(k, {}).get("replays", 0)
               for k, v in graph_counts().items()}
    check_trees_stopped(name, bst)
    check(bst.device.type == "cuda", "%s ran on %s" % (name, bst.device))
    check(bst.current_iteration() == iters, "%s trained %d of %d iterations"
          % (name, bst.current_iteration(), iters))
    check(wide_ok or not any(launches[k] for k in WIDE_ONLY),
          "%s launched a wide kernel: %s"
          % (name, {k: launches[k] for k in WIDE_ONLY}))
    t0 = time.perf_counter()
    # predict(Xv) is convert_output of these raw scores (a custom
    # objective's model predicts them as they are, a forest their average)
    raw = bst.predict(Xv, raw_score=True)
    if bst._model.average_output:
        pred = raw / bst._model.num_prediction_iterations()
    else:
        pred = raw if bst._objective is None \
            else bst._objective.convert_output(raw)
    t_pred = time.perf_counter() - t0
    K = bst._model.num_tree_per_iteration
    check(pred.shape == ((len(yv),) if K == 1 else (len(yv), K))
          and bool(np.isfinite(pred).all()),
          "%s: held-out predictions malformed" % name)
    if quality is None:
        auc = auc_score(yv, pred)
        check(auc > auc_floor, "%s: held-out AUC %.4f too low" % (name, auc))
    else:
        auc, ok = quality(yv, pred)
        check(ok, "%s: held-out quality %.6f fails its bound" % (name, auc))
    leaves = [t.num_leaves for t in bst._model.trees]
    syncs = bst.host_syncs_per_tree()
    check(not DEVICE_LOOP or syncs == [syncs_per_tree] * len(leaves),
          "%s: blocking syncs per tree %s, not %d" % (name, syncs,
                                                      syncs_per_tree))
    t0 = bst._model.trees[0]
    return dict(name=name, bst=bst, model_text=bst.model_to_string(),
                launches=launches, auc=auc, raw=raw, pred=pred, splits=sum(leaves) - len(leaves),
                first_split=(int(t0.split_feature[0]),
                             int(t0.threshold_in_bin[0])),
                s_per_iter=t_train / iters, t_train=t_train, t_pred=t_pred,
                peak=peak, peak_before=mem0, syncs=syncs, leaves=leaves,
                replays=replays,
                splits_per_tree=float(np.mean(leaves)) - 1.0,
                rounds_per_tree=bst.split_rounds_per_tree())


def path_line(r: dict, rows: int, iters: int, extra: str = "",
              n_feat: int = F) -> str:
    return ("%s: %dx%d, max_bin 255, 255 leaves, lr 0.1, %d iters: "
            "%.4f s/iter (train %.3f s), syncs/tree %s (mean %.2f), split "
            "rounds/tree %.2f, splits/tree %.2f, max_memory_allocated %d B "
            "(%d B before), held-out AUC %.6f on %d rows (predict %.3f s)%s, "
            "graph replays %s, launches %s"
            % (r["name"], rows, n_feat, iters, r["s_per_iter"], r["t_train"],
               r["syncs"], float(np.mean(r["syncs"])), r["rounds_per_tree"],
               r["splits_per_tree"], r["peak"], r["peak_before"], r["auc"],
               100_000, r["t_pred"], extra, json.dumps(r["replays"]),
               json.dumps(r["launches"])))


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


def checked_partition_phase(data, rows: int, iters: int,
                            params: dict = None,
                            label: str = "B2 in training",
                            quality=None) -> str:
    """A path (the main path unless `params` say otherwise) again for
    `iters` iterations, every B2 call held against the plain partition on
    copies of its inputs (its predicate, categorical bitset included):
    payload and num_left byte for byte and aux untouched outside the
    segment, so an ordering race in training shows.  The line ends with
    the held-out AUC, or `quality` = (its name, quality(bst)).  Its
    launches are not counted against any path."""
    ds, Xv, yv = data
    params = params or train_params(255)
    whole = cuda_segment.partition_segment
    calls, cat_calls = [], []

    def checked(payload, aux, start, count, pred, left_value, right_value,
                value_col, **kw):
        before, aux_before = payload.clone(), aux.clone()
        out = whole(payload, aux, start, count, pred, left_value,
                    right_value, value_col, **kw)
        plain = seg.partition_segment(before, aux_before, int(start),
                                      int(count), pred, left_value,
                                      right_value, value_col)
        same_partition("%s (%d, %d)" % (label, int(start), int(count)),
                       out, plain, int(start), int(count), full_aux=False)
        if bool(pred.is_cat):
            cat_calls.append(int(count))
        calls.append(int(count))
        return out

    checked.__name__ = whole.__name__
    checked.launches = 0
    cuda_segment.partition_segment = checked
    try:
        # eager steps (the checks read the device), B2 on every split
        with grower_mode(jit=False, strict=False):
            bst = lt.train(params, ds, iters, verbose_eval=False)
    finally:
        cuda_segment.partition_segment = whole
    splits = sum(t.num_leaves - 1 for t in bst._model.trees)
    calls = [c for c in calls if c]
    check(len(calls) == splits, "checked %d B2 calls on rows for %d splits"
          % (len(calls), splits))
    name, value = quality(bst) if quality else ("AUC", auc_score(
        yv, bst.predict(Xv)))
    fs = bst._engine._fast
    return ("%s: %dx%d (P=%d), %d iters, %d trees, %d calls on segments of "
            "%d to %d rows (%d with a categorical bitset), each "
            "byte-identical to the plain partition; held-out %s %.6f"
            % (label, rows, ds.binned.num_features, fs.P, iters,
               len(bst._model.trees), len(calls), min(calls), max(calls),
               len([c for c in cat_calls if c]), name, value))


def first_difference(a: str, b: str) -> str:
    """Where two model texts first differ: the tree, the key of the line
    and the node (the first differing entry of that line's array); the
    header's tree_sizes differ whenever a tree does, so trees come
    first."""
    parts_a, parts_b = a.split("Tree="), b.split("Tree=")
    for k, (ta, tb) in enumerate(zip(parts_a[1:] + parts_a[:1],
                                     parts_b[1:] + parts_b[:1])):
        if ta == tb:
            continue
        where = "tree %d" % k if k < len(parts_a) - 1 else "the header"
        for la, lb in zip(ta.splitlines(), tb.splitlines()):
            if la != lb:
                key, va = la.split("=", 1) if "=" in la else (la, "")
                vb = lb.split("=", 1)[1] if "=" in lb else ""
                node = next((i for i, (x, y) in enumerate(zip(
                    va.split(), vb.split())) if x != y), None)
                return "%s, %s, entry %s" % (where, key, node)
        return where
    return "the text lengths"


#: the f32 histogram wrappers whose every output the repeat check records
RECORDED_HISTS = ("segment_histogram", "segment_histogram_batched",
                  "segment_histogram_colblock", "partition_segment_hist")


def recorded_train(train, deterministic: bool) -> dict:
    """Run train() (which returns a booster) with the output of every f32
    histogram wrapper and every split search recorded, cloned on the card,
    and the final scores; under torch.use_deterministic_algorithms(True,
    warn_only=True) when `deterministic`, whose warnings are returned.
    The wrappers' launch counts are left as they were."""
    hists, searches = [], []
    real = {name: getattr(cuda_segment, name) for name in RECORDED_HISTS}
    counts = read_counts()

    def keep(into, name, tensors):
        """Record clones of `tensors`, with the count of histograms
        recorded so far; inside a capture, a captured clone that each
        replay refills, cloned again after every replay."""
        if DEVICE_LOOP and torch.cuda.is_current_stream_capturing():
            bufs = tuple(t.clone() for t in tensors)
            graphs.after_replay(lambda: into.append(
                (name, tuple(b.clone() for b in bufs), len(hists))))
        else:
            into.append((name, tuple(t.clone() for t in tensors),
                         len(hists)))

    def recorder(name, fn):
        def rec(*args, **kw):
            out = fn(*args, **kw)
            if name == "partition_segment_hist":
                keep(hists, name, (torch.stack([out[3], out[4]]),))
            elif out.dtype == torch.float32:
                keep(hists, name, (out,))
            return out
        rec.__name__ = fn.__name__
        rec.launches = 0
        return rec

    real_find = grower2.find_best_split_batched

    def find(*args, **kw):
        res = real_find(*args, **kw)
        keep(searches, "search", tuple(res))
        return res

    for name, fn in real.items():
        setattr(cuda_segment, name, recorder(name, fn))
    grower2.find_best_split_batched = find
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(deterministic, warn_only=True)
            try:
                with grower_mode():
                    bst = train()
                torch.cuda.synchronize()
                check_trees_stopped("repeat check", bst)
            finally:
                torch.use_deterministic_algorithms(False)
    finally:
        for name, fn in real.items():
            setattr(cuda_segment, name, fn)
        grower2.find_best_split_batched = real_find
        for name, v in counts.items():
            if hasattr(cuda_segment, name):
                getattr(cuda_segment, name).launches = v
    # a step past a tree's stop is a no-op, each of its histograms all
    # zero (count 0), and how many of them grower2._drive enqueues before
    # it reads the stop flag depends on the host's timing: such steps,
    # and their split searches, are left out of the record
    live = [bool(t[0].any()) for _, t, _ in hists]
    kept, start = [], 0
    for _, t, end in searches:
        if end == start or any(live[start:end]):
            kept.append(t)
        start = end
    text = bst.model_to_string()
    return dict(text=text, sha=hashlib.sha256(text.encode()).hexdigest(),
                hists=[(n, t[0]) for (n, t, _), on in zip(hists, live)
                       if on],
                searches=kept, noop_steps=len(searches) - len(kept),
                scores=bst._engine._fast.raw_scores(),
                warnings=sorted({"%s:%s %s" % (w.filename.split("/")[-1],
                                               w.lineno, str(w.message)[:160])
                                 for w in caught}))


def deterministic_probe() -> list:
    """The warnings that recorded_train's capture sees from one op that
    PyTorch's deterministic mode flags (torch.histc on the card), so an
    empty list from a training run is seen to mean no flagged op ran."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            torch.histc(torch.zeros(4, device="cuda"))
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    return [str(w.message)[:80] for w in caught]


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return torch.equal(a.contiguous().view(torch.int32 if a.element_size()
                                               == 4 else torch.int64),
                           b.contiguous().view(torch.int32 if b.element_size()
                                               == 4 else torch.int64))
    return torch.equal(a, b)


def model_cut(text: str, iters: int = None) -> str:
    """A path's model text cut to its first `iters` iterations
    (SHORT_ITERS by default): what a run of that many writes byte for
    byte, the reference of a repeat check cut in depth."""
    return lt.Booster(params={"device_type": "cpu"}, model_str=text) \
        .model_to_string(num_iteration=iters or SHORT_ITERS)


def repeat_cut(label: str, train, text: str) -> str:
    """repeat_check of a path cut in depth: `train(SHORT_ITERS)` against
    the path's model `text` cut there (`model_cut`); the line also gives
    the sha256 of the path's own model."""
    return repeat_check("%s (%d iters)" % (label, SHORT_ITERS),
                        lambda: train(SHORT_ITERS), model_cut(text),
                        path_text=text)


def repeat_check(label: str, train, reference_text: str = None,
                 path_text: str = None) -> str:
    """Queue C's check: a path trained twice more in this call from the
    same binned data, the first run under PyTorch's deterministic mode
    (warn_only, its warnings printed), the second without.  Raises unless
    the two model texts are byte-identical (and the path's own run's,
    when given), every recorded f32 histogram bit-identical, every split
    search's outputs and the final scores too (the no-op steps past a
    tree's stop left out: recorded_train); the failure names the first
    array that differs, histograms first.  Returns its line, with the model
    text's sha256 so that calls can be compared."""
    a = recorded_train(train, True)
    b = recorded_train(train, False)
    where = None
    if len(a["hists"]) != len(b["hists"]):
        where = "histogram calls: %d vs %d" % (len(a["hists"]),
                                                len(b["hists"]))
    elif len(a["searches"]) != len(b["searches"]):
        where = "split searches: %d vs %d" % (len(a["searches"]),
                                               len(b["searches"]))
    for k, ((na, ha), (nb, hb)) in enumerate(zip(a["hists"], b["hists"])):
        if where is None and (na != nb or not bits_equal(ha, hb)):
            diff = (ha != hb) if ha.shape == hb.shape else ha.new_ones(1)
            where = ("histogram call %d (%s): %d cells differ, max |diff| "
                     "%.3g" % (k, na, int(diff.sum()),
                               float((ha - hb).abs().max())
                               if ha.shape == hb.shape else float("nan")))
    for k, (ra, rb) in enumerate(zip(a["searches"], b["searches"])):
        if where is None and not all(bits_equal(x, y)
                                     for x, y in zip(ra, rb)):
            field = next(i for i, (x, y) in enumerate(zip(ra, rb))
                         if not bits_equal(x, y))
            where = "split search %d, output field %d" % (k, field)
    if where is None and not np.array_equal(a["scores"].view(np.int32),
                                            b["scores"].view(np.int32)):
        where = "the final scores"
    same = a["text"] == b["text"]
    if where is None and not same:
        where = "the model text at %s" % first_difference(a["text"],
                                                          b["text"])
    check(where is None, "repeat %s: the runs differ, first at %s"
          % (label, where))
    check(reference_text is None or reference_text == a["text"],
          "repeat %s: the model text differs from the path's own run at %s"
          % (label, first_difference(a["text"], reference_text or "")))
    return ("repeat %s: trained twice more, the first run in PyTorch's "
            "deterministic mode: model text byte-identical%s, sha256 %s%s; "
            "%d f32 histograms, %d split searches and the final scores "
            "bit-identical (no-op steps past a tree's stop left out: %d "
            "and %d); deterministic-mode warnings %s"
            % (label, " (and to the path's own run)"
               if reference_text is not None else "", a["sha"],
               " (the path's own model: sha256 %s)" % sha(path_text)
               if path_text is not None else "",
               len(a["hists"]), len(a["searches"]), a["noop_steps"],
               b["noop_steps"], json.dumps(a["warnings"])))


# ---------------------------------------------------------------------------
# phases: the tree as one device program
# ---------------------------------------------------------------------------

#: the early-stopping path's min_data_in_leaf: on the main data its trees
#: stop near 16 of their 255 leaves
EARLY_MIN_DATA = 50_000
#: the rows of the count-0 checks' payloads
EMPTY_ROWS = 65_536


def empty_segment_phase(seed: int, dev) -> dict:
    """Each of B1-B8 on a count-0 segment in the middle of a payload, as
    the no-op steps of a tree pass them: the payload and aux bit for bit
    as they were, num_left 0 and every histogram zero (B5 over three
    empty segments, in f32 and int32; the stage and the commit apart and
    B2 whole; B3, B7 and B8 at their wide shapes).  Raises on the first
    that differs; returns, per kernel, the fields checked."""
    i32 = dict(dtype=torch.int32, device=dev)
    n = EMPTY_ROWS
    out = {}

    def checked(name, pay, aux, fn):
        pay0, aux0 = pay.clone(), aux.clone()
        res = fn()
        torch.cuda.synchronize()
        res = res if isinstance(res, tuple) else (res,)
        fields = []
        for k, r in enumerate(res):
            if r is pay or r is aux:
                continue
            if r.dim() == 0:
                check(int(r) == 0, "%s on 0 rows: num_left %d"
                      % (name, int(r)))
                fields.append("num_left 0")
            else:
                check(not bool(r.ne(0).any()), "%s on 0 rows: histogram %d "
                      "not zero (%d cells)" % (name, k, int(r.ne(0).sum())))
                fields.append("histogram %s zero" % list(r.shape))
        check(bits_equal(pay, pay0) and bits_equal(aux, aux0),
              "%s on 0 rows wrote the payload or aux" % name)
        out[name] = fields + ["payload and aux unchanged"]

    for f, p in ((F, P), (968, 978), (2000, 2010)):
        cols = cols_of(f)
        pay = make_payload(n, f, p, seed + f, dev)
        aux = aux_like(pay)
        start, zero = torch.tensor(n // 2, **i32), torch.zeros((), **i32)
        hk = dict(num_features=f, num_bins=B, grad_col=cols["grad"],
                  hess_col=cols["hess"], cnt_col=cols["cnt"])
        pred = predicates(dev)["numerical"]
        lv, rv = torch.tensor(-0.25, device=dev), torch.tensor(0.75,
                                                               device=dev)
        part = (pay, aux, start, zero, pred, lv, rv, cols["value"])
        if f == F:
            qpay = quantize_columns(pay, n, 127, seed)
            starts = torch.tensor([7, n // 2, n - 1], **i32)
            zeros = torch.zeros(3, **i32)
            for name, q, fn in (
                    ("segment_histogram", pay, lambda: cuda_segment
                     .segment_histogram(pay, start, zero, **hk)),
                    ("segment_histogram_quant", qpay, lambda: cuda_segment
                     .segment_histogram_quant(qpay, start, zero, **hk)),
                    ("segment_histogram_batched f32", pay, lambda:
                     cuda_segment.segment_histogram_batched(
                         pay, starts, zeros, **hk)),
                    ("segment_histogram_batched int32", qpay, lambda:
                     cuda_segment.segment_histogram_batched(
                         qpay, starts, zeros, quantized=True, **hk)),
                    ("partition_segment", pay, lambda: cuda_segment
                     .partition_segment(*part)[2]),
                    ("partition_segment_stage", pay, lambda: cuda_segment
                     .partition_segment_stage(pay, aux, start, zero,
                                              pred)[1]),
                    ("partition_segment_commit", pay, lambda: (
                        cuda_segment.partition_segment_commit(
                            pay, aux, start, zero, zero, lv, rv,
                            cols["value"]), zero)[1]),
                    ("partition_segment_hist", pay, lambda: cuda_segment
                     .partition_segment_hist(*part, B, **{
                         k: v for k, v in hk.items()
                         if k != "num_bins"})[2:])):
                checked(name, q, aux, fn)
            del qpay
        else:
            checked("segment_histogram_colblock %d" % f, pay, aux,
                    lambda: cuda_segment.segment_histogram_colblock(
                        pay, start, zero, **hk))
            wide = cuda_segment.partition_route(p)
            checked("%s %d" % (wide.__name__, p), pay, aux,
                    lambda: wide(*part)[2])
        del pay, aux
        torch.cuda.empty_cache()
    return out


def device_state(bst) -> dict:
    """The grower's device state (the histogram pool without its spare
    slot, which a no-op step writes) and the payload, by name."""
    prog = bst._engine.grower.program
    state = dict(R=prog.R, NODE=prog.NODE, BITS=prog.BITS, NBITS=prog.NBITS,
                 nleaves=prog.nleaves, payload=bst._engine._fast.payload)
    if getattr(prog, "SEG", None) is not None:  # a parent tree may lack it
        state["SEG"] = prog.SEG
    if prog.HIST is not None:
        state["HIST"] = prog.HIST[:-1]
    return state


def replay_check(bst) -> str:
    """One captured split step replayed twice on the same input: a fresh
    tree on the booster's payload is grown five steps by the captured
    root and split step, the state is kept, the step replayed and its
    result kept, the state restored and the step replayed again.  Raises
    unless both replays leave the state and the payload bit for bit
    alike, and the step split a leaf.  The booster is not trained
    further."""
    eng = bst._engine
    prog = eng.grower.program
    check(prog.step.pieces is not None and prog.root.pieces is not None,
          "replay: the root or the split step was never captured")
    fs = eng._fast
    hs = fs.fill_gradients(eng.objective)
    prog.load(torch.ones(eng.train_set.num_features, dtype=torch.bool,
                         device=fs.payload.device), None, hs)
    prog.root()
    for _ in range(5):
        prog.step()
    state = device_state(bst)
    snap = {k: t.clone() for k, t in state.items()}
    prog.step()
    first = {k: t.clone() for k, t in state.items()}
    for k, t in state.items():
        t.copy_(snap[k])
    prog.step()
    torch.cuda.synchronize()
    differ = [k for k in state if not bits_equal(first[k], state[k])]
    check(not differ, "replay: two replays of the split step on the same "
          "input differ in %s" % differ)
    check(int(first["nleaves"]) == int(snap["nleaves"]) + 1 == 7,
          "replay: the step did not split (%d -> %d leaves)"
          % (int(snap["nleaves"]), int(first["nleaves"])))
    return ("replay: the captured split step replayed twice on the same "
            "input (a tree's sixth split, %d payload rows): state %s and "
            "payload bit-identical" % (fs.payload.shape[0],
                                       sorted(k for k in state
                                              if k != "payload")))


def inactive_step_cost(bst, reps: int = 50) -> tuple:
    """Device and host microseconds per replay of the captured split step
    on a finished tree (its loop condition false, so a no-op step), over
    `reps` replays timed with CUDA events; raises unless the state and
    payload are left bit for bit as they were."""
    prog = bst._engine.grower.program
    torch.cuda.synchronize()
    check(not int(prog.flag[0]), "the grower's state is not at a finished "
          "tree")
    state = device_state(bst)
    before = {k: t.clone() for k, t in state.items()}
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    prog.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e0.record()
    for _ in range(reps):
        prog.step()
    e1.record()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    differ = [k for k in state if not bits_equal(before[k], state[k])]
    check(not differ, "a no-op step changed %s" % differ)
    return e0.elapsed_time(e1) * 1e3 / reps, host * 1e6 / reps


def step_kernels(bst) -> int:
    """Device kernels of one replay of the captured split step on a
    finished tree (a no-op step, whose kernels all launch), counted by
    torch.profiler; raises unless the state and payload are left bit for
    bit as they were."""
    from torch.profiler import ProfilerActivity, profile
    prog = bst._engine.grower.program
    torch.cuda.synchronize()
    check(not int(prog.flag[0]), "the grower's state is not at a finished "
          "tree")
    state = device_state(bst)
    before = {k: t.clone() for k, t in state.items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prog.step()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    differ = [k for k in state if not bits_equal(before[k], state[k])]
    check(not differ, "a no-op step changed %s" % differ)
    check(n > 0, "the profiler saw no kernel of the split step")
    return n


#: the main path's eager run: 3 iterations (10 before the entry layers
#: joined the script), held to the graph run's first 3
JIT_OFF_ITERS = 3


def jit_off_check(label: str, train, reference_text: str) -> str:
    """The path trained again with jit=False (the same steps eagerly, no
    capture, still under sync debug mode "error"): raises unless its
    model text is the graph run's byte for byte."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with grower_mode(jit=False):
        bst = train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_trees_stopped("%s, jit=False" % label, bst)
    text = bst.model_to_string()
    check(text == reference_text, "%s: jit=False writes another model "
          "than the graphs, first at %s"
          % (label, first_difference(text, reference_text)))
    return ("jit=False (%s): model text byte-identical to the graph run's, "
            "sha256 %s; %d iterations %.3f s eager"
            % (label, hashlib.sha256(text.encode()).hexdigest(),
               bst.current_iteration(), wall))


def early_stop_phase(data, rows: int, iters: int = 3) -> dict:
    """The main data with min_data_in_leaf=EARLY_MIN_DATA, whose trees stop
    near 16 of their 255 leaves, for `iters` iterations: trained with
    graphs (sync debug mode "error"), held to jit=False by its model text,
    with the split steps enqueued per tree (the lagged stop flag lets at
    most grower2.STEPS_AHEAD no-op steps through) and the cost of a no-op
    step.  Prints its lines; returns its result."""
    ds, Xv, yv = data
    params = train_params(255, min_data_in_leaf=EARLY_MIN_DATA)
    r = train_path("early stop", ds, Xv, yv, params, iters, auc_floor=0.6)
    check(max(r["leaves"]) < 64, "early stop: trees of %s leaves"
          % r["leaves"])
    # the first tree's first step ran eagerly before its capture
    steps = r["replays"].get("grower2.split", 0) + 1
    dev_us, host_us = inactive_step_cost(r["bst"])
    r["inactive_step_us"] = (dev_us, host_us)
    say(path_line(r, rows, iters, ", leaves per tree %s, split steps "
                  "enqueued %d for %d splits (STEPS_AHEAD %d), no-op step "
                  "%.2f us on the device and %.2f us on the host per replay"
                  % (r["leaves"], steps, r["splits"], grower2.STEPS_AHEAD,
                     dev_us, host_us)))
    say(jit_off_check("early stop", lambda: lt.train(
        params, ds, iters, verbose_eval=False), r["model_text"]))
    del r["bst"]
    return r


#: B3's kernels before its in-place redesign, which no path may launch
RETIRED_WIDE = ("rmw_scatter", "flat_copyback", "write_values")
#: the partition wrappers the merged mode retires
SPLIT_PARTITIONS = ("partition_segment", "partition_segment_stage",
                    "partition_segment_commit", "partition_segment_rmw",
                    "partition_segment_blocks")


def merged_path_phase(data, f32: dict, rows: int, iters: int) -> dict:
    """The grower's merged mode at full width, on the main path's params
    and data: with cuda_segment.PARTITION_HIST_VALIDATED set in-process
    (as bench.py sets the JAX package's flag after its probe), every split
    runs B6 and nothing else of the partition, B1 runs once per tree (the
    root), and the first split is the f32 main path's, within 0.002 of
    its AUC; profiled like the main path.  Prints its lines; returns its
    result."""
    ds, Xv, yv = data
    cuda_segment.PARTITION_HIST_VALIDATED = True
    try:
        r = train_path("merged", ds, Xv, yv, train_params(255), iters)
        n = r["launches"]
        g = r["bst"]._engine.grower
        engines = (g.hist_engine, g.part_engine)
        check(engines == ("partition_segment_hist",) * 2,
              "merged path took %s" % (engines,))
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
        note = (", first split %s as on the f32 main path"
                % (r["first_split"],))
        say(path_line(r, rows, iters, note + auc_note(r, f32)))
        say(profile_phase(r["bst"], "merged"))
    finally:
        cuda_segment.PARTITION_HIST_VALIDATED = False
    del r["bst"]
    return r


def merged_train(ds, iters: int):
    """The merged path's training: the main path's params with
    cuda_segment.PARTITION_HIST_VALIDATED set in-process."""
    cuda_segment.PARTITION_HIST_VALIDATED = True
    try:
        return lt.train(train_params(255), ds, iters, verbose_eval=False)
    finally:
        cuda_segment.PARTITION_HIST_VALIDATED = False


@contextlib.contextmanager
def calls_on_rows(name: str):
    """Within the block, wrapper `name` adds each of its calls whose count
    is non-zero to a device counter (inside a captured graph too, so every
    replay adds); yields the 0-d int64 counter."""
    real = getattr(cuda_segment, name)
    counter = torch.zeros((), dtype=torch.int64, device="cuda")

    def spy(payload, start, count, **kw):
        counter.add_((torch.as_tensor(count, device=payload.device)
                      > 0).to(torch.int64))
        return real(payload, start, count, **kw)

    spy.__name__ = real.__name__
    spy.launches = real.launches
    setattr(cuda_segment, name, spy)
    try:
        yield counter
    finally:
        # the wrapper counts its launches under its module name: the spy's
        real.launches = spy.launches
        setattr(cuda_segment, name, real)


def histogram_mode_phases(data, f32: dict, rows: int, iters: int) -> dict:
    """The grower's two other histogram modes at full width, on the main
    path's params and data: merged_path_phase, then pooled:
    histogram_pool_size=2 (MB) leaves a few dozen slots for 255 leaves, so
    evicted parents are rebuilt by B1 from their rows, within 0.002 of the
    main path's AUC.  Prints one line per path; returns the results by
    name."""
    ds, Xv, yv = data
    runs = {"merged": merged_path_phase(data, f32, rows, iters)}
    # the profile inside the block too: the captured steps count their
    # launches to the spy
    with calls_on_rows("segment_histogram") as on_rows:
        r = train_path("pooled", ds, Xv, yv,
                       train_params(255, histogram_pool_size=2), iters)
        on_rows = int(on_rows)
        pooled_profile = profile_phase(r["bst"], "pooled")
    n = r["launches"]
    slots = r["bst"]._engine.grower_cfg.hist_pool_slots
    # B1 on rows: the roots, the smaller children and the rebuilds (the
    # rebuild launches on every split, with count 0 where the parent's
    # slot is live)
    rebuilds = on_rows - iters - r["splits"]
    check(0 < slots < 255, "pooled path: %d pool slots" % slots)
    check(rebuilds > 0, "pooled path: no parent rebuilt (B1 %d, %d splits)"
          % (n["segment_histogram"], r["splits"]))
    check(n["partition_segment_hist"] == 0,
          "pooled path launched the merged kernel")
    say(path_line(r, rows, iters, ", %d pool slots, %d parent rebuilds"
                  % (slots, rebuilds) + auc_note(r, f32)))
    say(pooled_profile)
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


#: the quantized and frontier paths, by name
QUANT_PATHS = {
    "quantized int8": dict(gradient_quantization=True,
                           gradient_quant_dtype="int8"),
    "quantized int16": dict(gradient_quantization=True,
                            gradient_quant_dtype="int16"),
    "frontier 8": dict(tpu_frontier_batch=8),
    "quantized int8 + frontier 8": dict(
        gradient_quantization=True, gradient_quant_dtype="int8",
        tpu_frontier_batch=8)}
#: the quantized and frontier paths that are profiled
QUANT_PROFILED = tuple(QUANT_PATHS)


def quantized_phases(data, f32: dict, rows: int, iters: int,
                     names=tuple(QUANT_PATHS)) -> dict:
    """The paths of QUANT_PATHS named in `names`, at full width: int8 and
    int16 quantized gradients, f32 with tpu_frontier_batch=8, and int8
    with tpu_frontier_batch=8 (whose model text must be the int8 path's,
    when that ran too).  Prints one line per path (and a profile of those
    in QUANT_PROFILED) as it goes; returns the results by name."""
    ds, Xv, yv = data
    runs = {}
    for name in names:
        extra = QUANT_PATHS[name]
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
        if name == "quantized int8 + frontier 8" and "quantized int8" in runs:
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
        if name in QUANT_PROFILED:
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


#: the wide parity's iterations (5 before the runtime's seams joined the
#: script, 2 before the entry layers did; the first split and |dAUC| are
#: still held)
WIDE_PARITY_ITERS = 1


def wide_parity_phase(seed: int, dev) -> str:
    """CUDA against CPU training at both wide widths: 10,000 rows, max_bin
    63, 31 leaves, WIDE_PARITY_ITERS iterations; the first split must
    agree and the AUC on
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
            bst = lt.train(params, lt.Dataset(Xt, label=yt),
                           WIDE_PARITY_ITERS, verbose_eval=False)
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
            "leaves, %d iters: " % WIDE_PARITY_ITERS
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
    mem0 = torch.cuda.max_memory_allocated()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with grower_mode():
        bst = lt.train(params, ds, iters, valid_sets=[dv],
                       valid_names=["valid"], evals_result=evals,
                       verbose_eval=False)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    check_trees_stopped(name, bst)
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
    check(not DEVICE_LOOP or syncs == [1] * iters,
          "%s: blocking syncs per tree %s, not one" % (name, syncs))
    line = ("%s: %dx%d (+%d valid), NaN share %.2f on every other feature, "
            "max_bin 255, 255 leaves, lr 0.1, %d iters: %.4f s/iter (train "
            "%.3f s), syncs/tree %s, max_memory_allocated %d B (%d B "
            "before), data %.3f s, "
            "binning %.3f s, predict %.3f s, valid score vs predict max rel "
            "%.3g, valid AUC per iteration %s, AUC of predict %.8f, launches "
            "%s" % (name, rows, f, n_valid, WIDE_NAN[f], iters,
                    t_train / iters, t_train, syncs, peak, mem0, t_gen, t_bin,
                    t_pred, score_err, json.dumps(aucs), auc_pred,
                    json.dumps(launches)))
    return line, dict(bst=bst, launches=launches, ds=ds, dv=dv)


#: each profiled path's ported kernels, {label: {group: [launches, ms]}}
PROFILED = {}
#: the host's enqueue calls, by kind: the runtime / driver API names
ENQUEUE_CALLS = {"kernel": ("LaunchKernel",), "graph": ("GraphLaunch",),
                 "copy or fill": ("MemcpyAsync", "MemsetAsync")}


class EventSum:
    """One event name's records summed, with the attributes of
    torch.profiler's key_averages() entries that profile_phase reads."""

    def __init__(self, key: str, device_type):
        self.key, self.device_type = key, device_type
        self.count, self.self_device_time_total = 0, 0.0


def event_sums(prof) -> list:
    """prof.key_averages()'s entries (by event name and device type: the
    count and, for device events, the summed duration in us) summed from
    the profiler's raw records under key_averages' own name filter and
    rewrite.  key_averages first builds an event object and a tree per
    record, ~100 us each: a minute for a 7-class iteration's ~600k
    kernels.  profile_phase(crosscheck=True) holds the two equal."""
    from torch.autograd.profiler_util import _filter_name, _rewrite_name
    sums = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if _filter_name(name) or getattr(e, "is_hidden_event",
                                         lambda: False)():
            continue
        key = (_rewrite_name(name, with_wildcard=True), e.device_type())
        if key not in sums:
            sums[key] = EventSum(*key)
        rec = sums[key]
        rec.count += 1
        if key[1] == torch.autograd.DeviceType.CUDA:
            rec.self_device_time_total += (e.end_ns() - e.start_ns()) / 1e3
    return list(sums.values())


def profile_phase(bst, label: str, launched=(), retired=(),
                  crosscheck: bool = False) -> str:
    """Two more boosting iterations of a trained booster: one timed
    on the host clock alone, then one under torch.profiler.  Prints both
    walls, the profiled iteration's summed kernel time, the device's idle
    share against each wall (the unprofiled one is the reading; the
    profiler slows the host), the ported kernels' launches and device
    time (kept in PROFILED), the wrappers' calls and each histogram's and
    partition's device time per call, and the kernels that take the most
    device time.  Raises unless a
    kernel named by each of `launched` ran and none named by `retired`
    did.  Only device activity is recorded: with the ~90k host ops of an
    iteration recorded too, reading the profile took over a minute.  The
    records are summed by event_sums; with `crosscheck`, raises unless
    every device event's count and time equal key_averages'."""
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
    averages = event_sums(prof)
    kernels = [e for e in averages
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if crosscheck:
        want = {e.key: (e.count, e.self_device_time_total)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}
        got = {e.key: (e.count, e.self_device_time_total) for e in kernels}
        check(want.keys() == got.keys() and all(
            got[k][0] == want[k][0]
            and abs(got[k][1] - want[k][1]) <= 1e-6 * want[k][1] + 1e-3
            for k in want), "profile (%s): the summed records differ from "
              "key_averages' at %s" % (label, sorted(
                  k for k in set(want) | set(got)
                  if want.get(k, (0, 0))[0] != got.get(k, (0, 0))[0])[:3]))
    # the host's enqueue calls, from the runtime / driver API records
    api = {}
    for e in averages:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            for kind, words in ENQUEUE_CALLS.items():
                if any(w in e.key for w in words):
                    api[kind] = api.get(kind, 0) + e.count
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    check(busy > 0, "the profiler saw no device time")
    for name in launched:
        check(any(name in e.key for e in kernels),
              "profile (%s): no %s kernel ran" % (label, name))
    for name in retired:
        check(not any(name in e.key for e in kernels),
              "profile (%s): a %s kernel ran" % (label, name))
    # the histogram kernels share one body: segment_hist_kernel<true>
    # serves B1, <false> B4, and segment_hist_batched_kernel B5 in f32 and
    # int32 (a parent tree's <float> / <int> served B5 too); B3 and B8
    # share their routing.  "partition" is B2's kernels (whole, or the
    # stage and commit)
    ported = {}
    for prefixes, name in (
            (("segment_hist_kernel<float>", "segment_hist_kernel<true>"),
             "histogram f32"),
            (("segment_hist_kernel<int>", "segment_hist_kernel<false>"),
             "histogram int32"),
            (("segment_hist_batched_kernel<true>",), "histogram batched f32"),
            (("segment_hist_batched_kernel<false>",),
             "histogram batched int32"),
            (("hist_colblock",), "histogram colblock"),
            (("part_",), "partition"),
            (("phist_",), "partition + histogram"),
            (("rmw_",), "partition rmw"),
            (("route_", "block_move", "wide_copy_side"), "partition blocks")):
        hits = [e for e in kernels if any(p in e.key for p in prefixes)]
        ported[name] = [sum(e.count for e in hits),
                        round(sum(e.self_device_time_total
                                  for e in hits) / 1e3, 4)]
    PROFILED[label] = ported
    # device microseconds per call: where one wrapper of a family (the
    # histograms, the partitions) ran, the family's kernels are its, by
    # whatever names they have
    per_call = {}
    for wrapper, group in (("segment_histogram_batched",
                            ("histogram batched f32",
                             "histogram batched int32")),
                           ("segment_histogram_quant", ("histogram int32",))):
        # B5 under its own name, and B4 beside it on the int8 + frontier
        # path (this tree's names only)
        if calls.get(wrapper) and sum(ported[g][0] for g in group):
            per_call[wrapper] = round(sum(ported[g][1] for g in group)
                                      * 1e3 / calls[wrapper], 3)
    for family, groups in (
            (("segment_histogram", "segment_histogram_quant",
              "segment_histogram_colblock", "segment_histogram_batched"),
             ("histogram f32", "histogram int32", "histogram colblock",
              "histogram batched f32", "histogram batched int32")),
            (("partition_segment", "partition_segment_stage",
              "partition_segment_commit", "partition_segment_hist",
              "partition_segment_rmw", "partition_segment_blocks"),
             ("partition", "partition + histogram", "partition rmw",
              "partition blocks"))):
        ran = [w for w in family if calls.get(w)]
        if len(ran) == 1:
            per_call[ran[0]] = round(sum(ported[g][1] for g in groups)
                                     * 1e3 / calls[ran[0]], 3)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return ("profile (%s): one iteration %.4f s wall unprofiled, %.4f s "
            "wall profiled, %.4f s summed kernel time (profiled), device idle "
            "share %.4f against the unprofiled wall (%.4f against the "
            "profiled), %d device kernels, host enqueue calls %d %s; ported "
            "kernels [launches, ms]: %s; wrapper calls %s; device us per "
            "call %s; top [name, launches, ms]: %s"
            % (label, wall, wall_prof, busy, 1.0 - busy / wall,
               1.0 - busy / wall_prof, sum(e.count for e in kernels),
               sum(api.values()), json.dumps(api),
               json.dumps(ported), json.dumps(calls), json.dumps(per_call),
               json.dumps([[e.key[:60], e.count,
                            round(e.self_device_time_total / 1e3, 4)]
                           for e in top])))


def merged_pays_line(census_bounds: dict) -> str:
    """From the main and merged paths' profiles: B1's and B6's device ms
    per iteration beside the census's byte bounds per iteration, and
    whether the merged path's B6 takes less device time per iteration
    than the main path's B1 + B2 (which it replaces, with the
    subtraction)."""
    main, merged = PROFILED["main path"], PROFILED["merged"]
    b1_b2 = main["histogram f32"][1] + main["partition"][1]
    b6 = merged["partition + histogram"][1]
    return ("merged vs main: B6 %.4f ms/iter on the merged path (census "
            "bound %.4f), B1 %.4f + B2 %.4f = %.4f ms/iter on the main path "
            "(B1's census bound %.4f); B6 below B1 + B2: %s"
            % (b6, census_bounds["partition_segment_hist"],
               main["histogram f32"][1], main["partition"][1], b1_b2,
               census_bounds["segment_histogram"], b6 < b1_b2))


def compare_kernels_phase(seed: int, dev) -> dict:
    """The kernels this tree changed, timed through their wrappers so that
    a parent tree's are timed alike: B5 in f32 and int32 at the 8-segment
    shape of kernels_phase; B2's stage + commit on fresh rows at the
    numerical split, at the root and at CENSUS_SIZES; B7 at the Bosch and
    Epsilon roots.  Each: ms per call (CUDA events) and the device us of
    its kernels per call (torch.profiler).  Returns the readings."""
    i32 = dict(dtype=torch.int32, device=dev)
    n = 1_015_808
    out = {}
    pay = make_payload(n, F, P, seed, dev)
    hk = dict(num_features=F, num_bins=B, grad_col=COLS["grad"],
              hess_col=COLS["hess"], cnt_col=COLS["cnt"])
    qpay = quantize_columns(pay, n, 127, seed + 127)
    tstarts, tcounts = batch_segments(n, [n // d for d in (4, 5, 8, 10, 16,
                                                           20, 32, 64)])
    ts_t, tc_t = torch.tensor(tstarts, **i32), torch.tensor(tcounts, **i32)
    bsc = scale_kw(cuda_segment.segment_histogram_batched, pay, tstarts,
                   tcounts, F)
    b1_rows = torch.tensor(sum(tcounts), **i32)
    start0 = torch.zeros((), **i32)
    for key, fn in (
            ("b1_same_rows", lambda: cuda_segment.segment_histogram(
                pay, start0, b1_rows, **hk, **bsc)),
            ("b5_f32", lambda: cuda_segment.segment_histogram_batched(
                pay, ts_t, tc_t, **hk, **bsc)),
            ("b5_int32", lambda: cuda_segment.segment_histogram_batched(
                qpay, ts_t, tc_t, quantized=True, **hk))):
        out[key] = dict(ms=time_ms(fn, 20), kernel_us=sum(
            kernel_breakdown(fn, pay, 0, 1, 20).values()))
    del qpay
    aux = torch.zeros_like(pay)
    pred = predicates(dev)["numerical"]
    lv, rv = torch.tensor(-0.25, device=dev), torch.tensor(0.75, device=dev)
    sc = {}
    for rows in CENSUS_SIZES + (n,):
        ct = torch.tensor(rows, **i32)

        def fn():
            stage_commit(pay, aux, start0, ct, pred, lv, rv, COLS["value"])

        sc[rows] = dict(ms=time_fresh_ms(fn, pay, 0, rows, 20),
                        kernel_us=kernel_breakdown(fn, pay, 0, rows, 20))
    out["stage_commit"] = sc
    del pay, aux
    torch.cuda.empty_cache()
    for f, rows in WIDE:
        n = -(-rows // 16384) * 16384
        cols = cols_of(f)
        wk = dict(num_features=f, num_bins=B, grad_col=cols["grad"],
                  hess_col=cols["hess"], cnt_col=cols["cnt"])
        pay = device_payload(n, f, f + 10, seed + f, dev)
        ct = torch.tensor(n, **i32)
        wsc = scale_kw(cuda_segment.segment_histogram_colblock, pay, 0, n, f)

        def fn():
            cuda_segment.segment_histogram_colblock(pay, start0, ct, **wk,
                                                    **wsc)

        out["b7_root_%d" % f] = dict(ms=time_ms(fn, 10), kernel_us=sum(
            kernel_breakdown(fn, pay, 0, 1, 10).values()))
        del pay
        torch.cuda.empty_cache()
    return out


def compare_phase(rows: int, iters: int, seed: int) -> None:
    """The readings that compare two trees in one call, main()'s own
    phases: sizes_phase (B1, B6), compare_kernels_phase (B5, the stage +
    commit, B7's roots), then every training path of main() trained and
    profiled (s/iter, blocking syncs per tree, host enqueue calls, device
    kernels, idle share, peak memory): the main, merged and pooled paths,
    the quantized and frontier paths, then both wide paths.  It drives only the port's public wrappers and
    entry points, so this file run beside a parent tree's package times
    the parent's; chip_compare.py runs it in each tree in turn."""
    dev = torch.device("cuda", 0)
    build.build_all()
    say("compare: %s" % nvidia_smi())
    say("sizes: %s" % json.dumps(sizes_phase(1_015_808, seed, dev)))
    say("kernels: %s" % json.dumps(compare_kernels_phase(seed, dev)))
    line, f32, data = main_path_phase(rows, iters, seed)
    say(line)
    say(profile_phase(f32["bst"], "main path"))
    del f32["bst"]
    histogram_mode_phases(data, f32, rows, iters)
    quantized_phases(data, f32, rows, iters)
    del data
    for f, wide_rows in WIDE:
        line, r = wide_path_phase(f, wide_rows, iters, seed, dev)
        say(line)
        say(profile_phase(r["bst"], "wide %d" % f))
        del r
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases: prediction on the card (models/device_predictor.py)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def sync_errors():
    """torch.cuda.set_sync_debug_mode("error") inside the block: a sync the
    code did not mean to make raises (the predictor lifts it for its one
    output fetch per micro-batch, runtime/syncs.wait_event)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def fetches_since(before: dict) -> int:
    return syncs.delta(before)["by_label"].get("predict_fetch", 0)


def predict_main_phase(bst, Xv, yv) -> str:
    """The main path's model predicts the held-out rows with device=True
    (f32 thresholds, CUDA graphs) and on the host (f64): within rtol 1e-5
    / atol 1e-6 and the same AUC within 1e-6; binary prediction early stop
    truncates as the host's does, and out_dtype=float32 is the f64
    answer's exact downcast.  The device calls run under sync debug mode
    "error" but for their one output fetch per micro-batch."""
    before = syncs.snapshot()
    with sync_errors():
        t0 = time.perf_counter()
        dev = bst.predict(Xv, device=True)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = bst.predict(Xv, device=True)
        t_dev = time.perf_counter() - t0
    fetches = fetches_since(before)
    t0 = time.perf_counter()
    host = bst.predict(Xv)
    t_host = time.perf_counter() - t0
    check(np.array_equal(dev, again), "predict: two device calls differ")
    check(np.allclose(dev, host, rtol=1e-5, atol=1e-6),
          "predict: device vs host max |diff| %.3g"
          % float(np.abs(dev - host).max()))
    auc_d, auc_h = auc_score(yv, dev), auc_score(yv, host)
    check(abs(auc_d - auc_h) <= 1e-6, "predict: AUC device %.8f host %.8f"
          % (auc_d, auc_h))
    kw = dict(pred_early_stop=True, pred_early_stop_freq=1,
              pred_early_stop_margin=0.5, raw_score=True)
    with sync_errors():
        es_dev = bst.predict(Xv, device=True, **kw)
        f32 = bst.predict(Xv, device=True, out_dtype=np.float32)
    es_host = bst.predict(Xv, **kw)
    check(np.allclose(es_dev, es_host, rtol=1e-5, atol=1e-6),
          "predict: early stop device vs host max |diff| %.3g"
          % float(np.abs(es_dev - es_host).max()))
    truncated = int(np.sum(es_host != bst.predict(Xv, raw_score=True)))
    check(truncated > 0, "predict: early stop truncated no row")
    check(f32.dtype == np.float32 and np.array_equal(
        f32, dev.astype(np.float32)), "predict: out_dtype=float32 is not "
          "the f64 answer's downcast")
    return ("predict (main path, %d trees): %d held-out rows, device %.4f s "
            "(first call with its capture %.4f s, %d output fetches in 2 "
            "calls), host f64 %.4f s; max |device - host| %.3g; AUC device "
            "%.8f host %.8f; binary early stop (freq 1, margin 0.5) within "
            "rtol 1e-5 of the host's, %d rows truncated; out_dtype=float32 "
            "the exact downcast"
            % (len(bst._model.trees), len(yv), t_dev, t_first, fetches,
               t_host, float(np.abs(dev - host).max()), auc_d, auc_h,
               truncated))


#: bench.py's serving shape (bench_predict)
SERVE_ROWS, SERVE_TREES, SERVE_LEAVES = 1_000_000, 500, 255
#: rows of the host f64 reference and of the buckets' and batch_rows' checks
SERVE_CHECK_ROWS = 20_000


def synth_serving_model(n_trees: int, num_leaves: int, n_feat: int,
                        seed: int):
    """bench.py's synth_serving_model for the port's model classes: an
    ensemble built directly (no training), random features and
    thresholds, a random leaf split each time (leaf-wise depth profile)."""
    from lightgbm_tpu_torch.models.gbdt_model import GBDTModel
    from lightgbm_tpu_torch.models.tree import Tree
    rng = np.random.default_rng(seed)
    model = GBDTModel()
    model.num_class = 1
    model.num_tree_per_iteration = 1
    model.max_feature_idx = n_feat - 1
    model.objective_str = "binary sigmoid:1"
    for _ in range(n_trees):
        t = Tree(num_leaves)
        while t.num_leaves < num_leaves:
            leaf = int(rng.integers(0, t.num_leaves))
            t.split(leaf, int(rng.integers(0, n_feat)), 0,
                    float(rng.standard_normal()),
                    float(rng.standard_normal() * 0.01),
                    float(rng.standard_normal() * 0.01),
                    10, 10, 1.0, 2, bool(rng.integers(0, 2)))
        model.trees.append(t)
    return model


def serving_phase(seed: int, dev, smi: str) -> str:
    """The device predictor at bench.py's serving shape: 1,000,000 x 28
    f32 rows from the seed through a 500-tree x 255-leaf synthetic model.
    Prints the steady rows/s (a second call, after the captures), the
    first call's, the host f64 reference's rows/s on 20,000 rows and its
    max |diff| (held to 1e-5), depth iterations, captures per bucket, the
    micro-batches, peak device memory and the bound per depth level (the
    [N, T] int64 frontier read and written once).  Holds a second ragged
    call in one bucket to no new capture, every bucket from 16 to 2^15
    rows and batch_rows=128 to the default's output bit for bit, and the
    int8 leaf table to its grid bound.  Device calls run under sync debug
    mode "error" but for their output fetches."""
    DevicePredictor = device_predictor.DevicePredictor
    t0 = time.perf_counter()
    model = synth_serving_model(SERVE_TREES, SERVE_LEAVES, F, seed)
    X = np.random.default_rng(seed + 17).standard_normal(
        (SERVE_ROWS, F)).astype(np.float32)
    t_make = time.perf_counter() - t0
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dp = DevicePredictor(model, device=dev)
    site = "predictor.tree_parallel"
    caps0 = graph_counts().get(site, {}).get("captures", 0)
    before = syncs.snapshot()
    with sync_errors():
        t0 = time.perf_counter()
        first = dp.predict_raw(X)
        t_first = time.perf_counter() - t0
        caps = dp.capture_count()
        mb0, fetch0 = dp.micro_batches, fetches_since(before)
        t0 = time.perf_counter()
        out = dp.predict_raw(X)
        t_steady = time.perf_counter() - t0
    batches = dp.micro_batches - mb0
    fetches = fetches_since(before) - fetch0
    peak = torch.cuda.max_memory_allocated() - mem0
    check(np.array_equal(out, first), "serving: two calls differ")
    check(dp.capture_count() == caps, "serving: the steady call captured")
    check(fetches == batches, "serving: %d output fetches for %d "
          "micro-batches" % (fetches, batches))
    check(bool(np.isfinite(out).all()) and out.shape == (SERVE_ROWS, 1),
          "serving: output malformed")
    with sync_errors():
        a = dp.predict_raw(X[:1000])
        caps_a = dp.capture_count()
        b = dp.predict_raw(X[:900])
    check(dp.capture_count() == caps_a, "serving: a second ragged call in "
          "bucket 1024 captured")
    check(np.array_equal(a, out[:1000]) and np.array_equal(b, out[:900]),
          "serving: a ragged call differs from the full call's rows")
    n = SERVE_CHECK_ROWS
    t0 = time.perf_counter()
    host = model.predict_raw(X[:n].astype(np.float64))
    t_host = time.perf_counter() - t0
    err = float(np.abs(out[:n] - host).max())
    check(err <= 1e-5, "serving: max |device - host| %.3g > 1e-5" % err)
    buckets = []
    with sync_errors():
        for k in range(4, 16):
            for rows in (1 << k, (1 << k) - 3):
                got = dp.predict_raw(X[:rows])
                check(np.array_equal(got, out[:rows]), "serving: %d rows "
                      "(bucket %d) differ from the full call" % (rows,
                                                                 1 << k))
            buckets.append(1 << k)
        small = DevicePredictor(model, batch_rows=128, device=dev)
        got = small.predict_raw(X[:n])
        dq = DevicePredictor(model, leaf_quant="int8", device=dev)
        q = dq.predict_raw(X[:n])[:, 0]
    check(np.array_equal(got, out[:n]), "serving: batch_rows=128 differs "
          "from the default micro-batches")
    amax = np.abs(np.asarray(dq._packed["leaf"], np.float64)).max(axis=1)
    bound = float(np.where(amax > 0, amax, 127.0).sum() / 127.0)
    err_q = float(np.abs(q - host[:, 0]).max())
    check(0.0 < err_q <= bound, "serving: int8 leaves max |diff| %.4g "
          "outside (0, %.4g]" % (err_q, bound))
    caps_site = graph_counts().get(site, {}).get("captures", 0) - caps0
    # the bound per depth level: the [N, T] int64 frontier read and
    # written once; the whole call's: that per level, X read and the
    # output written once
    level_bytes = SERVE_ROWS * SERVE_TREES * 16
    level_ms = level_bytes / HBM_BYTES_PER_S * 1e3
    call_ms = (dp.depth_iters * level_bytes + X.nbytes + SERVE_ROWS * 4) \
        / HBM_BYTES_PER_S * 1e3
    return ("serving predict (%s): %d x %d f32 rows, %d trees x %d leaves "
            "(model made in %.2f s): steady %.1f rows/s (%.4f s), first "
            "call %.4f s with its captures; host f64 %.1f rows/s on %d rows "
            "(%.3f s), max |device - host| %.3g; depth iterations %d; "
            "batch_rows %d, %d micro-batches per call, %d programs (one "
            "CUDA graph each; %d captures at the site in this phase, 0 in "
            "the steady call or a second ragged call in one bucket); peak "
            "device memory %d B over the phase; bound per depth level "
            "%.4f ms (%d B of int64 frontier read and written), per call "
            "%.4f ms; buckets %s and batch_rows=128 bit-identical to the "
            "full call; int8 leaves max |diff| %.4g within the grid bound "
            "%.4g"
            % (smi, SERVE_ROWS, F, SERVE_TREES, SERVE_LEAVES, t_make,
               SERVE_ROWS / t_steady, t_steady, t_first, n / t_host, n,
               t_host, err, dp.depth_iters, dp.batch_rows, batches,
               dp.capture_count(), caps_site, peak, level_ms, level_bytes,
               call_ms, buckets, err_q, bound))


# ---------------------------------------------------------------------------
# phase: categorical features in training
# ---------------------------------------------------------------------------

#: the airline on-time data of the ASA Data Expo 2009 as szilard/benchm-ml
#: uses it (its 1M-row training set): the categorical columns and their
#: levels, then DepTime and Distance
AIRLINE_LEVELS = (("Month", 12), ("DayofMonth", 31), ("DayOfWeek", 7),
                  ("UniqueCarrier", 22), ("Origin", 300), ("Dest", 300))
AIRLINE_ROWS, AIRLINE_VALID = 1_000_000, 100_000
#: the CUDA vs CPU parity cut
CAT_PARITY_ROWS = 20_000
#: the categorical parity's iterations (10 before the runtime's seams
#: joined the script; the root split and |dAUC| are still held)
CAT_PARITY_ITERS = 3
#: the held-out AUC floor of the airline-shaped data (the benchmark's GBDT
#: results sit near 0.70-0.75)
CAT_AUC_FLOOR = 0.65


def airline_synth(n_rows: int, seed: int):
    """Rows shaped after the airline data: six categorical columns with its
    cardinalities (level ids drawn Zipf-like where there are more than 12
    levels, a few carriers and airports carry most flights), DepTime
    (hhmm-like, 1-2400) and Distance (log-normal miles), and a label drawn
    from a logistic model of random per-level effects (not monotone in the
    level id) plus the numeric terms."""
    rng = np.random.default_rng(seed)
    cols, logit = [], np.zeros(n_rows)
    for _, k in AIRLINE_LEVELS:
        w = 1.0 / np.arange(1, k + 1) ** 1.3 if k > 12 else np.ones(k)
        ids = rng.permutation(k)[rng.choice(k, n_rows, p=w / w.sum())]
        logit += (rng.standard_normal(k) * (0.6 if k > 12 else 0.3))[ids]
        cols.append(ids.astype(np.float64))
    dep = np.clip(rng.normal(1330, 470, n_rows), 1, 2400).round()
    dist = np.exp(rng.normal(6.4, 0.6, n_rows)).round()
    logit += 1.2 * (dep / 2400 - 0.5) + 0.15 * (np.log(dist) - 6.4)
    y = rng.random(n_rows) < 1 / (1 + np.exp(-(logit - 1.5)))
    return np.column_stack(cols + [dep, dist]), y.astype(np.float64)


def categorical_phase(seed: int, iters: int, main_run: dict):
    """Categorical training on the card: airline-shaped data from the
    seed, 1,000,000 training rows and 100,000 held out, max_bin 255, 255
    leaves, lr 0.1.  Checks that categorical splits occur, that B1 and B2
    launch and B3 / B7 / B8 do not, that the held-out AUC beats the same
    data with the columns treated as numeric, that the validation scores
    kept on the card equal predict(raw_score=True) and predict(device=True)
    the host predict, the repeat check, that frontier 8 writes the same
    model text, CUDA vs CPU parity on a 20,000-row cut and every B2 call
    of one iteration against the plain partition with its bitset.
    Prints its lines; returns the path's launch counts."""
    cats = list(range(len(AIRLINE_LEVELS)))
    X, y = airline_synth(AIRLINE_ROWS + AIRLINE_VALID, seed + 23)
    Xt, yt = X[:AIRLINE_ROWS], y[:AIRLINE_ROWS]
    Xv, yv = X[AIRLINE_ROWS:], y[AIRLINE_ROWS:]
    params = train_params(255, metric="auc")
    t0 = time.perf_counter()
    ds = lt.Dataset(Xt, label=yt, categorical_feature=cats)
    ds.construct(lt.Config(params))
    dv = lt.Dataset(Xv, label=yv, reference=ds)
    dv.construct(lt.Config(params))
    t_bin = time.perf_counter() - t0
    nbins = [m.num_bin for m in ds.binned.bin_mappers]
    check(ds.binned.max_num_bin <= B, "categorical: %d bins" %
          ds.binned.max_num_bin)
    r = train_path("categorical", ds, Xv, yv, params, iters,
                   auc_floor=CAT_AUC_FLOOR, valid_sets=[dv])
    bst, launches = r["bst"], r["launches"]
    check(launches["segment_histogram"] > 0 and
          launches["partition_segment"] > 0,
          "categorical: B1 / B2 launched %d / %d times"
          % (launches["segment_histogram"], launches["partition_segment"]))
    cat_nodes = sum(int(np.sum(t.decision_type[:t.num_leaves - 1] & 1))
                    for t in bst._model.trees)
    check(cat_nodes > 0, "categorical: no categorical split")
    valid = bst._engine.raw_valid_score(0)[0]
    raw, host = r["raw"], r["pred"]
    check(np.allclose(valid, raw, rtol=1e-5,
                      atol=1e-5 * max(1.0, float(np.abs(raw).max()))),
          "categorical: valid scores vs predict max |diff| %.3g"
          % float(np.abs(valid - raw).max()))
    with sync_errors():
        dev_pred = bst.predict(Xv, device=True)
    check(np.allclose(dev_pred, host, rtol=1e-5, atol=1e-6),
          "categorical: predict(device=True) vs host max |diff| %.3g"
          % float(np.abs(dev_pred - host).max()))
    say(path_line(r, AIRLINE_ROWS, iters, ", binning %.3f s (%s "
                           "bins), %d categorical of %d split nodes"
                           % (t_bin, nbins, cat_nodes, r["splits"]),
                  n_feat=X.shape[1]))
    kernels = step_kernels(bst)
    ds_num = lt.Dataset(Xt, label=yt)
    ds_num.construct(lt.Config(params))
    rn = train_path("categorical as numeric", ds_num, Xv, yv, params, iters,
                    auc_floor=CAT_AUC_FLOOR)
    check(r["auc"] > rn["auc"], "categorical: held-out AUC %.6f does not "
          "beat the numeric treatment's %.6f" % (r["auc"], rn["auc"]))
    say("categorical vs main: %.4f s/iter (main path %.4f); device kernels "
        "per split step %d (one replay of the captured step; main path %d); "
        "held-out AUC %.6f, the columns as numeric %.6f (%.4f s/iter); "
        "valid scores equal predict(raw_score=True), predict(device=True) "
        "equals host predict (max |diff| %.3g)"
        % (r["s_per_iter"], main_run["s_per_iter"], kernels,
           main_run["step_kernels"], r["auc"], rn["auc"], rn["s_per_iter"],
           float(np.abs(dev_pred - host).max())))
    text = r["model_text"]
    del r, rn, bst, ds_num
    say(repeat_cut("categorical", lambda n: lt.train(
        params, ds, n, verbose_eval=False), text))
    with grower_mode():
        front = lt.train(dict(params, tpu_frontier_batch=8), ds, iters,
                         verbose_eval=False)
    check(front.model_to_string() == text, "categorical: frontier 8's "
          "model text differs at %s" % first_difference(
              front.model_to_string(), text))
    say("categorical frontier 8: model text byte-identical to the one-leaf "
        "loop's, %.2f split rounds per tree" % front.split_rounds_per_tree())
    del front
    # one iteration keeps the script inside the chip tool's time limit
    say(checked_partition_phase((ds, Xv, yv), AIRLINE_ROWS, 1, params=params,
                                label="B2 in categorical training"))
    runs = {}
    for device in ("cuda", "cpu"):
        p = train_params(63) if device == "cuda" \
            else train_params(63, device_type="cpu")
        b = lt.train(p, lt.Dataset(Xt[:CAT_PARITY_ROWS],
                                   label=yt[:CAT_PARITY_ROWS],
                                   categorical_feature=cats),
                     CAT_PARITY_ITERS, verbose_eval=False)
        check(b.device.type == device, "categorical parity on %s" % b.device)
        t0 = b._model.trees[0]
        runs[device] = (int(t0.split_feature[0]), int(t0.decision_type[0]),
                        t0.cat_words_for_node(0).tolist(),
                        auc_score(yv[:CAT_PARITY_ROWS],
                                  b.predict(Xv[:CAT_PARITY_ROWS])))
    check(runs["cuda"][:3] == runs["cpu"][:3], "categorical parity: the "
          "root split differs: cuda %s vs cpu %s" % (runs["cuda"][:3],
                                                     runs["cpu"][:3]))
    d_auc = abs(runs["cuda"][3] - runs["cpu"][3])
    check(d_auc <= 0.002, "categorical parity: |dAUC| %.6f > 0.002" % d_auc)
    say("categorical parity: %dx%d, 63 leaves, %d iters: the root split "
        "(feature, decision_type, category bitset) %s on both, AUC on "
        "%d held-out rows cuda %.6f cpu %.6f |dAUC| %.6f"
        % (CAT_PARITY_ROWS, X.shape[1], CAT_PARITY_ITERS, runs["cuda"][:3],
           CAT_PARITY_ROWS, runs["cuda"][3], runs["cpu"][3], d_auc))
    return launches


# ---------------------------------------------------------------------------
# phases: every single-model objective, leaf renewal and bagging
# ---------------------------------------------------------------------------

#: YearPredictionMSD (UCI; the "year" set of NVIDIA's gbm-bench): 463,715
#: training and 51,630 held-out songs, 90 timbre features (12 averages,
#: 78 covariances), the release year 1922-2011 as the label
YEAR_ROWS, YEAR_VALID, YEAR_F = 463_715, 51_630, 90
#: the held-out RMSE must stay below this share of the label's std
YEAR_RMSE_SHARE = 0.9
YEAR_RENEW_ITERS = 5
#: the renewal check's tree (the second: past the first tree's init score)
RENEW_CHECKED_TREE = 1
#: every objective but binary (the main path's), held card against CPU:
#: the multiclass ones at K = 3, lambdarank on queries of PARITY_QUERY rows
PARITY_OBJECTIVES = ("regression", "regression_l1", "huber", "fair",
                     "poisson", "quantile", "mape", "gamma", "tweedie",
                     "xentropy", "xentlambda", "multiclass", "multiclassova",
                     "lambdarank")
PARITY_K, PARITY_QUERY = 3, 20
OBJ_PARITY_ROWS = 20_000
#: two iterations (three before PR 16) keep the script inside the chip
#: tool's time limit
OBJ_PARITY_ITERS = 2
#: card vs CPU leaf values, as a share of the tree's largest |leaf value|:
#: the card sums in fixed point, the CPU in row-order f32, and each runs
#: the split search's f32 scans and sums in its own order, which leaves
#: L2's leaves up to 8e-5 and fair's up to 1.5e-4 of that apart at 20,000
#: rows (H100 80GB HBM3, 700 W); on fair there the JAX package's CPU
#: leaves stand 1.1e-4 (absolute) from the port's CPU ones
LEAF_RTOL = 3e-4
RENEWING = ("regression_l1", "quantile", "mape")


def year_synth(n_rows: int, seed: int):
    """Rows shaped after YearPredictionMSD: 12 timbre averages (scale ~10)
    and 78 covariances (scale ~100, heavier tails), and a year label skewed
    to recent years (mean ~1998, std ~11, 1922-2011) from a sparse linear
    and pairwise signal of the averages plus noise."""
    rng = np.random.default_rng(seed)
    avg = rng.standard_normal((n_rows, 12)) * 10.0
    cov = rng.standard_t(5, (n_rows, 78)) * 100.0
    z = avg[:, :6] @ rng.standard_normal(6) / 10.0 \
        + 0.05 * avg[:, 6] * avg[:, 7] / 10.0 + cov[:, :3].sum(1) / 300.0
    z = (z - z.mean()) / z.std() + 0.5 * rng.standard_normal(n_rows)
    year = np.clip(np.round(1998.0 + 10.0 * z - 3.0 * np.abs(z) ** 1.5),
                   1922, 2011)
    return np.column_stack([avg, cov]).astype(np.float32), year


def b1_on_payload(pay, n: int, f: int, cols=None) -> dict:
    """B1 on `pay` (its first n rows, F features, the (grad, hess, count)
    columns `cols`, by default the K = 1 layout's) held against its
    fixed-point plain version on the root, an unaligned, an empty and a
    middle segment, and timed on the root beside its plain version, its
    bound and index_add_."""
    g, h, c_col = hist_cols(f, cols)
    hk = dict(num_features=f, num_bins=B, grad_col=g, hess_col=h,
              cnt_col=c_col)
    err = 0.0
    for s, c in ((0, n), (100, 37), (500, 0), (min(12345, n // 4), n // 3)):
        got = cuda_segment.segment_histogram(pay, s, c, **hk)
        torch.cuda.synchronize()
        err = max(err, hist_exact(pay, s, c, f, got, cols=cols))
    kw = scale_kw(cuda_segment.segment_histogram, pay, [0], [n], f, cols)
    ms = time_ms(lambda: cuda_segment.segment_histogram(pay, 0, n, **hk,
                                                        **kw), 20)
    plain_ms = time_ms(lambda: seg.segment_histogram_fixed(
        pay, 0, n, **hk, scale=kw.get("scale")), 3)
    flat = (pay[:n, :f].long() + torch.arange(f, device=pay.device)
            * B).reshape(-1)
    vals = pay[:n, [g, h, c_col]].repeat_interleave(f, dim=0)
    out = torch.zeros(f * B, 3, device=pay.device)
    library_ms = time_ms(lambda: out.index_add_(0, flat, vals), 5)
    # each row's F bins, grad, hess and count read once; [F, B, 3] written
    b_ms, b_by = bound(n * (f + 3) * 4 + f * B * 3 * 4, n * f * 3)
    return dict(rows=n, features=f, width=int(pay.shape[1]),
                cols=[g, h, c_col], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                bound_by=b_by)


def year_b1_phase(seed: int, dev) -> dict:
    """B1 at the year path's width (F = 90, P = 100: five feature groups)
    on YEAR_ROWS rows of a random payload (b1_on_payload)."""
    pay = make_payload(YEAR_ROWS, YEAR_F, YEAR_F + 10, seed + 90, dev)
    return b1_on_payload(pay, YEAR_ROWS, YEAR_F)


def path_b1_check(label: str, bst) -> dict:
    """B1 on a trained path's own payload (b1_on_payload): its rows in the
    last tree's order, its width and its (grad, hess, count) columns,
    which hold the last class tree's gradients.  Returns the record and
    prints its line."""
    fs = bst._engine._fast
    rec = b1_on_payload(fs.payload, fs.n_pad, fs.G,
                        (fs.grad_col, fs.hess_col, fs.cnt_col))
    say("kernels at the %s path's payload: B1 checked against its plain "
        "version at n=%d, F=%d, P=%d, B=256 (grad, hess, count at columns "
        "%s) and timed on the root: %s"
        % (label, fs.n_pad, fs.G, fs.P, rec["cols"], json.dumps(rec)))
    return rec


def rmse_below(share: float, ys):
    """quality for train_path: the held-out RMSE, below `share` of the
    label's standard deviation."""
    limit = share * float(np.std(ys))

    def quality(yv, pred):
        rmse = float(np.sqrt(np.mean((pred - yv) ** 2)))
        return rmse, rmse < limit
    return quality


def year_phase(seed: int, iters: int, main_run: dict, smi: str):
    """objective=regression on the year-shaped data, 255 leaves, max_bin
    255, the held-out rows scored every iteration: the valid scores must
    equal predict(raw_score=True), the held-out RMSE stay below
    YEAR_RMSE_SHARE of the label's std, and the repeat check pass.
    Returns the data for the renewal phase and the path's launches."""
    X, y = year_synth(YEAR_ROWS + YEAR_VALID, seed + 41)
    Xt, yt, Xv, yv = X[:YEAR_ROWS], y[:YEAR_ROWS], X[YEAR_ROWS:], \
        y[YEAR_ROWS:]
    params = train_params(255, objective="regression", metric="l2")
    t0 = time.perf_counter()
    ds = lt.Dataset(Xt, label=yt)
    ds.construct(lt.Config(params))
    dv = lt.Dataset(Xv, label=yv, reference=ds)
    dv.construct(lt.Config(params))
    t_bin = time.perf_counter() - t0
    r = train_path("year", ds, Xv, yv, params, iters, valid_sets=[dv],
                   quality=rmse_below(YEAR_RMSE_SHARE, yv))
    bst, launches = r["bst"], r["launches"]
    check(launches["segment_histogram"] >= iters
          and launches["partition_segment"] > 0,
          "year: B1 / B2 launched %d / %d times"
          % (launches["segment_histogram"], launches["partition_segment"]))
    valid, raw = bst._engine.raw_valid_score(0)[0], r["raw"]
    check(np.allclose(valid, raw, rtol=0,
                      atol=1e-5 * max(1.0, float(np.abs(raw).max()))),
          "year: valid scores vs predict max |diff| %.3g"
          % float(np.abs(valid - raw).max()))
    kernels = step_kernels(bst)
    sha = hashlib.sha256(r["model_text"].encode()).hexdigest()
    say("year: %dx%d (P=%d), regression, max_bin 255, 255 leaves, lr 0.1, "
        "%d iters: %.4f s/iter (main path %.4f; train %.3f s, binning "
        "%.3f s), syncs/tree %s, splits/tree %.2f, device kernels per split "
        "step %d (main path %d), held-out RMSE %.4f (label std %.4f, limit "
        "%.2f of it) on %d rows, valid scores equal predict(raw_score=True) "
        "(max |diff| %.3g), max_memory_allocated %d B, sha256 %s, graph "
        "replays %s, launches %s (%s)"
        % (YEAR_ROWS, YEAR_F, YEAR_F + 10, iters, r["s_per_iter"],
           main_run["s_per_iter"], r["t_train"], t_bin, r["syncs"],
           r["splits_per_tree"], kernels, main_run["step_kernels"], r["auc"],
           float(np.std(yv)), YEAR_RMSE_SHARE, YEAR_VALID,
           float(np.abs(valid - raw).max()), r["peak"], sha,
           json.dumps(r["replays"]), json.dumps(launches), smi))
    text = r["model_text"]
    del r, bst
    say(repeat_cut("year", lambda n: lt.train(
        params, ds, n, valid_sets=[dv], verbose_eval=False), text))
    return (ds, Xt, Xv, yv), launches


def renewal_phase(data, iters: int = YEAR_RENEW_ITERS) -> dict:
    """objective=regression_l1 on the year data: leaf renewal on the host
    after every tree, two blocking syncs per tree.  One tree's leaf values
    must be renew_leaf_values of its fetched partition and pre-tree scores
    (recomputed on the host) bit for bit; the fetched partition must route
    each row as the host model does and the pre-tree scores be the host's
    prediction of the earlier trees; then the repeat check.  Returns the
    path's launches."""
    ds, Xt, Xv, yv = data
    params = train_params(255, objective="regression_l1")
    seen = {}
    real_inputs = tgbdt._FastState.renew_inputs
    real_renew = tgbdt.GBDT._renew_leaf_values

    def inputs(fs, host, k=0):
        got = real_inputs(fs, host, k)
        seen.setdefault("inputs", []).append(got)
        return got

    def renew(engine, fs, host, k=0):
        seen.setdefault("fetched", []).append(
            host["leaf_value"][:int(host["num_leaves"])].copy())
        t0 = time.perf_counter()
        real_renew(engine, fs, host, k)
        seen.setdefault("host_s", []).append(time.perf_counter() - t0)

    tgbdt._FastState.renew_inputs = inputs
    tgbdt.GBDT._renew_leaf_values = renew
    try:
        r = train_path("renewal", ds, Xv, yv, params, iters,
                       syncs_per_tree=2,
                       quality=rmse_below(YEAR_RMSE_SHARE, yv))
    finally:
        tgbdt._FastState.renew_inputs = real_inputs
        tgbdt.GBDT._renew_leaf_values = real_renew
    bst = r["bst"]
    check(len(seen["inputs"]) == iters, "renewal: %d of %d trees renewed"
          % (len(seen["inputs"]), iters))
    k = RENEW_CHECKED_TREE
    lid, pred, in_bag = seen["inputs"][k]
    lv = seen["fetched"][k].astype(np.float64)
    tree = bst._model.trees[k]
    nl = tree.num_leaves
    renewed = bst._objective.renew_leaf_values(lv, lid, pred, in_bag)
    want = renewed.astype(np.float32).astype(np.float64) * 0.1
    check(np.array_equal(tree.leaf_value[:nl], want),
          "renewal: tree %d's leaf values are not its host renewal's, max "
          "|diff| %.3g" % (k, float(np.abs(tree.leaf_value[:nl] - want)
                                    .max())))
    check(not np.array_equal(renewed, lv), "renewal renewed nothing")
    n = len(Xt)
    host_leaf = bst._model.predict_leaf_index(Xt)[:, k]
    check(np.array_equal(lid[:n], host_leaf),
          "renewal: the fetched partition routes %d rows unlike the host"
          % int(np.sum(lid[:n] != host_leaf)))
    before = bst.predict(Xt, raw_score=True, num_iteration=k)
    d_pred = float(np.abs(pred[:n] - before).max())
    check(d_pred <= 1e-5 * max(1.0, float(np.abs(before).max())),
          "renewal: pre-tree scores vs host predict max |diff| %.3g"
          % d_pred)
    check(bool(in_bag[:n].all()) and not in_bag[n:].any(),
          "renewal: the bag of an unbagged run is not every real row")
    line = ("renewal: %dx%d, regression_l1, 255 leaves, %d iters: %.4f "
            "s/iter, syncs/tree %s (tree_fetch + renew_fetch), host renewal "
            "%s s per tree, tree %d's %d leaf values equal "
            "renew_leaf_values of its fetched partition and pre-tree scores "
            "bit for bit, the partition routes every row as the host model "
            "does, pre-tree scores vs host predict max |diff| %.3g, held-out "
            "RMSE %.4f, launches %s"
            % (YEAR_ROWS, YEAR_F, iters, r["s_per_iter"], r["syncs"],
               json.dumps([round(t, 4) for t in seen["host_s"]]), k, nl,
               d_pred, r["auc"], json.dumps(r["launches"])))
    text, launches = r["model_text"], r["launches"]
    del r, bst
    say(line)
    say(repeat_cut("renewal", lambda n: lt.train(
        params, ds, n, verbose_eval=False), text))
    return launches


def bag_check(ds, params: dict, iters: int = 3) -> str:
    """After each of `iters` updates (each a resample at bagging_freq=1),
    the payload's count column, read in original row order, must be the
    host RNG's bag."""
    with grower_mode():
        bst = lt.Booster(params, ds)
        sums = []
        for _ in range(iters):
            bst.update()
            eng = bst._engine
            fs = eng._fast
            got = convert.bag_mask_from_payload(fs.payload, fs.cnt_col,
                                                fs.idx_col, fs.n_pad)
            check(np.array_equal(got, eng.bag_mask_host),
                  "bagging: the count column is not the host's bag at "
                  "iteration %d" % eng.iter)
            sums.append(int(got.sum()))
    return "count column = host bag after %d resamples (%s rows)" % (
        iters, sums)


def bagging_phase(data, main_run: dict, iters: int) -> dict:
    """The main path's data with bagging_fraction=0.5, bagging_freq=1: the
    repeat check, the count column against the host RNG's bag, held-out
    AUC of at least 0.8, frontier 8's model text equal to the one-leaf
    loop's, and again with int8 quantized gradients (its repeat check).
    Returns the runs' launch counts by path."""
    ds, Xv, yv = data
    params = train_params(255, bagging_fraction=0.5, bagging_freq=1)
    r = train_path("bagging", ds, Xv, yv, params, iters)
    launches = r["launches"]
    check(launches["segment_histogram"] >= iters
          and launches["partition_segment"] > 0,
          "bagging: B1 / B2 launched %d / %d times"
          % (launches["segment_histogram"], launches["partition_segment"]))
    n_bag = int(ds.binned.num_data * 0.5)
    roots = [int(t.internal_count[0]) for t in r["bst"]._model.trees]
    check(roots == [n_bag] * iters, "bagging: root counts %s, not the bag "
          "of %d rows" % (roots, n_bag))
    say(path_line(r, ds.binned.num_data, iters,
                  ", main path %.4f s/iter, %d-row bags at every root"
                  % (main_run["s_per_iter"], n_bag)))
    text = r["model_text"]
    runs = {"bagging": launches}
    del r
    say(repeat_cut("bagging", lambda n: lt.train(
        params, ds, n, verbose_eval=False), text))
    say("bagging: " + bag_check(ds, params))
    reset_counts()
    with grower_mode():
        front = lt.train(dict(params, tpu_frontier_batch=8), ds, iters,
                         verbose_eval=False)
    runs["bagging frontier 8"] = read_counts()
    check(front.model_to_string() == text, "bagging: frontier 8's model "
          "text differs at %s" % first_difference(front.model_to_string(),
                                                  text))
    check(runs["bagging frontier 8"]["segment_histogram_batched"] > 0,
          "bagging frontier 8 never launched B5")
    say("bagging frontier 8: model text byte-identical to the one-leaf "
        "loop's, %.2f split rounds per tree, launches %s"
        % (front.split_rounds_per_tree(),
           json.dumps(runs["bagging frontier 8"])))
    del front
    qparams = dict(params, gradient_quantization=True,
                   gradient_quant_dtype="int8")
    rq = train_path("bagging int8", ds, Xv, yv, qparams, iters)
    check(rq["launches"]["segment_histogram_quant"] > 0
          and rq["launches"]["segment_histogram"] == 0,
          "bagging int8: launches %s" % json.dumps(rq["launches"]))
    runs["bagging int8"] = rq["launches"]
    say(path_line(rq, ds.binned.num_data, iters))
    text = rq["model_text"]
    del rq
    say(repeat_cut("bagging int8", lambda n: lt.train(
        qparams, ds, n, verbose_eval=False), text))
    return runs


# ---------------------------------------------------------------------------
# phases: continued training, custom objective, rollback, cv, refit
# ---------------------------------------------------------------------------

#: iterations of the first and of the continued run
CONTINUE_ITERS = 5
CV_FOLDS, CV_ITERS = 3, 3
ROLLBACK_PARAMS = dict(bagging_fraction=0.5, bagging_freq=2)
LR_SCHEDULE = (0.1, 0.05, 0.2)


def logloss_fobj(preds, dataset):
    """A custom objective on the host: binary logloss gradients of the raw
    scores (numpy)."""
    y = dataset.get_label()
    p = 1.0 / (1.0 + np.exp(-preds))
    return (p - y).astype(np.float32), (p * (1.0 - p)).astype(np.float32)


def logloss(y, raw) -> float:
    p = np.clip(1.0 / (1.0 + np.exp(-np.asarray(raw, np.float64))),
                1e-15, 1 - 1e-15)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def tree_texts(text: str) -> list:
    return text.split("end of trees")[0].split("Tree=")[1:]


def continued_phase(data, main_run: dict, iters: int, smi: str) -> dict:
    """init_model: 5 iterations saved to a file, then 5 more from the file
    and from the Booster, with the held-out rows scored every iteration.
    The loaded trees' text must stay as it was, the replay cost no
    blocking sync and each new tree one, the valid scores equal
    predict(raw_score=True), the AUC be within 0.002 of the 10-iteration
    main path's, the two spellings write one model text, and the repeat
    check hold.  Returns the continued run's launch counts."""
    ds, Xv, yv = data
    params = train_params(255)
    n = CONTINUE_ITERS
    first = train_path("continued (first %d)" % n, ds, Xv, yv, params, n)
    path = os.path.join(HERE, "build", "continued_first.txt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    first["bst"].save_model(path)
    with open(path) as fh:
        saved = fh.read()
    # the replay: a Booster made with the loaded trees (replayed onto the
    # training scores) against one made without them
    model = GBDTModel.load_model(path)
    made_ms = {}
    for init in (None, model, None, model):
        before = syncs.snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = lt.Booster(params, ds, init_model=init)
        torch.cuda.synchronize()
        made_ms.setdefault(init is not None, []).append(
            (time.perf_counter() - t0) * 1e3)
        replay_syncs = syncs.delta(before)["total"]
        check(replay_syncs == 0, "continued: making the Booster took %d "
              "blocking syncs" % replay_syncs)
        del bst
    with_ms, plain_ms = min(made_ms[True]), min(made_ms[False])
    dv = lt.Dataset(Xv, label=yv, reference=ds)
    graphs_before = graph_counts()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with grower_mode():
        cont = lt.train(dict(params, metric="auc"), ds, n, init_model=path,
                        valid_sets=[dv], verbose_eval=False)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = read_counts()
    check_trees_stopped("continued", cont)
    check(launches["segment_histogram"] >= n
          and launches["partition_segment"] > 0,
          "continued: B1 / B2 launched %d / %d times"
          % (launches["segment_histogram"], launches["partition_segment"]))
    check(cont.current_iteration() == 2 * n, "continued: %d iterations"
          % cont.current_iteration())
    text = cont.model_to_string()
    check(tree_texts(text)[:n] == tree_texts(saved),
          "continued: the loaded trees' text changed")
    check(cont.host_syncs_per_tree() == [1] * n,
          "continued: blocking syncs per new tree %s"
          % cont.host_syncs_per_tree())
    raw_v = cont._engine.raw_valid_score(0)[0]
    raw = cont.predict(Xv, raw_score=True)
    err = float(np.max(np.abs(raw_v - raw) / np.maximum(1.0, np.abs(raw))))
    check(err <= 1e-5, "continued: valid scores vs predict, %.3g" % err)
    auc = auc_score(yv, raw)
    d_auc = abs(auc - main_run["auc"])
    check(d_auc <= 0.002, "continued: AUC %.6f vs the main path's %.6f"
          % (auc, main_run["auc"]))
    replays = {k: v["replays"] - graphs_before.get(k, {}).get("replays", 0)
               for k, v in graph_counts().items()}
    del cont
    with grower_mode():
        again = lt.train(params, ds, n, init_model=first["bst"],
                         verbose_eval=False)
    check(again.model_to_string().split("end of trees")[0]
          == text.split("end of trees")[0],
          "continued: init_model as a Booster differs from the file's at %s"
          % first_difference(again.model_to_string(), text))
    del again, first
    say("continued: %dx%d, %d iterations from %s then %d more with the "
        "held-out rows scored, a Booster made with the %d loaded trees "
        "replayed %.2f ms against %.2f ms without them (the faster of two "
        "each; %d blocking syncs), %.4f s/iter (main path %.4f), syncs/tree "
        "%s, "
        "loaded trees' text unchanged, valid scores = predict within %.3g, "
        "held-out AUC %.6f (main path %.6f, |dAUC| %.6f), init_model as a "
        "Booster writes the same trees, graph replays %s, launches %s (%s)"
        % (ds.binned.num_data, F, n, os.path.relpath(path, HERE), n, n,
           with_ms, plain_ms, replay_syncs, t_train / n,
           main_run["s_per_iter"],
           [1] * n, err, auc, main_run["auc"], d_auc, json.dumps(replays),
           json.dumps(launches), smi))
    say(repeat_check("continued", lambda: lt.train(
        params, ds, n, init_model=path, verbose_eval=False)))
    return launches


def custom_objective_phase(data, main_run: dict, iters: int,
                           smi: str) -> dict:
    """A host numpy logloss fobj against the builtin binary objective with
    boost_from_average=false, `iters` iterations each: the first tree's
    root split equal, held-out AUC within 0.002, and two blocking syncs
    per tree (the named score fetch and the tree's).  Returns the fobj
    run's launch counts."""
    ds, Xv, yv = data
    params = train_params(255, boost_from_average=False)
    builtin = train_path("binary, boost_from_average=false", ds, Xv, yv,
                         params, iters)
    before = syncs.snapshot()
    r = train_path("custom objective", ds, Xv, yv, params, iters,
                   syncs_per_tree=2, fobj=logloss_fobj)
    labels = syncs.delta(before)["by_label"]
    check(labels.get("fobj_fetch") == iters
          and labels.get("tree_fetch") == iters,
          "custom objective: blocking syncs by label %s" % labels)
    check(r["first_split"] == builtin["first_split"],
          "custom objective: root split %s, builtin %s"
          % (r["first_split"], builtin["first_split"]))
    d_auc = abs(r["auc"] - builtin["auc"])
    check(d_auc <= 0.002, "custom objective: AUC %.6f vs builtin %.6f"
          % (r["auc"], builtin["auc"]))
    check(r["launches"]["segment_histogram"] >= iters
          and r["launches"]["partition_segment"] > 0,
          "custom objective: launches %s" % json.dumps(r["launches"]))
    say(path_line(r, ds.binned.num_data, iters,
                  ", builtin binary %.4f s/iter, AUC %.6f, |dAUC| %.6f, root "
                  "split %s on both, main path %.4f s/iter, syncs by label "
                  "%s (%s)" % (builtin["s_per_iter"], builtin["auc"], d_auc,
                               r["first_split"], main_run["s_per_iter"],
                               json.dumps(labels), smi)))
    return r["launches"]


def rollback_phase(data, smi: str) -> dict:
    """Under bagging_fraction=0.5, bagging_freq=2: 3 updates, the scores
    read, a 4th update (no resample), a rollback: the scores must be back
    within 1e-6 * max(1, |s|); the next update rebuilds the payload in its
    storage (the graph captures it cost are printed) and its count column
    must be the host's bag.  Then a learning_rates schedule: each tree's
    shrinkage follows it.  Returns the rollback run's launch counts."""
    ds = data[0]
    params = train_params(255, **ROLLBACK_PARAMS)
    reset_counts()
    with grower_mode():
        bst = lt.Booster(params, ds)
        for _ in range(3):
            bst.update()
        want = bst._engine.raw_train_score()
        bst.update()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst.rollback_one_iter()
        torch.cuda.synchronize()
        rollback_ms = (time.perf_counter() - t0) * 1e3
        got = bst._engine.raw_train_score()
        err = float(np.max(np.abs(got - want) / np.maximum(1.0,
                                                           np.abs(want))))
        check(err <= 1e-6, "rollback: scores back within %.3g" % err)
        captures0 = {k: v["captures"] for k, v in graph_counts().items()}
        bst.update()
        captures = {k: v["captures"] - captures0.get(k, 0)
                    for k, v in graph_counts().items()
                    if v["captures"] - captures0.get(k, 0)}
        eng = bst._engine
        fs = eng._fast
        bag = convert.bag_mask_from_payload(fs.payload, fs.cnt_col,
                                            fs.idx_col, fs.n_pad)
        check(eng.iter == 4 and np.array_equal(bag, eng.bag_mask_host),
              "rollback: the count column is not the host's bag after the "
              "rebuild")
        # five trees grown, one of them rolled back
        check_trees_stopped("rollback", bst, grown=5)
    launches = read_counts()
    roots = [int(t.internal_count[0]) for t in bst._model.trees]
    n_bag = int(ds.binned.num_data * ROLLBACK_PARAMS["bagging_fraction"])
    check(roots == [n_bag] * 4, "rollback: root counts %s" % roots)
    del bst
    with grower_mode():
        sched = lt.train(train_params(255, boost_from_average=False), ds,
                         len(LR_SCHEDULE), learning_rates=list(LR_SCHEDULE),
                         verbose_eval=False)
    shrink = [t.shrinkage for t in sched._model.trees]
    check(shrink == list(LR_SCHEDULE), "learning_rates: shrinkage %s"
          % shrink)
    del sched
    say("rollback: %s, 3 updates, a 4th, rolled back in %.2f ms: scores "
        "back within %.3g of max(1, |s|); the next update rebuilt the "
        "payload in place with %s graph captures and its count column is "
        "the host's %d-row bag; learning_rates %s: tree shrinkage %s; "
        "launches %s (%s)" % (json.dumps(ROLLBACK_PARAMS), rollback_ms, err,
                              json.dumps(captures), int(bag.sum()),
                              list(LR_SCHEDULE), shrink,
                              json.dumps(launches), smi))
    return launches


def cv_phase(data, smi: str) -> dict:
    """lightgbm_tpu_torch.cv: three stratified folds over the main path's
    rows, 5 iterations each: the result's keys, each fold's last valid
    logloss against its booster's prediction of its test rows (the exact
    host model) within 1e-5, and every fold's B1 and B2 launches (counted
    around each fold booster's update).  Returns the launch counts of all
    folds."""
    ds = data[0]
    per_fold = {}
    real_update = lt.Booster.update

    def counted(self, *args, **kwargs):
        before = read_counts()
        try:
            return real_update(self, *args, **kwargs)
        finally:
            acc = per_fold.setdefault(id(self), dict.fromkeys(COUNTED, 0))
            for k, v in read_counts().items():
                acc[k] += v - before[k]

    reset_counts()
    lt.Booster.update = counted
    t0 = time.perf_counter()
    try:
        with grower_mode():
            res = lt.cv(train_params(255), ds, CV_ITERS, nfold=CV_FOLDS,
                        metrics="binary_logloss", return_cvbooster=True)
    finally:
        lt.Booster.update = real_update
    torch.cuda.synchronize()
    t_cv = time.perf_counter() - t0
    launches = read_counts()
    check(set(res) == {"binary_logloss-mean", "binary_logloss-stdv",
                       "cvbooster"}, "cv: keys %s" % sorted(res))
    check(len(res["binary_logloss-mean"]) == CV_ITERS, "cv: %d iterations"
          % len(res["binary_logloss-mean"]))
    errs, folds = [], []
    for bst in res["cvbooster"].boosters:
        check_trees_stopped("cv fold", bst)
        valid = dict(bst._valid_data)["valid"]
        last = bst.eval_valid()[0][2]
        want = logloss(valid.get_label(), bst.predict(valid.data,
                                                      raw_score=True))
        errs.append(abs(last - want) / max(1.0, abs(want)))
        c = per_fold[id(bst)]
        folds.append((valid.num_data(), c["segment_histogram"],
                      c["partition_segment"]))
        check(c["segment_histogram"] >= CV_ITERS
              and c["partition_segment"] > 0,
              "cv: a fold launched B1 / B2 %d / %d times"
              % (c["segment_histogram"], c["partition_segment"]))
    check(max(errs) <= 1e-5, "cv: last valid logloss vs predict %s" % errs)
    say("cv: %d stratified folds of %d rows x %d, %d iterations, %.3f s "
        "(folds binned against the main path's mappers), logloss mean %s, "
        "stdv %s, last valid logloss vs the fold's predict within %.3g; "
        "(test rows, B1, B2) per fold %s; launches %s (%s)"
        % (CV_FOLDS, ds.binned.num_data, F, CV_ITERS, t_cv,
           ["%.6f" % v for v in res["binary_logloss-mean"]],
           ["%.6f" % v for v in res["binary_logloss-stdv"]], max(errs),
           folds, json.dumps(launches), smi))
    return launches


def refit_phase(data, main_run: dict, smi: str) -> dict:
    """Booster.refit of the main path's model on the 100k held-out rows:
    decay_rate=1 keeps every leaf (rtol 1e-9), the default decay lowers
    the logloss on those rows.  Returns its launch counts (no tree grows:
    all 0)."""
    _, Xv, yv = data
    bst = lt.Booster(train_params(255), model_str=main_run["model_text"])
    reset_counts()
    before = syncs.snapshot()
    t0 = time.perf_counter()
    refit = bst.refit(Xv, yv)
    t_refit = time.perf_counter() - t0
    fetches = syncs.delta(before)["by_label"]
    kept = bst.refit(Xv, yv, decay_rate=1.0)
    launches = read_counts()
    for t0_, t1_ in zip(bst._model.trees, kept._model.trees):
        check(np.allclose(t1_.leaf_value, t0_.leaf_value, rtol=1e-9,
                          atol=0.0), "refit: decay_rate=1 moved a leaf")
    ll0 = logloss(yv, bst.predict(Xv, raw_score=True))
    ll1 = logloss(yv, refit.predict(Xv, raw_score=True))
    check(ll1 < ll0, "refit: logloss %.6f, not below %.6f" % (ll1, ll0))
    say("refit: the main path's %d trees on the %d held-out rows in %.3f s "
        "(blocking fetches %s), decay_rate=1 keeps every leaf, default "
        "decay logloss %.6f -> %.6f; launches %s (%s)"
        % (bst.num_trees(), len(yv), t_refit, json.dumps(fetches), ll0, ll1,
           json.dumps(launches), smi))
    return launches


def api_phases(data, main_run: dict, iters: int, smi: str) -> dict:
    """Continued training, a custom objective, rollback with the
    learning-rate schedule, cv and refit on the main path's binned data.
    Returns each path's launch counts."""
    return {"continued": continued_phase(data, main_run, iters, smi),
            "custom objective": custom_objective_phase(data, main_run,
                                                       iters, smi),
            "rollback": rollback_phase(data, smi),
            "cv": cv_phase(data, smi),
            "refit": refit_phase(data, main_run, smi)}


def objective_labels(objective: str, X, rng):
    """Labels of the objective's domain from a signal of X: positive for
    poisson, gamma and tweedie, in [0, 1] for the cross-entropies, else
    real around 3."""
    f = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] - 0.3 * np.abs(X[:, 3])
    noise = 0.3 * rng.standard_normal(len(X))
    if objective in ("poisson", "gamma", "tweedie"):
        return np.exp(0.5 * f + noise)
    if objective in ("xentropy", "xentlambda"):
        return 1.0 / (1.0 + np.exp(-(f + noise)))
    if objective in ("multiclass", "multiclassova"):
        return np.digitize(f + noise, np.quantile(
            f, np.arange(1, PARITY_K) / PARITY_K)).astype(np.float64)
    if objective == "lambdarank":
        return np.clip(np.round(f + noise + 1.0), 0, 4)
    return 3.0 + f + noise


def same_structure(a, b, X) -> str:
    """'' if two boosters' trees have the same split features, topology,
    counts and leaf of every row of X, else where they first differ."""
    for i, (ta, tb) in enumerate(zip(a._model.trees, b._model.trees)):
        if ta.num_leaves != tb.num_leaves:
            return "tree %d: %d vs %d leaves" % (i, ta.num_leaves,
                                                 tb.num_leaves)
        ni = ta.num_leaves - 1
        for k in ("split_feature", "left_child", "right_child",
                  "internal_count"):
            if not np.array_equal(getattr(ta, k)[:ni], getattr(tb, k)[:ni]):
                return "tree %d: %s" % (i, k)
        if not np.array_equal(ta.leaf_count[:ni + 1],
                              tb.leaf_count[:ni + 1]):
            return "tree %d: leaf_count" % i
    la, lb = a._model.predict_leaf_index(X), b._model.predict_leaf_index(X)
    return "" if np.array_equal(la, lb) else \
        "%d rows in other leaves" % int(np.sum(np.any(la != lb, axis=1)))


def objectives_parity_phase(seed: int) -> str:
    """Every objective but binary on a 20,000-row cut (31 leaves,
    OBJ_PARITY_ITERS iterations, weighted rows; K = 3 for the multiclass ones, queries of
    PARITY_QUERY rows for lambdarank), the card against the CPU: the
    same structure (split features, topology, counts, every row's leaf)
    and each tree's leaf values within LEAF_RTOL of its largest |leaf
    value|.  The renewal objectives skip splits that gain less than 0.01
    (a leaf on one side of its quantile gains 0 exactly)."""
    X, _ = synth(OBJ_PARITY_ROWS, F, seed + 31)
    rng = np.random.default_rng(seed + 32)
    w = rng.uniform(0.5, 1.5, OBJ_PARITY_ROWS)
    out = {}
    for obj in PARITY_OBJECTIVES:
        y = objective_labels(obj, X, rng)
        params = train_params(31, objective=obj)
        if obj in RENEWING:
            params["min_gain_to_split"] = 0.01
        if obj in ("multiclass", "multiclassova"):
            params["num_class"] = PARITY_K
        group = [PARITY_QUERY] * (OBJ_PARITY_ROWS // PARITY_QUERY) \
            if obj == "lambdarank" else None
        with grower_mode():
            bc = lt.train(params, lt.Dataset(X, label=y, weight=w,
                                             group=group), OBJ_PARITY_ITERS,
                          verbose_eval=False)
        bh = lt.train(dict(params, device_type="cpu"),
                      lt.Dataset(X, label=y, weight=w, group=group),
                      OBJ_PARITY_ITERS, verbose_eval=False)
        check(bc.device.type == "cuda" and bh.device.type == "cpu",
              "%s parity ran on %s and %s" % (obj, bc.device, bh.device))
        where = same_structure(bc, bh, X)
        check(not where, "%s: card vs CPU structure differs: %s"
              % (obj, where))
        worst = 0.0
        for tc, th in zip(bc._model.trees, bh._model.trees):
            nl = tc.num_leaves
            scale = float(np.abs(th.leaf_value[:nl]).max())
            d = float(np.abs(tc.leaf_value[:nl] - th.leaf_value[:nl]).max())
            check(d <= LEAF_RTOL * scale, "%s: card vs CPU leaf values "
                  "%.3g apart, beyond %g of the tree's largest |leaf| %.4g"
                  % (obj, d, LEAF_RTOL, scale))
            worst = max(worst, d / scale)
        syncs = bc.host_syncs_per_tree()
        check(syncs == [2 if obj in RENEWING else 1] * len(bc._model.trees),
              "%s: syncs per tree %s" % (obj, syncs))
        out[obj] = dict(leaves=[t.num_leaves for t in bc._model.trees],
                        max_leaf_diff_share=worst)
    return ("objectives parity: %dx%d, 31 leaves, %d iters, weighted rows, "
            "card vs CPU: structure equal, leaf values within %g of each "
            "tree's largest |leaf| (the largest such share) for every "
            "objective: %s" % (OBJ_PARITY_ROWS, F, OBJ_PARITY_ITERS,
                               LEAF_RTOL, json.dumps(out)))


# ---------------------------------------------------------------------------
# phases: K trees per iteration and ranking
# ---------------------------------------------------------------------------

#: UCI Covertype as NVIDIA gbm-bench's "covtype" uses it: 581,012 rows of
#: 10 numeric columns, 4 wilderness and 40 soil one-hot columns, 7 cover
#: types; 100,000 of the rows held out
COVTYPE_ROWS, COVTYPE_VALID, COVTYPE_K = 581_012, 100_000, 7
#: the cover types' shares of the real data (211,840 / 283,301 / 35,754 /
#: 2,747 / 9,493 / 17,367 / 20,510 rows)
COVTYPE_SHARES = (0.36461, 0.48760, 0.06154, 0.00473, 0.01634, 0.02989,
                  0.03530)
#: the numeric columns' ranges in the real data, and per cover type the
#: means of elevation, slope and the three horizontal distances
COVTYPE_RANGES = ((1859, 3858), (0, 360), (0, 66), (0, 1397), (-173, 601),
                  (0, 7117), (0, 254), (0, 254), (0, 254), (0, 7173))
COVTYPE_MEANS = {"elevation": (3129, 2913, 2394, 2223, 2787, 2419, 3362),
                 "slope": (13.1, 13.6, 20.8, 18.5, 16.6, 19.0, 14.3),
                 "hydrology": (270, 279, 210, 100, 212, 160, 356),
                 "roadways": (2614, 2429, 943, 914, 1349, 1037, 2738),
                 "fire": (2009, 2168, 910, 859, 1577, 1055, 2070)}
#: the short runs beside the multiclass path (multiclassova, frontier 8,
#: int8), in iterations
SHORT_ITERS = 3


def covtype_synth(n_rows: int, seed: int):
    """Rows shaped after Covertype: the cover type drawn in its real
    shares, then each column from it: elevation (the strongest signal),
    slope and the horizontal distances around the type's real means,
    aspect, the vertical distance and the hillshades with little signal,
    each in its real range; one wilderness area of 4 and one soil type of
    40 from per-type tables (one-hot).  Returns X [n, 54] f32 and y in
    0..6."""
    rng = np.random.default_rng(seed)
    y = rng.choice(COVTYPE_K, size=n_rows, p=np.asarray(COVTYPE_SHARES)
                   / sum(COVTYPE_SHARES))
    mean = {k: np.asarray(v, np.float64)[y] for k, v in
            COVTYPE_MEANS.items()}
    num = np.empty((n_rows, 10))
    num[:, 0] = mean["elevation"] + rng.normal(0, 160, n_rows)
    num[:, 1] = rng.uniform(0, 360, n_rows)
    num[:, 2] = rng.gamma(4.0, mean["slope"] / 4.0)
    num[:, 3] = rng.exponential(mean["hydrology"])
    num[:, 4] = 0.2 * num[:, 3] + rng.normal(0, 50, n_rows)
    num[:, 5] = rng.exponential(mean["roadways"])
    shade = num[:, 1] / 360.0
    num[:, 6] = 212 + 25 * np.cos(2 * np.pi * shade) \
        + rng.normal(0, 15, n_rows)
    num[:, 7] = 223 - 0.5 * num[:, 2] + rng.normal(0, 15, n_rows)
    num[:, 8] = 142 - 30 * np.cos(2 * np.pi * shade) \
        + rng.normal(0, 25, n_rows)
    num[:, 9] = rng.exponential(mean["fire"])
    for j, (lo, hi) in enumerate(COVTYPE_RANGES):
        num[:, j] = np.clip(np.round(num[:, j]), lo, hi)

    def one_hot(n_levels: int, alpha: float) -> np.ndarray:
        table = np.cumsum(rng.dirichlet(np.full(n_levels, alpha),
                                        COVTYPE_K), axis=1)
        level = (rng.random(n_rows)[:, None] > table[y]).sum(1)
        out = np.zeros((n_rows, n_levels), np.float32)
        out[np.arange(n_rows), np.minimum(level, n_levels - 1)] = 1.0
        return out

    X = np.column_stack([num.astype(np.float32), one_hot(4, 0.7),
                         one_hot(40, 0.15)])
    return X, y.astype(np.float64)


def multi_metrics(objective, raw_kn, yv) -> dict:
    """multi_logloss and multi_error of [K, N] raw scores, by the port's
    metrics."""
    out = {}
    for m in create_metrics(["multi_logloss", "multi_error"], lt.Config({})):
        m.init(yv, None)
        out[m.name] = m.eval(raw_kn, objective)
    return out


def fill_cost(bst, k: int = 0) -> tuple:
    """One class k gradient fill of a trained booster's payload (the
    rows as its last tree left them): device ms per fill over 5 fills
    (CUDA events, after one warm fill run under sync debug mode "error",
    so a sync in the fill raises) and its device kernels per fill
    (torch.profiler, over 5 fills).  The booster is not trained
    further."""
    from torch.profiler import ProfilerActivity, profile
    eng = bst._engine
    fs = eng._fast
    with sync_errors():
        fs.fill_gradients(eng.objective, k)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(5):
        fs.fill_gradients(eng.objective, k)
    e1.record()
    torch.cuda.synchronize()
    # five fills under the profiler: the count of one short window alone
    # read 36 and 4 kernels in two calls (H100 80GB HBM3, 700 W)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        for _ in range(5):
            fs.fill_gradients(eng.objective, k)
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return e0.elapsed_time(e1) / 5, n / 5


def multiclass_phase(seed: int, iters: int, main_run: dict, smi: str):
    """objective=multiclass, num_class=7 on the covtype-shaped data (255
    leaves, max_bin 255, lr 0.1, enable_bundle=false, so its sha256 stays
    comparable across PRs; efb_covtype_phase trains the same data
    bundled), the held-out rows scored every
    iteration: 7 trees an iteration, one blocking sync per tree, B1 and
    B2 launched and no other kernel; held-out multi_error below the
    majority class's error; the valid scores [7, N] equal
    predict(raw_score=True); predict(device=True) [N, 7] against the
    host's within rtol 1e-5 / atol 1e-6; kernels per split step, the
    no-op step's cost and the fill's; B1 held against its plain version on
    the path's own payload (P = 77, the K > 1 columns); one more iteration
    profiled; then SHORT_ITERS iterations of multiclassova, of the one-leaf
    loop, of frontier 8 (the one-leaf model text byte for byte; B5 and the
    stage + commit) and of int8 (B4, no B1); one iteration with every B2
    call held against the plain partition; the repeat check of
    SHORT_ITERS iterations against the path's model cut there.  Returns the runs' launches by path and the B1
    record."""
    X, y = covtype_synth(COVTYPE_ROWS, seed + 51)
    n = COVTYPE_ROWS - COVTYPE_VALID
    Xt, yt, Xv, yv = X[:n], y[:n], X[n:], y[n:]
    params = train_params(255, objective="multiclass", num_class=COVTYPE_K,
                          enable_bundle=False,
                          metric=["multi_logloss", "multi_error"])
    t0 = time.perf_counter()
    ds = lt.Dataset(Xt, label=yt)
    ds.construct(lt.Config(params))
    dv = lt.Dataset(Xv, label=yv, reference=ds)
    dv.construct(lt.Config(params))
    t_bin = time.perf_counter() - t0
    check(ds.binned.bundle_info is None, "multiclass: EFB bundles formed")
    majority = 1.0 - float(np.max(np.bincount(yv.astype(int),
                                              minlength=COVTYPE_K))) / len(yv)

    def quality(yv_, prob):
        err = float(np.mean(np.argmax(prob, 1) != yv_))
        return err, err < majority

    evals = {}
    r = train_path("multiclass", ds, Xv, yv, params, iters, valid_sets=[dv],
                   quality=quality, evals_result=evals)
    bst, launches = r["bst"], r["launches"]
    trees = len(bst._model.trees)
    check(trees == COVTYPE_K * iters, "multiclass: %d trees for %d "
          "iterations" % (trees, iters))
    check(launches["segment_histogram"] >= trees
          and launches["partition_segment"] > 0,
          "multiclass: B1 / B2 launched %d / %d times"
          % (launches["segment_histogram"], launches["partition_segment"]))
    idle = [k for k in COUNTED if k not in ("segment_histogram",
                                            "partition_segment")]
    check(not any(launches[k] for k in idle), "multiclass launched %s"
          % {k: launches[k] for k in idle if launches[k]})
    raw = r["raw"]                                  # [N, 7], host f64
    valid = bst._engine.raw_valid_score(0)          # [7, N], the card's
    d_valid = float(np.abs(valid.T - raw).max())
    check(d_valid <= 1e-5 * max(1.0, float(np.abs(raw).max())),
          "multiclass: valid scores vs predict max |diff| %.3g" % d_valid)
    metrics = multi_metrics(bst._objective, raw.T, yv)
    check(metrics["multi_error"] < majority, "multiclass: multi_error %.4f "
          "not below the majority class's %.4f"
          % (metrics["multi_error"], majority))
    check(abs(evals["valid_0"]["multi_error"][-1] - metrics["multi_error"])
          < 1e-3, "multiclass: the last valid multi_error %.6f is not the "
          "prediction's %.6f" % (evals["valid_0"]["multi_error"][-1],
                                 metrics["multi_error"]))
    with sync_errors():
        t0 = time.perf_counter()
        dev = bst.predict(Xv, device=True, raw_score=True)
        t_dev = time.perf_counter() - t0
    check(dev.shape == (len(yv), COVTYPE_K) and np.allclose(
        dev, raw, rtol=1e-5, atol=1e-6), "multiclass: predict(device=True) "
          "%s vs host max |diff| %.3g" % (dev.shape,
                                          float(np.abs(dev - raw).max())))
    dev_us, host_us = inactive_step_cost(bst)
    kernels = step_kernels(bst)
    fill_ms, fill_kernels = fill_cost(bst)
    sha = hashlib.sha256(r["model_text"].encode()).hexdigest()
    say("multiclass: %dx54 (P=%d, K=%d; %d held out), max_bin 255, 255 "
        "leaves, lr 0.1, %d iters: %.4f s/iter (main path %.4f; train %.3f "
        "s, binning %.3f s), %d trees an iteration, syncs/tree %s, "
        "splits/tree %.2f, device kernels per split step %d (main path %d), "
        "no-op step %.2f us device / %.2f us host, gradient fill (class 0) "
        "%.4f ms and %.1f kernels, held-out multi_logloss %.6f multi_error "
        "%.6f (majority class's error %.6f), valid multi_error by iteration "
        "%s, valid scores equal predict(raw_score=True) (max |diff| %.3g), "
        "predict(device=True) [%d, %d] within rtol 1e-5 of the host's (max "
        "|diff| %.3g, %.4f s), peak %.1f MiB (max_memory_allocated %d B, "
        "%d B before), sha256 %s, graph replays %s, launches %s (%s)"
        % (n, 54 + 2 * COVTYPE_K + 9, COVTYPE_K, COVTYPE_VALID, iters,
           r["s_per_iter"], main_run["s_per_iter"], r["t_train"], t_bin,
           COVTYPE_K, r["syncs"][:COVTYPE_K], r["splits_per_tree"], kernels,
           main_run["step_kernels"], dev_us, host_us, fill_ms, fill_kernels,
           metrics["multi_logloss"], metrics["multi_error"], majority,
           json.dumps([round(v, 6) for v in evals["valid_0"]["multi_error"]]),
           d_valid, len(yv), COVTYPE_K, float(np.abs(dev - raw).max()), t_dev,
           r["peak"] / 2 ** 20, r["peak"], r["peak_before"], sha, json.dumps(r["replays"]),
           json.dumps(launches), smi))
    b1 = path_b1_check("multiclass", bst)
    # a whole iteration (K class trees) profiled: its device kernels
    say(profile_phase(bst, "multiclass", launched=("part_move",),
                      retired=("part_stage_move", "part_commit")))
    # the repeat check's SHORT_ITERS iterations: the path's model cut there
    text = model_cut(r["model_text"])
    del r, bst
    runs = {"multiclass": launches}
    short = dict(params, metric=["multi_error"])
    for name, extra, want, never in (
            ("multiclassova", dict(objective="multiclassova"),
             ("segment_histogram", "partition_segment"), ()),
            ("multiclass one-leaf", {},
             ("segment_histogram", "partition_segment"), ()),
            ("multiclass frontier 8", dict(tpu_frontier_batch=8),
             ("segment_histogram_batched", "partition_segment_stage",
              "partition_segment_commit"), ()),
            ("multiclass int8", dict(gradient_quantization=True,
                                     gradient_quant_dtype="int8"),
             ("segment_histogram_quant", "partition_segment"),
             ("segment_histogram",))):
        rs = train_path(name, ds, Xv, yv, dict(short, **extra), SHORT_ITERS,
                        quality=quality)
        runs[name] = rs["launches"]
        check(all(rs["launches"][k] > 0 for k in want)
              and not any(rs["launches"][k] for k in never),
              "%s: launches %s" % (name, json.dumps(rs["launches"])))
        extra_line = ", held-out error %.6f (majority %.6f)" % (rs["auc"],
                                                               majority)
        if name == "multiclass one-leaf":
            one_text = rs["model_text"]
        if name == "multiclass frontier 8":
            check(rs["model_text"] == one_text, "multiclass frontier 8: the "
                  "model text differs from the one-leaf loop's at %s"
                  % first_difference(rs["model_text"], one_text))
            extra_line += ", model text byte-identical to the one-leaf " \
                "loop's (%d trees)" % len(rs["bst"]._model.trees)
        say("%s: %dx54, max_bin 255, 255 leaves, lr 0.1, %d iters: %.4f "
            "s/iter (train %.3f s), %d trees, syncs/tree %s, split "
            "rounds/tree %.2f, splits/tree %.2f%s, graph replays %s, "
            "launches %s" % (name, n, SHORT_ITERS, rs["s_per_iter"],
                             rs["t_train"], len(rs["leaves"]),
                             rs["syncs"][:COVTYPE_K], rs["rounds_per_tree"],
                             rs["splits_per_tree"], extra_line,
                             json.dumps(rs["replays"]),
                             json.dumps(rs["launches"])))
        del rs

    def error(bst):
        raw_ = bst.predict(Xv, raw_score=True)
        return "multi_error", multi_metrics(bst._objective, raw_.T,
                                            yv)["multi_error"]

    say(checked_partition_phase((ds, Xv, yv), n, 1, params=params,
                                label="B2 in multiclass training",
                                quality=error))
    say(repeat_check("multiclass (%d iters)" % SHORT_ITERS, lambda: lt.train(
        params, ds, SHORT_ITERS, valid_sets=[dv], verbose_eval=False), text))
    del runs["multiclass one-leaf"]
    return runs, b1


#: MSLR-WEB30K (LightGBM docs/Experiments.rst's "MS LTR", 2,270,296 x 137
#: with the label): 136 features, ~18,919 queries of mean ~120 and at most
#: ~1,250 documents, relevance 0-4; the last 2,000 queries held out
MSLR_ROWS, MSLR_F, MSLR_VALID_QUERIES, MSLR_MAX_QUERY = 2_270_296, 136, \
    2_000, 1_251
#: the relevance labels' shares in the real set (0 to 4)
MSLR_SHARES = (0.514, 0.325, 0.134, 0.019, 0.008)
NDCG_AT = (1, 3, 5, 10)


def mslr_synth(n_rows: int, seed: int):
    """Rows shaped after MSLR-WEB30K: query sizes from a lognormal law
    (median ~85, mean ~120) cut at MSLR_MAX_QUERY, the last query cut so
    the rows sum to n_rows; 136 features (every fourth a count: integer,
    few distinct values, as the real term-frequency columns are); the
    relevance from a sparse linear signal of 20 features, a per-query
    offset and noise, cut at the real labels' shares.  Returns X [n, 136]
    f32, y in 0..4 and the query sizes."""
    rng = np.random.default_rng(seed)
    sizes = np.clip(np.round(rng.lognormal(4.45, 0.85, 2 * n_rows // 100)),
                    1, MSLR_MAX_QUERY).astype(np.int64)
    cum = np.cumsum(sizes)
    nq = int(np.searchsorted(cum, n_rows)) + 1
    sizes = sizes[:nq]
    sizes[-1] -= int(cum[nq - 1]) - n_rows
    X = rng.standard_normal((n_rows, MSLR_F), dtype=np.float32)
    X[:, ::4] = np.floor(np.exp(X[:, ::4]))
    w = np.zeros(MSLR_F, np.float32)
    w[rng.choice(MSLR_F, 20, replace=False)] = rng.standard_normal(20)
    q_off = np.repeat(rng.standard_normal(nq).astype(np.float32) * 0.5,
                      sizes)
    z = X @ w / np.float32(np.sqrt(20.0)) + q_off \
        + rng.standard_normal(n_rows, dtype=np.float32) * 0.7
    cuts = np.quantile(z, np.cumsum(MSLR_SHARES)[:-1])
    y = np.searchsorted(cuts, z).astype(np.float64)
    return X, y, sizes


def rank_phase(seed: int, iters: int, main_run: dict, smi: str):
    """objective=lambdarank, metric ndcg at 1, 3, 5, 10 on the MSLR-shaped
    data (255 leaves, max_bin 255, lr 0.1), the held-out queries scored
    every iteration: one blocking sync per tree, B1 and B2 launched and
    no other kernel; NDCG@10 after the last iteration above the first's
    and a random ranking's; the valid scores equal
    predict(raw_score=True); the gradient fill's ms and kernels (no sync
    inside it), kernels per split step; B1 held against its plain version
    on the path's own payload (F = 136, P = 146); one more iteration
    profiled; one iteration with every B2 call held against the plain
    partition; the repeat check.  Returns the path's launches and the B1
    record."""
    X, y, sizes = mslr_synth(MSLR_ROWS, seed + 61)
    nq = len(sizes)
    n = int(sizes[:nq - MSLR_VALID_QUERIES].sum())
    Xt, yt, gt = X[:n], y[:n], sizes[:nq - MSLR_VALID_QUERIES]
    Xv, yv, gv = X[n:], y[n:], sizes[nq - MSLR_VALID_QUERIES:]
    params = train_params(255, objective="lambdarank", metric="ndcg",
                          eval_at=list(NDCG_AT))
    t0 = time.perf_counter()
    ds = lt.Dataset(Xt, label=yt, group=gt)
    ds.construct(lt.Config(params))
    dv = lt.Dataset(Xv, label=yv, group=gv, reference=ds)
    dv.construct(lt.Config(params))
    t_bin = time.perf_counter() - t0
    del X
    ndcg10 = create_metrics(["ndcg@10"], lt.Config(params))[0]
    ndcg10.init(yv, None, dv.binned.metadata.query_boundaries)
    rand = ndcg10.eval(np.random.default_rng(seed).random(len(yv)), None)

    def quality(yv_, pred):
        v = ndcg10.eval(pred, None)
        return v, v > rand

    evals = {}
    r = train_path("rank", ds, Xv, yv, params, iters, valid_sets=[dv],
                   quality=quality, evals_result=evals)
    bst, launches = r["bst"], r["launches"]
    check(launches["segment_histogram"] >= iters
          and launches["partition_segment"] > 0,
          "rank: B1 / B2 launched %d / %d times"
          % (launches["segment_histogram"], launches["partition_segment"]))
    idle = [k for k in COUNTED if k not in ("segment_histogram",
                                            "partition_segment")]
    check(not any(launches[k] for k in idle), "rank launched %s"
          % {k: launches[k] for k in idle if launches[k]})
    curve = evals["valid_0"]["ndcg@10"]
    check(curve[-1] > curve[0] and curve[-1] > rand, "rank: NDCG@10 %.6f "
          "after %d iterations, %.6f after 1, %.6f at random"
          % (curve[-1], iters, curve[0], rand))
    check(abs(curve[-1] - r["auc"]) < 1e-6, "rank: the last valid NDCG@10 "
          "%.6f is not the prediction's %.6f" % (curve[-1], r["auc"]))
    valid, raw = bst._engine.raw_valid_score(0)[0], r["raw"]
    d_valid = float(np.abs(valid - raw).max())
    check(d_valid <= 1e-5 * max(1.0, float(np.abs(raw).max())),
          "rank: valid scores vs predict max |diff| %.3g" % d_valid)
    kernels = step_kernels(bst)
    fill_ms, fill_kernels = fill_cost(bst)
    obj = bst._objective
    blocks = [[b["S"], int(b["doc_idx"].shape[0]), -(-b["doc_idx"].shape[0]
                                                    // b["chunk"])]
              for b in obj.blocks]
    pairs = sum(b[0] * b[0] * b[1] for b in blocks)
    sha = hashlib.sha256(r["model_text"].encode()).hexdigest()
    say("rank: %dx%d (P=%d) in %d queries (mean %.1f, max %d documents; %d "
        "queries, %d rows held out), lambdarank, max_bin 255, 255 leaves, lr "
        "0.1, %d iters: %.4f s/iter (main path %.4f; train %.3f s, binning "
        "%.3f s), syncs/tree %s, splits/tree %.2f, device kernels per split "
        "step %d (main path %d), gradient fill %.4f ms per iteration and %.1f "
        "kernels (size classes [S, queries, chunks] %s, %d padded pairs "
        "against %d real and %d at the longest query's width), held-out "
        "NDCG@10 by iteration %s (random ranking %.6f), valid scores equal "
        "predict(raw_score=True) (max |diff| %.3g), peak %.1f MiB "
        "(max_memory_allocated %d B, %d B before), sha256 %s, graph replays "
        "%s, launches %s (%s)"
        % (n, MSLR_F, MSLR_F + 10, len(gt), float(np.mean(gt)),
           int(np.max(gt)), len(gv), len(yv), iters, r["s_per_iter"],
           main_run["s_per_iter"], r["t_train"], t_bin, r["syncs"],
           r["splits_per_tree"], kernels, main_run["step_kernels"], fill_ms,
           fill_kernels, json.dumps(blocks), pairs,
           int(np.sum(gt.astype(np.float64) ** 2)),
           len(gt) * int(np.max(gt)) ** 2,
           json.dumps([round(v, 6) for v in curve]), rand, d_valid,
           r["peak"] / 2 ** 20, r["peak"], r["peak_before"], sha, json.dumps(r["replays"]),
           json.dumps(launches), smi))
    b1 = path_b1_check("rank", bst)
    say(profile_phase(bst, "rank", launched=("part_move",),
                      retired=("part_stage_move", "part_commit")))
    text = r["model_text"]
    del r, bst
    say(checked_partition_phase(
        (ds, Xv, yv), n, 1, params=params, label="B2 in rank training",
        quality=lambda b: ("NDCG@10", ndcg10.eval(b.predict(Xv), None))))
    say(repeat_cut("rank", lambda n: lt.train(
        params, ds, n, valid_sets=[dv], verbose_eval=False), text))
    return launches, b1, dict(ds=ds, dv=dv, Xv=Xv, yv=yv, ndcg10=ndcg10,
                              rand=rand, Xt=Xt, yt=yt, gt=gt)


# ---------------------------------------------------------------------------
# phases: boosting variants, forced splits, monotone constraints
# ---------------------------------------------------------------------------

#: GOSS on the main path's data: the warm-up lasts int(1 / 0.1) = 10
#: iterations, so the last 5 sample
GOSS_ITERS = 15
GOSS_PARAMS = dict(boosting="goss", top_rate=0.2, other_rate=0.1)
#: covtype-shaped GOSS: learning_rate 0.5 makes the warm-up 2 iterations
GOSS_K7_ITERS, GOSS_K7_LR = 4, 0.5
#: tests/test_continued_training.py:126-127's forest
RF_PARAMS = dict(boosting="rf", bagging_fraction=0.632, bagging_freq=1,
                 feature_fraction=0.7)
#: the monotone phase's constraints: +1 on features 0-3, -1 on 4-5
MONOTONE = (1, 1, 1, 1, -1, -1)
MONO_SWEEP_POINTS, MONO_SWEEP_ROWS = 64, 1000
#: the training rows whose fetched scores are held to the host's predict
SCORE_ROWS = 100_000
#: the fallback JSON's min_data_in_leaf: its left child's forced
#: threshold (feature 1's first bin edge) leaves fewer rows than this
FORCED_FALLBACK_MIN_DATA = 20_000


def goss_masks_numpy(g, h, valid, key, top_k: int, other_k: int,
                     multiply: float, rows=None, n_draw: int = 0):
    """The plain version of GOSS's selection (variants.goss_masks) in
    numpy on the host: the classes' |g h| summed in class order, the
    top_k-th largest as the threshold (ties in), the other_k-th smallest
    of the threefry uniforms over the rest (ties in; with `rows`, each
    row's original row's uniform of a draw over n_draw rows), the
    amplification f32(multiply).  Returns (gradient weight, count mask, rows tied at
    the threshold, rows tied at the other_k-th uniform)."""
    prod = np.abs(g * h)
    gh = prod[0].copy()
    for k in range(1, len(prod)):
        gh = gh + prod[k]
    gh = np.where(valid, gh, np.float32(-np.inf)).astype(np.float32)
    thresh = np.sort(gh)[::-1][top_k - 1]
    is_top = valid & (gh >= thresh)
    rest = valid & ~is_top
    u = threefry.uniform_numpy(key, len(gh)) if rows is None else \
        np.append(threefry.uniform_numpy(key, n_draw), np.float32(0))[rows]
    r = np.where(rest, u, np.float32(np.inf)).astype(np.float32)
    kth = np.sort(r)[other_k - 1]
    sampled = rest & (r <= kth)
    gw = np.where(is_top, np.float32(1.0),
                  np.where(sampled, np.float32(multiply),
                           np.float32(0.0))).astype(np.float32)
    return (gw, (is_top | sampled).astype(np.float32),
            int(np.sum(valid & (gh == thresh))),
            int(np.sum(rest & (r == kth))))


@contextlib.contextmanager
def goss_recorder(iteration: int, into: dict):
    """Inside the block, GOSS's fill of class 0 at `iteration` records on
    the card what its selection read (every class's g and h times the
    pristine valid column, the valid column, the key, the counts and,
    where the draw runs in original order, each row's original row) and
    what it wrote (the gweight and count columns, before the tree moves
    the rows); every other fill runs as it is."""
    real = variants.GOSS._fill

    def fill(self, fs, k, custom=None):
        if self.iter != iteration or k != 0 or "gw" in into:
            return real(self, fs, k, custom)
        g, h = fs.all_gradients(self.objective, custom=custom)
        valid = fs.payload[:, fs.bvalid_col].clone()
        rows = fs.row_index() if self.draws_in_original_order(custom) \
            else None
        rec = dict(key=self.sample_key(), top_k=self._goss_top_k,
                   other_k=self._goss_other_k,
                   multiply=self._goss_multiply, g=g * valid, h=h * valid,
                   valid=valid, rows=rows, n_draw=fs.n_pad)
        out = real(self, fs, k, custom)
        rec.update(gw=fs.payload[:, fs.gweight_col].clone(),
                   cm=fs.payload[:, fs.cnt_col].clone())
        into.update(rec)
        return out

    variants.GOSS._fill = fill
    try:
        yield
    finally:
        variants.GOSS._fill = real


def goss_mask_check(label: str, rec: dict) -> str:
    """The card's selection of one sampled iteration (goss_recorder)
    against goss_masks_numpy of the fetched gradients and the host's
    threefry, bit for bit; the selected count top_k + other_k give or
    take the ties; the selection's device ms on the recorded inputs."""
    check("gw" in rec, "%s: no sampled iteration was recorded" % label)
    g, h, valid, gw, cm = (rec[k].cpu().numpy()
                           for k in ("g", "h", "valid", "gw", "cm"))
    top_k, other_k = rec["top_k"], rec["other_k"]
    rows = rec["rows"]
    order = {} if rows is None else dict(rows=rows, n_draw=rec["n_draw"])
    ref_gw, ref_cm, tie_top, tie_other = goss_masks_numpy(
        g, h, valid > 0, rec["key"], top_k, other_k, rec["multiply"],
        **{k: v.cpu().numpy() if k == "rows" else v
           for k, v in order.items()})
    check(np.array_equal(gw.view(np.int32), ref_gw.view(np.int32))
          and np.array_equal(cm.view(np.int32), ref_cm.view(np.int32)),
          "%s: the card's gweight / count columns differ from the host's "
          "selection in %d / %d rows" % (label, int(np.sum(gw != ref_gw)),
                                         int(np.sum(cm != ref_cm))))
    kept = int(cm.sum())
    excess = kept - (top_k + other_k)
    check(0 <= excess <= max(tie_top - 1, 0) + max(tie_other - 1, 0),
          "%s: %d rows selected, top_k + other_k = %d, ties %d + %d"
          % (label, kept, top_k + other_k, tie_top, tie_other))
    valid_t = rec["valid"] > 0
    ms = time_ms(lambda: variants.goss_masks(
        rec["g"], rec["h"], valid_t, rec["key"], top_k, other_k,
        rec["multiply"], **order), 20)
    return ("selection bit for bit against the host's (K %d, %d rows, key "
            "%s%s): %d selected = top_k %d + other_k %d + %d tied, %d rows "
            "amplified by %.6f; the selection %.4f device ms"
            % (g.shape[0], g.shape[1], list(rec["key"]),
               "" if rows is None else ", drawn over %d rows in original "
               "order" % rec["n_draw"], kept, top_k,
               other_k, excess, int(np.sum(gw > 1.0)), rec["multiply"], ms))


class EventTimer:
    """Device ms spent between the start and the end of calls to a
    method, by CUDA events recorded around each call (no host wait); read
    after a synchronize.  `after(obj)` runs after each call, on the
    object the method was called on."""

    def __init__(self, cls, name: str, after=None):
        self.cls, self.name, self.pairs = cls, name, []
        self.real, self.after = getattr(cls, name), after

    def __enter__(self):
        real, pairs, after = self.real, self.pairs, self.after

        def timed(obj, *args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(obj, *args, **kwargs)
            end.record()
            pairs.append((start, end))
            if after is not None:
                after(obj)
            return out

        setattr(self.cls, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.real)

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def launches_of(r: dict) -> str:
    return "B1 %d, B2 %d launches" % (r["launches"]["segment_histogram"],
                                      r["launches"]["partition_segment"])


def b1_b2_ran(label: str, launches: dict, trees: int) -> None:
    check(launches["segment_histogram"] >= trees
          and launches["partition_segment"] > 0,
          "%s: B1 / B2 launched %d / %d times" % (
              label, launches["segment_histogram"],
              launches["partition_segment"]))
    idle = [k for k in COUNTED if k not in ("segment_histogram",
                                            "partition_segment")]
    check(not any(launches[k] for k in idle), "%s launched %s"
          % (label, {k: launches[k] for k in idle if launches[k]}))


def scores_match(label: str, bst, X, raw_train, average: bool) -> float:
    """The fetched training scores of the first SCORE_ROWS rows against
    the host's predict of them (averaged for a forest, raw otherwise)
    within 1e-5 of max(1, |raw|); returns the largest such error."""
    n = min(SCORE_ROWS, len(X))
    ref = bst.predict(X[:n]) if average else bst.predict(X[:n],
                                                         raw_score=True)
    err = float(np.max(np.abs(raw_train[:n] - ref)
                       / np.maximum(1.0, np.abs(ref))))
    check(err <= 1e-5, "%s: training scores vs predict, %.3g" % (label, err))
    return err


def valid_match(label: str, bst, raw_valid, ref) -> float:
    err = float(np.max(np.abs(raw_valid - ref)
                       / np.maximum(1.0, np.abs(ref))))
    check(err <= 1e-5, "%s: validation scores vs predict, %.3g"
          % (label, err))
    return err


def replay_cost(bst) -> tuple:
    """Device microseconds and kernels of one replay of the model's last
    tree over the payload's own bin columns (`payload_tree_add`, the
    edit of DART's drops and RF's fold), kernels only (torch.profiler
    over 10 replays that add 0 to the scores; a score of -0.0 turns
    +0.0, so call it after the scores are read)."""
    from torch.profiler import ProfilerActivity, profile
    eng = bst._engine
    tree = next(t for t in reversed(eng.model.trees) if t.num_leaves > 1)
    tree_dev, leaf_out = eng._tree_to_device(tree, 0.0)
    depth = tgbdt._depth_iters(tree)

    def replay():
        eng._fast.payload_tree_add(tree_dev, leaf_out, 0, eng.meta,
                                   eng._bmap, depth)

    replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            replay()
        torch.cuda.synchronize()
    cuda = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in cuda) / 10,
            sum(e.count for e in cuda) / 10, depth)


def goss_phase(data, main_run: dict, seed: int, smi: str) -> dict:
    """boosting=goss on the main path's data (top_rate 0.2, other_rate
    0.1, 15 iterations: the last 5 sample): the first sampled
    iteration's selection on the card against the host's, B1 and B2 and
    no other kernel, one blocking sync a tree, AUC above 0.8, the repeat
    check; then covtype-shaped multiclass GOSS (K 7, lr 0.5: a 2-iteration
    warm-up, 4 iterations), whose once-an-iteration selection is checked
    the same way.  Returns the runs' launch counts."""
    ds, Xv, yv = data
    params = train_params(255, **GOSS_PARAMS)
    rec = {}
    with goss_recorder(int(1.0 / params["learning_rate"]), rec):
        r = train_path("goss", ds, Xv, yv, params, GOSS_ITERS)
    b1_b2_ran("goss", r["launches"], GOSS_ITERS)
    masks = goss_mask_check("goss", rec)
    del rec
    say(path_line(r, ds.binned.num_data, GOSS_ITERS,
                  ", main path %.4f s/iter, %s; %s (%s)"
                  % (main_run["s_per_iter"], launches_of(r), masks, smi)))
    runs = {"goss": r["launches"]}
    text = r["model_text"]
    del r
    say(repeat_check("goss", lambda: lt.train(
        params, ds, GOSS_ITERS, verbose_eval=False), text))

    X, y = covtype_synth(COVTYPE_ROWS, seed + 51)
    n = COVTYPE_ROWS - COVTYPE_VALID
    mparams = train_params(255, objective="multiclass", num_class=COVTYPE_K,
                           enable_bundle=False, learning_rate=GOSS_K7_LR,
                           **GOSS_PARAMS)
    dsm = lt.Dataset(X[:n], label=y[:n])
    dsm.construct(lt.Config(mparams))
    yvm = y[n:]
    majority = 1.0 - float(np.max(np.bincount(
        yvm.astype(int), minlength=COVTYPE_K))) / len(yvm)

    def quality(yv_, prob):
        err = float(np.mean(np.argmax(prob, 1) != yv_))
        return err, err < majority

    rec = {}
    with goss_recorder(int(1.0 / GOSS_K7_LR), rec):
        r = train_path("goss multiclass", dsm, X[n:], yvm, mparams,
                       GOSS_K7_ITERS, quality=quality)
    b1_b2_ran("goss multiclass", r["launches"], COVTYPE_K * GOSS_K7_ITERS)
    masks = goss_mask_check("goss multiclass", rec)
    say("goss multiclass: %dx54, K %d, lr %.1f, %d iterations (%d of "
        "warm-up), %.4f s/iter, multi_error %.4f (majority %.4f), "
        "syncs/tree %s, %s; %s (%s)"
        % (n, COVTYPE_K, GOSS_K7_LR, GOSS_K7_ITERS, int(1.0 / GOSS_K7_LR),
           r["s_per_iter"], r["auc"], majority, sorted(set(r["syncs"])),
           launches_of(r), masks, smi))
    runs["goss multiclass"] = r["launches"]
    return runs


def dart_drop_replay(cfg: dict, iters: int) -> list:
    """DART's drop lists replayed on the host alone (dart.hpp
    DroppingTrees / Normalize with the reference's tree weights):
    Random(drop_seed)'s draws, no tree needed."""
    rng = Random(int(cfg.get("drop_seed", 4)))
    rate0, skip = cfg.get("drop_rate", 0.1), cfg.get("skip_drop", 0.5)
    max_drop, lr = cfg.get("max_drop", 50), cfg["learning_rate"]
    weights, total, lists = [], 0.0, []
    for it in range(iters):
        drop = []
        if not rng.next_float() < skip and it > 0 and total > 0:
            inv_avg = len(weights) / total
            rate = min(rate0, max_drop * inv_avg / total) if max_drop > 0 \
                else rate0
            for i in range(it):
                if rng.next_float() < rate * weights[i] * inv_avg:
                    drop.append(i)
                    if max_drop > 0 and len(drop) >= max_drop:
                        break
        lists.append(drop)
        k = float(len(drop))
        for i in drop:
            total -= weights[i] * (1.0 / (k + 1.0))
            weights[i] *= k / (k + 1.0)
        weights.append(lr / (1.0 + k))
        total += lr / (1.0 + k)
    return lists


def dart_phase(data, main_run: dict, iters: int, smi: str) -> dict:
    """boosting=dart with its defaults (drop_rate 0.1, skip_drop 0.5,
    drop_seed 4), the held-out rows scored every iteration: the drop
    lists against dart_drop_replay, the fetched training scores (first
    SCORE_ROWS rows) and the validation scores against
    predict(raw_score=True), B1 and B2, one sync a tree, the drop replay's
    device ms an iteration, the repeat check."""
    ds, Xv, yv = data
    params = train_params(255, boosting="dart")
    dv = lt.Dataset(Xv, label=yv, reference=ds)
    drops = []
    with EventTimer(variants.DART, "_dropping_trees", after=lambda eng:
                    drops.append(list(eng.drop_index))) as t_drop, \
            EventTimer(variants.DART, "_normalize") as t_norm:
        r = train_path("dart", ds, Xv, yv, params, iters, valid_sets=[dv])
    b1_b2_ran("dart", r["launches"], iters)
    replay = dart_drop_replay(params, iters)
    check(drops == replay, "dart: drop lists %s, the host's replay %s"
          % (drops, replay))
    bst = r["bst"]
    err_t = scores_match("dart", bst, ds.data,
                         bst._engine.raw_train_score()[0], False)
    err_v = valid_match("dart", bst, bst._engine.raw_valid_score(0)[0],
                        r["raw"])
    replay_ms = (t_drop.ms() + t_norm.ms()) / iters
    us, kernels, depth = replay_cost(bst)
    say(path_line(r, ds.binned.num_data, iters,
                  ", main path %.4f s/iter, %s; drop lists %s = the host's "
                  "replay of Random(4), %d trees dropped in all, the drop "
                  "and normalize calls %.3f ms an iteration of event span; "
                  "one payload replay of a depth-%d tree %.1f device us in "
                  "%d kernels; training scores (first %d rows) = predict "
                  "within %.3g, valid within %.3g (%s)"
                  % (main_run["s_per_iter"], launches_of(r), drops,
                     sum(map(len, drops)), replay_ms, depth, us, kernels,
                     SCORE_ROWS, err_t, err_v, smi)))
    text = r["model_text"]
    runs = {"dart": r["launches"]}
    del r, bst
    say(repeat_check("dart", lambda: lt.train(
        params, ds, iters, verbose_eval=False), text))
    return runs


def rf_phase(data, main_run: dict, iters: int, smi: str) -> dict:
    """boosting=rf (bagging_fraction 0.632, bagging_freq 1,
    feature_fraction 0.7), the held-out rows scored every iteration: the
    training scores (first SCORE_ROWS rows) and the validation scores
    equal the averaged predict, AUC above 0.8, B1 and B2, one sync a
    tree, the fold's device ms, the repeat check."""
    ds, Xv, yv = data
    params = train_params(255, **RF_PARAMS)
    dv = lt.Dataset(Xv, label=yv, reference=ds)
    with EventTimer(variants.RF, "_rf_fold") as t_fold:
        r = train_path("rf", ds, Xv, yv, params, iters, valid_sets=[dv])
    b1_b2_ran("rf", r["launches"], iters)
    bst = r["bst"]
    check(bst._model.average_output, "rf: the model does not average")
    err_t = scores_match("rf", bst, ds.data,
                         bst._engine.raw_train_score()[0], True)
    err_v = valid_match("rf", bst, bst._engine.raw_valid_score(0)[0],
                        r["pred"])
    fold_ms = t_fold.ms() / iters
    us, kernels, depth = replay_cost(bst)
    say(path_line(r, ds.binned.num_data, iters,
                  ", main path %.4f s/iter, %s; training scores (first %d "
                  "rows) = the averaged predict within %.3g, valid within "
                  "%.3g; the fold %.3f ms a tree of event span, its payload "
                  "replay of a depth-%d tree %.1f device us in %d kernels "
                  "(%s)" % (main_run["s_per_iter"], launches_of(r),
                            SCORE_ROWS, err_t, err_v, fold_ms, depth, us,
                            kernels, smi)))
    text = r["model_text"]
    runs = {"rf": r["launches"]}
    del r, bst
    say(repeat_cut("rf", lambda n: lt.train(
        params, ds, n, verbose_eval=False), text))
    return runs


def median_edge(ds, X, f: int) -> tuple:
    """Feature f's bin of its median value and that bin's upper edge."""
    mapper = ds.binned.bin_mappers[f]
    b = int(mapper.value_to_bin(float(np.median(X[:, f]))))
    return float(mapper.bin_upper_bound[b]), b


def forced_phase(data, main_run: dict, iters: int, smi: str) -> dict:
    """forcedsplits_filename: a 3-node JSON (the root and both children on
    features 0, 1 and 2 at their median bin edges): every tree's first
    three nodes are the forced ones at their bins, with real (not
    priority) gains; B1, B2, one sync a tree; the repeat check.  A second
    JSON whose left child's threshold (feature 1's first bin edge) leaves
    fewer than min_data_in_leaf = 20,000 rows: that child falls back on
    its own best split, the right child stays forced."""
    ds, Xv, yv = data
    X = ds.data
    edges = [median_edge(ds, X, f) for f in range(3)]
    forced = {"feature": 0, "threshold": edges[0][0],
              "left": {"feature": 1, "threshold": edges[1][0]},
              "right": {"feature": 2, "threshold": edges[2][0]}}
    path = os.path.join(HERE, "build", "forced.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(forced, fh)
    params = train_params(255, forcedsplits_filename=path)
    r = train_path("forced", ds, Xv, yv, params, iters)
    b1_b2_ran("forced", r["launches"], iters)
    bins = [b for _, b in edges]
    gains = []
    for i, t in enumerate(r["bst"]._model.trees):
        got = (list(t.split_feature[:3]), list(t.threshold_in_bin[:3]),
               int(t.left_child[0]), int(t.right_child[0]))
        check(got == ([0, 1, 2], bins, 1, 2), "forced: tree %d's first "
              "nodes %s, not %s" % (i, got, ([0, 1, 2], bins, 1, 2)))
        g = t.split_gain[:3]
        check(bool(np.all(np.isfinite(g)) and np.all(np.abs(g) < 1e20)),
              "forced: tree %d's forced gains %s are not real gains"
              % (i, list(g)))
        gains.append(float(g[0]))
    say(path_line(r, ds.binned.num_data, iters,
                  ", main path %.4f s/iter, %s; every tree's first three "
                  "nodes the forced (feature, bin) %s, root gains %.1f.."
                  "%.1f; device kernels per split step %d (main path %s) "
                  "(%s)" % (main_run["s_per_iter"], launches_of(r),
                            list(zip([0, 1, 2], bins)), min(gains),
                            max(gains), step_kernels(r["bst"]),
                            main_run.get("step_kernels"), smi)))
    runs = {"forced": r["launches"]}
    text = r["model_text"]
    del r
    fallback = dict(forced, left={"feature": 1, "threshold": float(
        ds.binned.bin_mappers[1].bin_upper_bound[0])})
    fpath = os.path.join(HERE, "build", "forced_fallback.json")
    with open(fpath, "w") as fh:
        json.dump(fallback, fh)
    reset_counts()
    with grower_mode():
        fb = lt.train(train_params(255, forcedsplits_filename=fpath,
                                   min_data_in_leaf=FORCED_FALLBACK_MIN_DATA),
                      ds, SHORT_ITERS, verbose_eval=False)
    check_trees_stopped("forced fallback", fb)
    runs["forced fallback"] = read_counts()
    left_splits = []
    for i, t in enumerate(fb._model.trees):
        # the right child's forced split comes second; the left child
        # splits (if at all) by its own best
        check(int(t.split_feature[0]) == 0 and int(t.right_child[0]) == 1
              and int(t.split_feature[1]) == 2
              and int(t.threshold_in_bin[1]) == bins[2],
              "forced fallback: tree %d's root and right child are not "
              "the forced ones" % i)
        lc = int(t.left_child[0])
        node = (int(t.split_feature[lc]), int(t.threshold_in_bin[lc])) \
            if lc > 0 else None
        check(node != (1, 0), "forced fallback: tree %d took the "
              "infeasible forced split" % i)
        left_splits.append(node)
    say("forced fallback: the left child forced at feature 1's first bin "
        "edge under min_data_in_leaf=%d, %d iterations: every tree's root "
        "and right child forced, the left child's split by its own best "
        "%s, launches %s" % (FORCED_FALLBACK_MIN_DATA, SHORT_ITERS,
                             left_splits, json.dumps(runs["forced "
                                                          "fallback"])))
    del fb
    say(repeat_cut("forced", lambda n: lt.train(
        params, ds, n, verbose_eval=False), text))
    return runs


def walk_monotone(node: dict, constraint: int, feature: int) -> tuple:
    """tests/test_monotone_missing.py's walk: every split on `feature`
    orders its children's subtree outputs per the constraint; returns the
    subtree's (min, max) output."""
    if "split_feature" not in node:
        return node["leaf_value"], node["leaf_value"]
    lmin, lmax = walk_monotone(node["left_child"], constraint, feature)
    rmin, rmax = walk_monotone(node["right_child"], constraint, feature)
    if node["split_feature"] == feature:
        check(lmax <= rmin + 1e-10 if constraint > 0
              else lmin >= rmax - 1e-10,
              "monotone: a split on feature %d breaks its constraint %+d"
              % (feature, constraint))
    return min(lmin, rmin), max(lmax, rmax)


def monotone_phase(data, main_run: dict, iters: int, smi: str) -> dict:
    """monotone_constraints +1 on features 0-3 and -1 on 4-5: the walk
    holds on every dumped tree, predictions over a 64-point sweep of each
    constrained feature for 1,000 held-out rows are monotone, B1 and B2,
    one sync a tree, tpu_frontier_batch=8 grows the same model text in
    the same rounds (the gate keeps the one-leaf loop), the repeat
    check."""
    ds, Xv, yv = data
    mono = list(MONOTONE) + [0] * (F - len(MONOTONE))
    params = train_params(255, monotone_constraints=mono)
    # the constraints belong to the binned Dataset (the reference's
    # monotone_types_): the main rows binned again against the main
    # mappers, with them
    ds = lt.Dataset(ds.data, label=ds.get_label(), reference=ds)
    ds.construct(lt.Config(params))
    check(list(ds.binned.monotone_constraints[:len(MONOTONE)])
          == list(MONOTONE), "monotone: the Dataset holds constraints %s"
          % list(ds.binned.monotone_constraints[:len(MONOTONE)]))
    r = train_path("monotone", ds, Xv, yv, params, iters, auc_floor=0.6)
    b1_b2_ran("monotone", r["launches"], iters)
    bst = r["bst"]
    splits = {}
    for t in bst.dump_model()["tree_info"]:
        root = t["tree_structure"]
        for f, c in enumerate(MONOTONE):
            if "split_feature" in root:
                walk_monotone(root, c, f)
    for t in bst._model.trees:
        for f in t.split_feature[:t.num_leaves - 1]:
            splits[int(f)] = splits.get(int(f), 0) + 1
    rows = Xv[:MONO_SWEEP_ROWS]
    worst = 0.0
    for f, c in enumerate(MONOTONE):
        grid = np.linspace(ds.data[:, f].min(), ds.data[:, f].max(),
                           MONO_SWEEP_POINTS, dtype=np.float32)
        Xs = np.repeat(rows, MONO_SWEEP_POINTS, axis=0)
        Xs[:, f] = np.tile(grid, MONO_SWEEP_ROWS)
        pred = bst.predict(Xs, raw_score=True).reshape(MONO_SWEEP_ROWS,
                                                       MONO_SWEEP_POINTS)
        step = np.diff(pred, axis=1) * c
        worst = min(worst, float(step.min()))
        check(step.min() >= -1e-10, "monotone: predictions over feature "
              "%d's sweep break its constraint by %.3g" % (f, -step.min()))
    say(path_line(r, ds.binned.num_data, iters,
                  ", main path %.4f s/iter, %s; constraints %s: the walk "
                  "holds on every tree, a %d-point sweep of each for %d "
                  "held-out rows monotone (worst step %.3g), splits by "
                  "feature %s; device kernels per split step %d (main path "
                  "%s) (%s)"
                  % (main_run["s_per_iter"], launches_of(r), list(MONOTONE),
                     MONO_SWEEP_POINTS, MONO_SWEEP_ROWS, worst,
                     json.dumps(dict(sorted(splits.items()))),
                     step_kernels(bst), main_run.get("step_kernels"), smi)))
    runs = {"monotone": r["launches"]}
    text, rounds = r["model_text"], r["rounds_per_tree"]
    del r, bst
    reset_counts()
    with grower_mode():
        front = lt.train(dict(params, tpu_frontier_batch=8), ds, iters,
                         verbose_eval=False)
    check_trees_stopped("monotone frontier 8", front)
    runs["monotone frontier 8"] = read_counts()
    check(front.model_to_string() == text, "monotone: frontier 8's model "
          "text differs at %s" % first_difference(front.model_to_string(),
                                                  text))
    check(front.split_rounds_per_tree() == rounds
          and runs["monotone frontier 8"]["segment_histogram_batched"] == 0,
          "monotone: frontier 8 batched its rounds")
    say("monotone frontier 8: the request keeps the one-leaf loop (the "
        "JAX gate): model text byte-identical, %.2f split rounds per tree, "
        "launches %s" % (front.split_rounds_per_tree(),
                         json.dumps(runs["monotone frontier 8"])))
    del front
    say(repeat_cut("monotone", lambda n: lt.train(
        params, ds, n, verbose_eval=False), text))
    return runs


def continued_variants_phase(data, main_run: dict, smi: str) -> dict:
    """DART and RF, CONTINUE_ITERS iterations saved to a file and as many
    more from it: for DART the loaded trees' text unchanged (only this
    run's trees drop) and the training scores equal predict(raw_score=
    True); for RF the running average over all the trees equals the
    averaged predict (the loaded sum scaled by 1 / num_init_iteration);
    one sync a new tree, B1 and B2."""
    ds, Xv, yv = data
    n = CONTINUE_ITERS
    runs, parts = {}, []
    for name, extra in (("dart", dict(boosting="dart", drop_rate=0.5,
                                      skip_drop=0.0)),
                        ("rf", RF_PARAMS)):
        params = train_params(255, **extra)
        with grower_mode():
            first = lt.train(params, ds, n, verbose_eval=False)
        path = os.path.join(HERE, "build", "continued_%s.txt" % name)
        first.save_model(path)
        del first
        with open(path) as fh:
            saved = fh.read()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with grower_mode():
            cont = lt.train(params, ds, n, init_model=path,
                            verbose_eval=False)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches = read_counts()
        label = "continued %s" % name
        check_trees_stopped(label, cont)
        b1_b2_ran(label, launches, n)
        check(cont.num_trees() == 2 * n, "%s: %d trees" % (label,
                                                            cont.num_trees()))
        check(cont.host_syncs_per_tree() == [1] * n, "%s: syncs per tree %s"
              % (label, cont.host_syncs_per_tree()))
        raw = cont._engine.raw_train_score()[0]
        err = scores_match(label, cont, ds.data, raw, name == "rf")
        if name == "dart":
            check(tree_texts(cont.model_to_string())[:n] == tree_texts(saved),
                  "continued dart: the loaded trees' text changed")
            parts.append("dart: loaded trees' text unchanged, training "
                         "scores = predict(raw_score=True) within %.3g, "
                         "%.4f s/iter, last drop list %s"
                         % (err, t_train / n, cont._engine.drop_index))
        else:
            parts.append("rf: the running average over %d trees = the "
                         "averaged predict within %.3g, %.4f s/iter"
                         % (2 * n, err, t_train / n))
        runs[label] = launches
        del cont
    say("continued variants: %d + %d iterations from a saved model; %s; "
        "main path %.4f s/iter; launches %s (%s)"
        % (n, n, "; ".join(parts), main_run["s_per_iter"],
           json.dumps(runs), smi))
    return runs


def variant_phases(data, main_run: dict, iters: int, seed: int,
                   smi: str) -> dict:
    """GOSS, DART, RF, forced splits, monotone constraints and the
    continued variants on the main path's binned data.  Returns each
    path's launch counts."""
    runs = {}
    runs.update(goss_phase(data, main_run, seed, smi))
    runs.update(dart_phase(data, main_run, iters, smi))
    runs.update(rf_phase(data, main_run, iters, smi))
    runs.update(forced_phase(data, main_run, iters, smi))
    runs.update(monotone_phase(data, main_run, iters, smi))
    runs.update(continued_variants_phase(data, main_run, smi))
    return runs


# ---------------------------------------------------------------------------
# phases: the data side (EFB bundles, past 2^24 rows, files and streams)
# ---------------------------------------------------------------------------

#: Expo (LightGBM docs/Experiments.rst: the airline data one-hot encoded,
#: 11M x 700; BASELINE.md), rows cut to these; the generator is
#: tests/test_wide_sparse.py's, one-hot blocks of cards 2/4/8/16/28 filled
#: to 700 columns with dense noise columns
EXPO_COLS = 700
EXPO_CARDS = (2, 4, 8, 16, 28)
EXPO_ROWS = 1_000_000
EXPO_VALID = 100_000
EXPO_ITERS = 10
#: the unbundled, equivalence, repeat and int8 runs beside it
EXPO_SHORT = 3
#: the bundled storage columns the JAX package's Expo test allows
EXPO_MAX_G = 120
EXPO_AUC_FLOOR = 0.6
#: the wide-index path: Higgs-shaped rows past 2^24 (16,777,216)
WIDE_INDEX_ROWS = 17_000_000
WIDE_INDEX_ITERS = 3
WIDE_INDEX_CHECKED = 100_000
#: the rows of the main path written as CSV and LibSVM, and the chunks
#: its rows are pushed in
TEXT_ROWS = 40_000
STREAM_CHUNKS = 8

def sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def mib(n_bytes: int) -> float:
    return n_bytes / 2**20


#: the held-out AUC two equivalent models may differ by (parity_phase's)
AGREE_AUC = 0.002
#: max |d raw| / max(1, |raw|) between the bundled and unbundled Expo
#: models: 25 times the 3.96e-07 read on an H100 80GB HBM3 (PERF.md §6)
AGREE_RAW = 1e-5


def bundle_agreement(a, b, Xv, yv) -> dict:
    """Bundled model `a` against unbundled model `b` on the held-out rows.
    A feature's default bin is the bundle's total minus its other bins in
    f32, not a summed bin, so gains that tie exactly (Expo's card-2
    one-hot pairs are complementary: a split on either column is the same
    partition mirrored) or nearly can be won by another candidate; the
    two texts then differ where the search was undecided.  So the checks
    are on what the models compute: every tree's leaves partition the
    held-out rows alike (a bijection of leaves, which mirrored splits
    keep), max |d raw| / max(1, |raw|) <= AGREE_RAW and |dAUC| <=
    AGREE_AUC; the first node where each tree's split features differ is
    reported beside them.  The texts' structural equivalence is held in
    tests/test_torch_efb.py on tie-free data."""
    la, lb = a.predict(Xv, pred_leaf=True), b.predict(Xv, pred_leaf=True)
    same_partition = 0
    for t in range(la.shape[1]):
        pairs = np.unique(np.stack([la[:, t], lb[:, t]], 1), axis=0)
        same_partition += int(len(pairs) == len(np.unique(la[:, t]))
                              == len(np.unique(lb[:, t])))
    first_diff = []
    for ta, tb in zip(a._model.trees, b._model.trees):
        ni = min(ta.num_leaves, tb.num_leaves) - 1
        d = np.nonzero(ta.split_feature[:ni] != tb.split_feature[:ni])[0]
        first_diff.append(int(d[0]) if len(d) else None)
    ra, rb = a.predict(Xv, raw_score=True), b.predict(Xv, raw_score=True)
    d_auc = abs(auc_score(yv, ra) - auc_score(yv, rb))
    rel = float(np.max(np.abs(ra - rb) / np.maximum(1.0, np.abs(ra))))
    check(same_partition == la.shape[1], "efb expo: %d of %d bundled trees "
          "partition the held-out rows as the unbundled ones do"
          % (same_partition, la.shape[1]))
    check(rel <= AGREE_RAW, "efb expo: bundled and unbundled raw scores "
          "differ by %.3e of max(1, |raw|)" % rel)
    check(d_auc <= AGREE_AUC, "efb expo: bundled and unbundled held-out AUC "
          "differ by %.6f" % d_auc)
    return dict(d_auc=d_auc, trees=la.shape[1],
                trees_same_partition=same_partition,
                first_differing_node=first_diff, max_rel_raw_diff=rel)


def expo_synth(n_rows: int, seed: int):
    """tests/test_wide_sparse.py's _onehot_problem at Expo's width: one-hot
    blocks of cards 2, 4, 8, 16, 28 in turn up to 692 columns (every
    seventh variable carrying signal), the rest dense noise.  X [n, 700]
    f32, y 0/1."""
    rng = np.random.default_rng(seed)
    X = np.zeros((n_rows, EXPO_COLS), np.float32)
    logit = np.zeros(n_rows)
    rows = np.arange(n_rows)
    c0, v = 0, 0
    while c0 < EXPO_COLS - 8:
        card = EXPO_CARDS[v % len(EXPO_CARDS)]
        which = rng.integers(0, card, size=n_rows)
        X[rows, c0 + which] = 1.0
        if v % 7 == 0:
            logit += 0.4 * (which % 3 - 1)
        c0 += card
        v += 1
    X[:, c0:] = rng.standard_normal((n_rows, EXPO_COLS - c0),
                                    dtype=np.float32)
    y = (logit + rng.standard_normal(n_rows) * 0.7 > 0).astype(np.float64)
    return X, y


def efb_expo_phase(seed: int, smi: str) -> dict:
    """Expo's width through EFB: 1,000,000 training rows x 700 columns
    binned and bundled (G storage columns, at most EXPO_MAX_G as the JAX
    package's test allows), 10 iterations, 255 leaves; the held-out AUC;
    peak memory against the same rows unbundled (EXPO_SHORT iterations:
    P = 710 routes the partition to B3) and the two models compared over
    those iterations (`bundle_agreement`); one iteration with every B2
    call (each decoding the bundles) held against the plain partition; B1
    on the path's payload; the repeat check; EXPO_SHORT iterations under
    int8 (B4).  Returns the runs' launches by path."""
    X, y = expo_synth(EXPO_ROWS + EXPO_VALID, seed + 70)
    Xt, yt = X[:EXPO_ROWS], y[:EXPO_ROWS]
    Xv, yv = X[EXPO_ROWS:], y[EXPO_ROWS:]
    params = train_params(255)
    t0 = time.perf_counter()
    ds = lt.Dataset(Xt, label=yt)
    ds.construct(lt.Config(params))
    t_bin = time.perf_counter() - t0
    b = ds.binned
    G = int(b.bins.shape[0])
    check(b.bundle_info is not None and G <= EXPO_MAX_G,
          "efb expo: %d storage columns for %d features" % (G,
                                                            b.num_features))
    r = train_path("efb expo", ds, Xv, yv, params, EXPO_ITERS,
                   auc_floor=EXPO_AUC_FLOOR)
    fs = r["bst"]._engine._fast
    check(r["launches"]["segment_histogram"] > 0
          and r["launches"]["partition_segment"] > 0,
          "efb expo: B1 / B2 never launched")
    say(path_line(r, EXPO_ROWS, EXPO_ITERS, ", binning %.3f s, G %d of F "
                  "%d, P %d (%s)" % (t_bin, G, b.num_features, fs.P, smi),
                  n_feat=EXPO_COLS))
    path_b1_check("efb expo", r["bst"])
    bundled3 = r["bst"].model_to_string(num_iteration=EXPO_SHORT)
    b3 = lt.Booster(params={"device_type": "cpu"}, model_str=bundled3)
    del r["bst"], fs
    torch.cuda.empty_cache()

    # the same rows and mappers, unbundled
    t0 = time.perf_counter()
    ub = BinnedDataset.from_matrix(Xt, lt.Config(dict(
        params, enable_bundle=False)), bin_mappers=b.bin_mappers)
    ub.metadata.set_label(yt)
    t_bin_u = time.perf_counter() - t0
    plain_params = dict(params, enable_bundle=False)
    ru = train_path("efb expo unbundled", lt.Dataset._from_binned(
        ub, params=plain_params), Xv, yv, plain_params, EXPO_SHORT,
        auc_floor=EXPO_AUC_FLOOR, wide_ok=True)
    P_u = ru["bst"]._engine._fast.P
    check(ru["launches"]["partition_segment_rmw"] > 0,
          "efb expo unbundled: P %d did not route to B3" % P_u)
    agree = bundle_agreement(b3, ru["bst"], Xv, yv)
    # each run's peak less what was allocated before it (PERF.md §2)
    net_b, net_u = (x["peak"] - x["peak_before"] for x in (r, ru))
    say(path_line(ru, EXPO_ROWS, EXPO_SHORT, ", binning %.3f s, P %d; "
                  "bundled vs unbundled over %d iterations: %s; peak MiB "
                  "bundled %.1f vs unbundled %.1f (%.3f of it)"
                  % (t_bin_u, P_u, EXPO_SHORT, json.dumps(agree),
                     mib(net_b), mib(net_u), net_b / net_u),
                  n_feat=EXPO_COLS))
    del ru["bst"], ub
    torch.cuda.empty_cache()

    data = (ds, Xv, yv)
    say(checked_partition_phase(data, EXPO_ROWS, 1, params=params,
                                label="B2 in efb expo"))
    say(repeat_check("efb expo (%d iters)" % EXPO_SHORT, lambda: lt.train(
        params, ds, EXPO_SHORT, verbose_eval=False), bundled3))
    qp = dict(params, gradient_quantization=True, gradient_quant_dtype="int8")
    rq = train_path("efb expo int8", ds, Xv, yv, qp, EXPO_SHORT,
                    auc_floor=EXPO_AUC_FLOOR)
    check(rq["launches"]["segment_histogram_quant"] > 0
          and rq["launches"]["segment_histogram"] == 0,
          "efb expo int8: launches %s" % rq["launches"])
    say(path_line(rq, EXPO_ROWS, EXPO_SHORT, ", G %d (%s)" % (G, smi),
                  n_feat=EXPO_COLS))
    del rq["bst"]
    torch.cuda.empty_cache()
    return {"efb expo": r["launches"], "efb expo unbundled": ru["launches"],
            "efb expo int8": rq["launches"]}


def efb_covtype_phase(seed: int, smi: str) -> dict:
    """The multiclass path's covtype-shaped data with enable_bundle at its
    default (the one-hot wilderness and soil columns bundle): SHORT_ITERS
    iterations, then one under tpu_frontier_batch=8 (B5 and the stage +
    commit over the bundled columns), whose model text must equal the
    one-leaf model's first iteration.  Returns the launches by path."""
    X, y = covtype_synth(COVTYPE_ROWS, seed + 51)
    n = COVTYPE_ROWS - COVTYPE_VALID
    Xt, yt, Xv, yv = X[:n], y[:n], X[n:], y[n:]
    params = train_params(255, objective="multiclass", num_class=COVTYPE_K,
                          metric=["multi_logloss", "multi_error"])
    t0 = time.perf_counter()
    ds = lt.Dataset(Xt, label=yt)
    ds.construct(lt.Config(params))
    t_bin = time.perf_counter() - t0
    G = int(ds.binned.bins.shape[0])
    check(ds.binned.bundle_info is not None and G < X.shape[1],
          "efb covtype: no bundle formed (G %d)" % G)
    majority = 1.0 - float(np.max(np.bincount(yv.astype(int),
                                              minlength=COVTYPE_K))) / len(yv)

    def quality(yv_, prob):
        err = float(np.mean(np.argmax(prob, 1) != yv_))
        return err, err < majority

    r = train_path("efb covtype", ds, Xv, yv, params, SHORT_ITERS,
                   quality=quality)
    one_leaf = r["bst"].model_to_string(num_iteration=1)
    say(path_line(r, n, SHORT_ITERS, ", binning %.3f s, G %d of F %d, "
                  "held-out multi_error %.6f (majority class's %.6f) (%s)"
                  % (t_bin, G, X.shape[1], r["auc"], majority, smi),
                  n_feat=X.shape[1]))
    del r["bst"]
    rf = train_path("efb covtype frontier 8", ds, Xv, yv,
                    dict(params, tpu_frontier_batch=8), 1,
                    quality=lambda yv_, prob: (float(np.mean(
                        np.argmax(prob, 1) != yv_)), True))
    lf = rf["launches"]
    check(lf["segment_histogram_batched"] > 0
          and lf["partition_segment_stage"] > 0
          and lf["partition_segment_commit"] > 0,
          "efb covtype frontier 8: launches %s" % lf)
    check(rf["model_text"] == one_leaf, "efb covtype frontier 8: the model "
          "text differs from the one-leaf model's at %s"
          % first_difference(rf["model_text"], one_leaf))
    say(path_line(rf, n, 1, ", split rounds/tree %.2f; model text equal to "
                  "the one-leaf model's first iteration" %
                  rf["rounds_per_tree"], n_feat=X.shape[1]))
    del rf["bst"]
    return {"efb covtype": r["launches"], "efb covtype frontier 8": lf}


def wide_index_forced_phase(data, main_run: dict, iters: int) -> dict:
    """The main path again with the port's _IDX_WIDE_THRESHOLD set to 1
    in-process (a module constant, as the JAX package's test sets its
    own): the index column splits into radix-4096 halves (P grows by one)
    and the model text must be the main path's, sha256 and all."""
    ds, Xv, yv = data
    saved = tgbdt._IDX_WIDE_THRESHOLD
    tgbdt._IDX_WIDE_THRESHOLD = 1
    try:
        r = train_path("wide index (forced)", ds, Xv, yv, train_params(255),
                       iters)
    finally:
        tgbdt._IDX_WIDE_THRESHOLD = saved
    fs = r["bst"]._engine._fast
    check(fs.wide_idx and fs.P == P + 1, "wide index (forced): the wide "
          "layout did not engage (P %d)" % fs.P)
    check(r["model_text"] == main_run["model_text"], "wide index (forced): "
          "the model text differs from the main path's at %s"
          % first_difference(r["model_text"], main_run["model_text"]))
    say(path_line(r, ds.binned.num_data, iters, ", P %d, model sha256 %s "
                  "equal to the main path's" % (fs.P, sha(r["model_text"]))))
    del r["bst"]
    return r["launches"]


def wide_index_phase(seed: int, smi: str) -> dict:
    """Higgs-shaped rows past 2^24 (bench.py's generator): 17,000,000
    training rows x 28 binned, 3 iterations at 255 leaves (the index
    column splits into radix-4096 halves on its own), 100,000 held out;
    the training scores fetched in original order against
    predict(raw_score=True) on 100,000 sampled training rows within
    1e-5 * max(1, |raw|); one blocking sync a tree (train_path)."""
    t0 = time.perf_counter()
    X, y = synth(WIDE_INDEX_ROWS + 100_000, F, seed + 80)
    t_gen = time.perf_counter() - t0
    Xt, yt = X[:WIDE_INDEX_ROWS], y[:WIDE_INDEX_ROWS]
    Xv, yv = X[WIDE_INDEX_ROWS:], y[WIDE_INDEX_ROWS:]
    params = train_params(255)
    t0 = time.perf_counter()
    ds = lt.Dataset(Xt, label=yt)
    ds.construct(lt.Config(params))
    t_bin = time.perf_counter() - t0
    r = train_path("wide index", ds, Xv, yv, params, WIDE_INDEX_ITERS)
    bst = r["bst"]
    fs = bst._engine._fast
    check(fs.wide_idx and fs.P == P + 1, "wide index: %d rows kept the "
          "narrow layout (P %d)" % (WIDE_INDEX_ROWS, fs.P))
    t0 = time.perf_counter()
    raw = bst._engine.raw_train_score()[0]
    t_fetch = time.perf_counter() - t0
    pick = np.random.default_rng(seed).choice(WIDE_INDEX_ROWS,
                                              WIDE_INDEX_CHECKED,
                                              replace=False)
    ref = bst.predict(Xt[pick], raw_score=True)
    err = float(np.max(np.abs(raw[pick] - ref)
                       / np.maximum(1.0, np.abs(ref))))
    check(err <= 1e-5, "wide index: training scores against predict: "
          "max relative error %.3g" % err)
    say(path_line(r, WIDE_INDEX_ROWS, WIDE_INDEX_ITERS,
                  ", generation %.1f s, binning %.3f s, P %d, training scores "
                  "in original order (fetched in %.3f s) against "
                  "predict(raw_score=True) on %d sampled rows: max "
                  "|diff| / max(1, |raw|) %.3g (%s)"
                  % (t_gen, t_bin, fs.P, t_fetch, WIDE_INDEX_CHECKED, err,
                     smi)))
    del r["bst"], bst, fs, ds, X
    torch.cuda.empty_cache()
    return r["launches"]


def bins_equal(a, b) -> bool:
    return a.bins.shape == b.bins.shape and np.array_equal(a.bins, b.bins)


def write_text_data(path: str, X, y, fmt: str) -> None:
    """Rows as CSV with a header line or as LibSVM: each value as the
    shortest decimal of its f64, which parses back to it exactly."""
    with open(path, "w") as fh:
        if fmt == "csv":
            fh.write(",".join(["label"] + ["f%d" % j
                                           for j in range(X.shape[1])])
                     + "\n")
            for lab, row in zip(y.tolist(), X.astype(np.float64).tolist()):
                fh.write(",".join(map(repr, [lab] + row)) + "\n")
        else:
            keys = ["%d:" % j for j in range(X.shape[1])]
            for lab, row in zip(y.tolist(), X.astype(np.float64).tolist()):
                fh.write(" ".join([repr(lab)] + [
                    k + repr(v) for k, v in zip(keys, row) if v != 0.0])
                    + "\n")


def files_phase(data, seed: int, smi: str, on_cache=None) -> dict:
    """The data side's files and streams on the main path's data: its
    Dataset saved with save_binary and loaded by path trains the main
    model's text (3 iterations) byte for byte; TEXT_ROWS of its rows written
    as CSV (with a header) and as LibSVM and read by Dataset(path) bin
    exactly as from_matrix bins them; the 1,000,000 rows pushed in 8
    positioned chunks into a StreamingDatasetBuilder made by reference
    (bins and the 3-iteration model text equal to the in-memory ones),
    and the TEXT_ROWS rows pushed through Dataset.push_rows and
    push_rows_csr in 8 chunks into a fresh stream (its reservoir holding
    them all), binned exactly as from_matrix bins them (the JAX package's
    test_stream_ingest holds model identity below the reservoir's cap)."""
    import tempfile
    from lightgbm_tpu_torch.io.stream import StreamingDatasetBuilder
    ds, Xv, yv = data
    params = train_params(255)
    X, y = ds.data, np.asarray(ds.label)
    n = len(y)
    t0 = time.perf_counter()
    ref_bst = lt.train(params, ds, 3, verbose_eval=False)
    ref3 = ref_bst.model_to_string()
    t_ref = time.perf_counter() - t0
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # the reference run's save_model file: the CLI's and the C ABI's
        # model files must be it byte for byte
        ref_file = os.path.join(tmp, "ref3.txt")
        ref_bst.save_model(ref_file)
        del ref_bst
        cache = os.path.join(tmp, "main.bin")
        t0 = time.perf_counter()
        ds.save_binary(cache)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        dc = lt.Dataset(cache, params=params)
        dc.construct(lt.Config(params))
        t_load = time.perf_counter() - t0
        check(bins_equal(dc.binned, ds.binned)
              and np.array_equal(dc.binned.metadata.label,
                                 ds.binned.metadata.label),
              "files: the binary cache's bins or labels differ")
        reset_counts()
        with grower_mode():
            text_c = lt.train(params, dc, 3, verbose_eval=False) \
                .model_to_string()
        out["binary cache"] = read_counts()
        check(text_c == ref3, "files: the cache's model text differs at %s"
              % first_difference(text_c, ref3))
        cache_mb = os.path.getsize(cache) / 2**20
        if on_cache is not None:
            # the distributed ranks read the cache before it goes
            on_cache(cache)

        Xs, ys = X[:TEXT_ROWS], y[:TEXT_ROWS]
        t0 = time.perf_counter()
        ref_b = BinnedDataset.from_matrix(Xs, lt.Config(params))
        t_mat = time.perf_counter() - t0
        parsed = {}
        for fmt in ("csv", "libsvm"):
            path = os.path.join(tmp, "rows." + fmt)
            t0 = time.perf_counter()
            write_text_data(path, Xs, ys, fmt)
            t_write = time.perf_counter() - t0
            t0 = time.perf_counter()
            dt = lt.Dataset(path, params=params)
            dt.construct(lt.Config(params))
            t_parse = time.perf_counter() - t0
            check(bins_equal(dt.binned, ref_b)
                  and np.array_equal(dt.binned.metadata.label,
                                     ys.astype(np.float32)),
                  "files: %s rows bin differently from from_matrix" % fmt)
            parsed[fmt] = (t_write, t_parse)

        t0 = time.perf_counter()
        sb = StreamingDatasetBuilder(params=params, reference=ds,
                                     num_total_rows=n)
        step = -(-n // STREAM_CHUNKS)
        for s in range(n, 0, -step):  # positioned, last chunk first
            lo = max(0, s - step)
            sb.push_dense(X[lo:s], label=y[lo:s], start_row=lo)
        streaming = sb.streaming  # encoded at push time, nothing kept
        dstr = lt.Dataset(sb, params=params)
        dstr.construct(lt.Config(params))
        t_stream = time.perf_counter() - t0
        check(streaming and bins_equal(dstr.binned, ds.binned),
              "files: the by-reference stream bins differently")
        reset_counts()
        with grower_mode():
            text_s = lt.train(params, dstr, 3, verbose_eval=False) \
                .model_to_string()
        out["stream by reference"] = read_counts()
        check(text_s == ref3, "files: the stream's model text differs at %s"
              % first_difference(text_s, ref3))

        t0 = time.perf_counter()
        fresh = lt.Dataset(StreamingDatasetBuilder(params=params), label=ys,
                           params=params)
        step = TEXT_ROWS // STREAM_CHUNKS
        for k, s in enumerate(range(0, TEXT_ROWS, step)):
            part = Xs[s:s + step].astype(np.float64)
            if k % 2:
                mask = part != 0.0
                fresh.push_rows_csr(
                    np.concatenate([[0], np.cumsum(mask.sum(1))]),
                    np.nonzero(mask)[1], part[mask], part.shape[1])
            else:
                fresh.push_rows(part)
        held = fresh.data.reservoir_rows
        fresh.construct(lt.Config(params))
        t_fresh = time.perf_counter() - t0
        check(held == TEXT_ROWS and bins_equal(fresh.binned, ref_b),
              "files: the pushed rows bin differently from from_matrix "
              "(reservoir %d rows)" % held)
        say("files: binary cache of the main path's %d x %d Dataset (%.1f "
            "MiB, saved %.3f s, loaded %.3f s) trains the main model's text "
            "byte for byte over 3 iterations (reference run %.3f s); %d rows "
            "as CSV (written %.3f s, parsed and binned %.3f s) and LibSVM "
            "(%.3f s, %.3f s) bin as from_matrix (%.3f s) bins them; %d "
            "rows pushed in %d positioned chunks by reference (%.3f s): bins "
            "and model text equal; %d rows through push_rows / "
            "push_rows_csr (%.3f s, reservoir %d rows): bins equal (%s)"
            % (n, ds.binned.num_features, cache_mb, t_save, t_load, t_ref,
               TEXT_ROWS, *parsed["csv"], *parsed["libsvm"], t_mat, n,
               STREAM_CHUNKS, t_stream, TEXT_ROWS, t_fresh, held, smi))
        entry = dict(tmp=tmp, cache=cache, ref_file=ref_file, ref3=ref3,
                     t_ref=t_ref, csv=os.path.join(tmp, "rows.csv"))
        out.update(entry_phases(data, entry, smi))
    return out


# ---------------------------------------------------------------------------
# phases: the entry layers (the CLI, the C ABI, the doctor)
# ---------------------------------------------------------------------------

def start_capi_build() -> dict:
    """Both C libraries (capi.ensure_built: g++ over cpp/c_api.cc +
    cpp/ingest.cc and the port's c_train.cc) on a thread, beside the
    kernels' nvcc runs; `capi_build_done` joins it."""
    import threading
    from lightgbm_tpu_torch import capi
    rec = {}

    def run():
        t0 = time.perf_counter()
        try:
            capi.ensure_built(train=True)
        except BaseException as e:  # noqa: BLE001 — re-raised by the join
            rec["error"] = e
        rec["s"] = time.perf_counter() - t0

    rec["thread"] = threading.Thread(target=run, daemon=True)
    rec["thread"].start()
    return rec


def capi_build_done(rec: dict) -> float:
    rec["thread"].join()
    if "error" in rec:
        raise rec["error"]
    return rec["s"]


#: a C program that trains through the port's training library: the
#: dataset from a file, the booster, the updates on a thread that did not
#: load the library while this thread predicts through the same handle
#: (predict against update, the C ABI's any-thread contract), the
#: training metric and the model file
C_TRAIN_PROGRAM = r"""
#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <time.h>
#include <unistd.h>
#include "lightgbm_tpu_c_api.h"

#define CHECK(rc) do { if ((rc) != 0) { \
  fprintf(stderr, "FAIL: %s\n", LGBM_GetLastError()); return 1; } } while (0)

static BoosterHandle g_bst;
static int g_iters, g_rc;
static volatile int g_trees, g_done;
static double g_first_s, g_iter_s;

static double now(void) {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return t.tv_sec + 1e-9 * t.tv_nsec;
}

static void* updates(void* arg) {
  (void)arg;
  int fin = 0;
  double t0 = now();
  for (int i = 0; i < g_iters && g_rc == 0; ++i) {
    g_rc = LGBM_BoosterUpdateOneIter(g_bst, &fin);
    g_trees = i + 1;
    if (i == 0) g_first_s = now() - t0;
  }
  g_iter_s = now() - t0;
  g_done = 1;
  return NULL;
}

int main(int argc, char** argv) {
  if (argc != 6) return 2;
  int ncol = atoi(argv[5]), nrow = 1000;
  double* X = malloc(sizeof(double) * nrow * ncol);
  double* out = malloc(sizeof(double) * nrow);
  unsigned s = 12345u;
  for (int i = 0; i < nrow * ncol; ++i) {
    s = s * 1103515245u + 12345u;
    X[i] = ((double)(s >> 16) / 16384.0) - 2.0;
  }
  double t0 = now();
  DatasetHandle ds;
  CHECK(LGBM_DatasetCreateFromFile(argv[1], "", NULL, &ds));
  double t1 = now();
  CHECK(LGBM_BoosterCreate(ds, argv[2], &g_bst));
  double t2 = now();
  g_iters = atoi(argv[3]);
  pthread_t t;
  if (pthread_create(&t, NULL, updates, NULL) != 0) return 3;
  long predicts = 0;
  int64_t olen = 0;
  while (!g_done) {
    usleep(2000);  /* leave the cores to the updates between predicts */
    if (g_trees == 0) continue;  /* a model needs a tree to predict */
    CHECK(LGBM_BoosterPredictForMat(g_bst, X, 1, nrow, ncol, 1, 0, -1, "",
                                    &olen, out));
    for (int i = 0; i < nrow; ++i)
      if (!(out[i] >= 0.0 && out[i] <= 1.0)) {
        fprintf(stderr, "FAIL: prediction %d is %g under the race\n", i,
                out[i]);
        return 1;
      }
    ++predicts;
  }
  pthread_join(t, NULL);
  CHECK(g_rc);
  int len = 0;
  double ev[8];
  CHECK(LGBM_BoosterGetEval(g_bst, 0, &len, ev));
  CHECK(LGBM_BoosterSaveModel(g_bst, -1, argv[4]));
  printf("C-ABI train ok: dataset %.3f s (the interpreter's start and the "
         "package's import inside), booster %.3f s, %d iterations %.3f s "
         "on another thread (the first %.3f s with its captures, then "
         "%.4f s/iter) beside %ld predicts of %d rows through the same "
         "handle, training metric %.6f\n",
         t1 - t0, t2 - t1, g_iters, g_iter_s, g_first_s,
         (g_iter_s - g_first_s) / (g_iters > 1 ? g_iters - 1 : 1), predicts,
         nrow, ev[0]);
  CHECK(LGBM_BoosterFree(g_bst));
  CHECK(LGBM_DatasetFree(ds));
  return 0;
}
"""

#: iterations of the entry layers' runs: the files phase's reference run
ENTRY_ITERS = 3


def cli_phase(data, entry: dict, children: dict, smi: str) -> tuple:
    """The CLI on the card.  task=train in this process on the files
    phase's 1M-row binary cache at the main path's parameters, its
    launches counted (B1 and B2 only): the model file must be the
    reference run's save_model file byte for byte.  Then `python -m
    lightgbm_tpu_torch task=predict` of the held-out rows (written as a
    TSV) as children: with predict_device=false the host predictor's raw
    scores equal to NativeBooster.predict_for_file's byte for byte, by
    default the device predictor's within rtol 1e-5 / atol 1e-6 of
    them.  task=train on the
    files phase's CSV (header=true): its model file is the save_model file
    of lt.train on the rows parse_file reads here.  parse_dense's arrays
    of that CSV are the numpy reader's.  Returns (its line, launches)."""
    from lightgbm_tpu_torch import application, capi
    from lightgbm_tpu_torch.io import native, parser
    tmp, params = entry["tmp"], train_params(255)
    _, Xv, yv = data
    model = os.path.join(tmp, "cli.txt")
    reset_counts()
    t0 = time.perf_counter()
    with grower_mode():
        application.main(["task=train", "data=" + entry["cache"],
                          "output_model=" + model,
                          "num_trees=%d" % ENTRY_ITERS] + cli_args(params))
    t_cli = time.perf_counter() - t0
    launches = read_counts()
    b1_b2_ran("cli", launches, ENTRY_ITERS)
    check(read_bytes(model) == read_bytes(entry["ref_file"]),
          "cli: the model file differs from save_model's at %s"
          % first_difference(open(model).read(), open(entry["ref_file"])
                             .read()))
    heldout = os.path.join(tmp, "heldout.tsv")
    t0 = time.perf_counter()
    np.savetxt(heldout, np.column_stack([yv, Xv.astype(np.float64)]),
               delimiter="\t", fmt="%.17g")
    t_write = time.perf_counter() - t0
    preds = {}
    for name, extra in (("host", ["predict_device=false"]), ("device", [])):
        preds[name] = os.path.join(tmp, "pred_%s.txt" % name)
        children[name] = start_cli(
            ["task=predict", "data=" + heldout, "input_model=" + model,
             "output_result=" + preds[name], "predict_raw_score=true"]
            + extra)
    # the CSV through the CLI while the predictions run
    csv_model, csv_ref = (os.path.join(tmp, n) for n in ("csv.txt",
                                                          "csv_py.txt"))
    t0 = time.perf_counter()
    with grower_mode():
        application.main(["task=train", "data=" + entry["csv"],
                          "header=true", "output_model=" + csv_model,
                          "num_trees=%d" % ENTRY_ITERS] + cli_args(params))
    t_csv = time.perf_counter() - t0
    X, y = parser.parse_file(entry["csv"], has_header=True)
    with grower_mode():
        lt.train(dict(params, header=True), lt.Dataset(X, label=y),
                 ENTRY_ITERS, verbose_eval=False).save_model(csv_ref)
    check(read_bytes(csv_model) == read_bytes(csv_ref),
          "cli: the CSV's model file differs from save_model's at %s"
          % first_difference(open(csv_model).read(), open(csv_ref).read()))
    t0 = time.perf_counter()
    got = native.parse_dense(entry["csv"], ",", 0, True, F + 1)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    Xn, yn = parser._parse_delimited_numpy(entry["csv"], ",", 0, None, True)
    t_numpy = time.perf_counter() - t0
    check(got is not None and np.array_equal(got[0], Xn)
          and np.array_equal(got[1], yn),
          "cli: parse_dense of the CSV is not the numpy reader's")
    took = {}
    for name in ("host", "device"):
        rc, text, took[name] = cli_done(children.pop(name))
        check(rc == 0, "cli: task=predict (%s) exited %d: %s"
              % (name, rc, text[-2000:]))
    native_out = os.path.join(tmp, "pred_native.txt")
    t0 = time.perf_counter()
    capi.NativeBooster(model_file=model).predict_for_file(
        heldout, native_out, raw_score=True)
    t_c = time.perf_counter() - t0
    check(read_bytes(native_out) == read_bytes(preds["host"]),
          "cli: the host predictor's file is not predict_for_file's")
    host, dev = np.loadtxt(preds["host"]), np.loadtxt(preds["device"])
    check(host.shape == (len(yv),) and np.allclose(dev, host, rtol=1e-5,
                                                   atol=1e-6),
          "cli: the device predictor's raw scores are %.3g from the host's"
          % float(np.abs(dev - host).max()))
    return ("cli: task=train on the %d-row binary cache in this process, "
            "%d iterations %.3f s (%.4f s/iter; the reference run %.3f s, "
            "%.4f s/iter), B1 %d and B2 %d launches, no other kernel: the "
            "model file is save_model's byte for byte; `python -m "
            "lightgbm_tpu_torch task=predict` of the %d held-out rows "
            "(written %.3f s) as children, predict_device=false (host) "
            "%.1f s and the default (device) %.1f s from their start: host "
            "raw scores "
            "= NativeBooster.predict_for_file's (%.3f s) byte for byte, "
            "device within rtol 1e-5 (max |diff| %.3g); task=train on the "
            "%d-row CSV (header=true, %.3f s): save_model's file byte for "
            "byte; parse_dense %.3f s against the numpy reader's %.3f s, "
            "arrays equal (%s)"
            % (data[0].num_data(), ENTRY_ITERS, t_cli, t_cli / ENTRY_ITERS,
               entry["t_ref"], entry["t_ref"] / ENTRY_ITERS,
               launches["segment_histogram"], launches["partition_segment"],
               len(yv), t_write, took["host"], took["device"], t_c,
               float(np.abs(dev - host).max()), TEXT_ROWS, t_csv, t_native,
               t_numpy, smi)), launches


def c_abi_phase(data, entry: dict, smi: str, meanwhile=None) -> tuple:
    """The C ABI on the card.  In this process, through ctypes: the
    1M-row cache by LGBM_DatasetCreateFromFile, LGBM_BoosterCreate with
    the main path's parameters (no device_type: the card) and
    ENTRY_ITERS updates, their launches counted (B1 and B2 only); its
    model text (SaveModelToString) must be the reference run's save_model
    file.  Out of process: C_TRAIN_PROGRAM compiled with cc against the
    training library and run as a child on the same cache and
    parameters, its updates on a thread of their own while its main
    thread predicts through the handle: its LGBM_BoosterSaveModel file
    must be that file byte for byte (the card's fixed-point trees differ
    from the CPU's, so this also shows where the child trained), and
    NativeBooster on it must predict the held-out rows as the host
    Booster.predict does within 1e-12.  `meanwhile()` runs while the child
    does.  Returns (its line, launches)."""
    from lightgbm_tpu_torch import capi
    tmp = entry["tmp"]
    _, Xv, _ = data
    params = " ".join(cli_args(train_params(255)))
    want = read_bytes(entry["ref_file"])
    reset_counts()
    t0 = time.perf_counter()
    with grower_mode():
        tds = capi.TrainDataset.from_file(entry["cache"])
        tb = capi.TrainBooster(tds, params)
        for _ in range(ENTRY_ITERS):
            tb.update()
    t_in = time.perf_counter() - t0
    launches = read_counts()
    b1_b2_ran("c abi", launches, ENTRY_ITERS)
    text = tb.model_to_string()
    check(text.encode() == want and text.startswith(entry["ref3"]),
          "c abi: the in-process model text differs from save_model's")
    del tb, tds
    src = os.path.join(tmp, "c_train.c")
    with open(src, "w") as fh:
        fh.write(C_TRAIN_PROGRAM)
    exe = os.path.join(tmp, "c_train")
    lib = capi.train_lib_path()
    t0 = time.perf_counter()
    cc = subprocess.run(
        ["cc", "-O1", src, "-I", os.path.join(HERE, "cpp"), lib,
         os.path.join(os.path.dirname(lib), capi.LIB_NAME),
         "-Wl,-rpath," + os.path.dirname(lib), "-lpthread", "-o", exe],
        capture_output=True, text=True)
    t_cc = time.perf_counter() - t0
    check(cc.returncode == 0, "c abi: cc failed: %s" % cc.stderr[-2000:])
    c_model = os.path.join(tmp, "c_model.txt")
    env = dict(os.environ)
    env.pop("LIGHTGBM_TPU_ROOT", None)
    env["PYTHONPATH"] = os.pathsep.join(sorted({
        os.path.dirname(os.path.dirname(m.__file__)) for m in (np, torch)}))
    t0 = time.perf_counter()
    child = subprocess.Popen([exe, entry["cache"], params, str(ENTRY_ITERS),
                              c_model, str(F)], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, env=env)
    try:
        if meanwhile is not None:
            meanwhile()
        stdout, stderr = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    t_child = time.perf_counter() - t0
    check(child.returncode == 0 and "C-ABI train ok" in stdout,
          "c abi: the C program exited %d: %s"
          % (child.returncode, (stdout + stderr)[-3000:]))
    check(read_bytes(c_model) == want,
          "c abi: the C program's model file differs from save_model's at "
          "%s" % first_difference(open(c_model).read(), want.decode()))
    ref = lt.Booster(model_file=entry["ref_file"])
    nb = capi.NativeBooster(model_file=c_model)
    d = float(np.abs(nb.predict(Xv) - ref.predict(Xv)).max())
    check(d <= 1e-12, "c abi: NativeBooster is %.3g from Booster.predict"
          % d)
    said = [ln for ln in stdout.splitlines()
            if ln.startswith("C-ABI train ok")][0]
    return ("c abi: in this process through ctypes, DatasetCreateFromFile "
            "on the %d-row cache + BoosterCreate (no device_type: the card) "
            "+ %d updates %.3f s, B1 %d and B2 %d launches, no other "
            "kernel: the model text is save_model's; a C program (cc %.2f "
            "s) as a child beside the doctor phase, %.1f s in all: %s; its "
            "SaveModel file is "
            "save_model's byte for byte, NativeBooster on it within %.3g "
            "of Booster.predict on the held-out rows (%s)"
            % (data[0].num_data(), ENTRY_ITERS, t_in,
               launches["segment_histogram"], launches["partition_segment"],
               t_cc, t_child, said[len("C-ABI train ok: "):], d, smi)), \
        launches


def doctor_phase(entry: dict, crash: dict, smi: str) -> str:
    """task=doctor probe=true in this process: its bundle's probe.json
    binds the card and names it.  And the crashing child started beside
    the entry phases (task=train on a missing file): a non-zero exit and
    a crash bundle, its note naming the error."""
    import glob
    import tarfile
    from lightgbm_tpu_torch import application
    out_dir = os.path.join(entry["tmp"], "doctor")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    application.main(["task=doctor", "probe=true", "probe_deadline=120",
                      "output_dir=" + out_dir])
    t_doc = time.perf_counter() - t0

    def members(path):
        with tarfile.open(path) as tar:
            return {i.name.split("/", 1)[1]: tar.extractfile(i).read()
                    for i in tar.getmembers()}
    bundles = glob.glob(os.path.join(out_dir, "lgbm_debug_*.tar.gz"))
    check(len(bundles) == 1, "doctor: bundles %s" % bundles)
    probe = json.loads(members(bundles[0])["probe.json"])
    check(probe["ok"] and probe["backend"] == "cuda"
          and probe["device_name"] == torch.cuda.get_device_name(0),
          "doctor: the probe did not bind the card: %s" % probe)
    rc, text, t_crash = cli_done(crash)
    found = glob.glob(os.path.join(entry["tmp"], "crash",
                                   "lgbm_debug_crash_train_*.tar.gz"))
    check(rc != 0 and len(found) == 1,
          "doctor: the crashing task exited %d with bundles %s: %s"
          % (rc, found, text[-2000:]))
    note = json.loads(members(found[0])["manifest.json"])["note"]
    check("FileNotFoundError" in note, "doctor: the crash bundle's note: %s"
          % note[-500:])
    return ("doctor: task=doctor probe=true %.1f s: probe.json binds %s "
            "(%d device, the probe child %.2f s); task=train on a missing "
            "file as a child: exit %d after %.1f s with a crash bundle "
            "naming FileNotFoundError (%s)"
            % (t_doc, probe["device_name"], probe["devices"],
               probe["dur_s"], rc, t_crash, smi))


def entry_phases(data, entry: dict, smi: str) -> dict:
    """The CLI, the C ABI and the doctor on the files phase's cache, CSV
    and reference run; the crashing child starts first and is read by the
    doctor phase, which runs beside the C program.  Returns the launches
    of the cli and c abi paths."""
    t0 = time.perf_counter()
    os.makedirs(os.path.join(entry["tmp"], "crash"))
    crash = start_cli(["task=train", "data=" + os.path.join(
        entry["tmp"], "missing.tsv")],
        LGBM_TPU_DOCTOR_DIR=os.path.join(entry["tmp"], "crash"))
    children = {}
    try:
        line, cli = cli_phase(data, entry, children, smi)
        say(line)
        line, c_abi = c_abi_phase(
            data, entry, smi,
            meanwhile=lambda: say(doctor_phase(entry, crash, smi)))
        say(line)
    finally:
        for run in list(children.values()) + [crash]:
            if run["child"].poll() is None:
                run["child"].kill()
                run["child"].wait()
    say("entry layers: the cli, c abi and doctor phases took %.1f s"
        % (time.perf_counter() - t0))
    return {"cli": cli, "c abi": c_abi}


#: a payload past 2^31 elements: the rank path's width (F 136, P 146) at
#: 14,800,000 rows, 2,160,800,000 elements before the guard rows
ELEMENTS_ROWS, ELEMENTS_F = 14_800_000, 136
ELEMENTS_TAIL = 200_000


def elements_phase(seed: int, dev) -> str:
    """The kernels' 64-bit element indexing, on a payload of more than
    2^31 elements (random integer bins, random value columns, drawn on
    the card): B1 on the last 4,096 rows bit for bit to its fixed-point
    plain version; B2 on the last ELEMENTS_TAIL rows against the plain
    partition of a copy of those rows (payload rows and num_left byte for
    byte); the commit over every row (count * P past 2^31) against aux,
    the leaf values in the value column."""
    n, f = ELEMENTS_ROWS, ELEMENTS_F
    cols = cols_of(f)
    p = f + 10
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pay = torch.empty((n + seg.GUARD, p), device=dev)
    pay[:, :f].random_(0, B, generator=gen)
    pay[:, f:].normal_(generator=gen)
    pay[:, cols["cnt"]] = 1.0
    pay[n:] = 0.0
    check(pay.numel() > 2**31, "elements: %d elements" % pay.numel())
    t0 = time.perf_counter()
    s, c = n - 4096, 4096
    g, h, cn = cols["grad"], cols["hess"], cols["cnt"]
    got = cuda_segment.segment_histogram(pay, s, c, num_features=f,
                                         num_bins=B, grad_col=g, hess_col=h,
                                         cnt_col=cn)
    hist_exact(pay, s, c, f, got, cols=(g, h, cn))
    s, c = n - ELEMENTS_TAIL, ELEMENTS_TAIL
    sub = torch.zeros((c + seg.GUARD, p), device=dev)
    sub[:c] = pay[s:s + c]
    aux = torch.empty_like(pay).normal_(generator=gen)
    pred = make_pred(dev, B, 3, 100)
    _, _, nl = cuda_segment.partition_segment(pay, aux, s, c, pred, -1.0,
                                              1.0, cols["value"])
    plain_pay, _, plain_nl = seg.partition_segment(
        sub, torch.zeros_like(sub), 0, c, pred, -1.0, 1.0, cols["value"])
    check(int(nl) == int(plain_nl) and torch.equal(
        pay[s:s + c].view(torch.int32), plain_pay[:c].view(torch.int32)),
        "elements: B2 at rows [%d, %d) differs from the plain partition"
        % (s, s + c))
    del sub, plain_pay
    nl = torch.tensor(n // 3, dtype=torch.int32, device=dev)
    cuda_segment.partition_segment_commit(pay, aux, 0, n, nl, -2.0, 2.0,
                                          cols["value"])
    v = cols["value"]
    ok = True
    for r in range(0, n, 1 << 21):
        e = min(n, r + (1 << 21))
        a, b = pay[r:e], aux[r:e]
        want_v = torch.where(torch.arange(r, e, device=dev) < n // 3,
                             -2.0, 2.0)
        ok = ok and torch.equal(a[:, :v].view(torch.int32),
                                b[:, :v].view(torch.int32)) \
            and torch.equal(a[:, v + 1:].view(torch.int32),
                            b[:, v + 1:].view(torch.int32)) \
            and torch.equal(a[:, v], want_v)
    check(ok, "elements: the commit over %d x %d differs from aux" % (n, p))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    del pay, aux
    torch.cuda.empty_cache()
    return ("elements: a %d x %d payload (%d elements, past 2^31): B1 on its "
            "last 4096 rows bit for bit to the plain version, B2 on its last "
            "%d rows byte for byte to the plain partition, the commit over "
            "every row (count * P = %d) equal to aux with the leaf values "
            "(%.1f s)" % (n + seg.GUARD, p, (n + seg.GUARD) * p,
                          ELEMENTS_TAIL, n * p, secs))


#: the child's out-of-range calls (a segment that ends past the payload),
#: and what names the failing kernel in its message: the entry the
#: device check prints, or the kernel the assertion names
BOUNDS_CALLS = {"partition_segment": ("partition_segment count",
                                      "part_count_tiles"),
                "segment_histogram": ("segment_hist_kernel",)}


def bounds_child(kind: str) -> int:
    """In a child process: one call of `kind` (B2 or B1) on a segment that
    ends past the payload's rows, then a synchronize.  The kernel's device
    check must fail the call; printing "returned" means it did not."""
    dev = torch.device("cuda", 0)
    build.build_all()
    n = 4096
    pay = make_payload(n, F, P, 3, dev)
    aux = torch.zeros_like(pay)
    start, count = n - 100, 1000
    if kind == "partition_segment":
        cuda_segment.partition_segment(pay, aux, start, count,
                                       make_pred(dev, B, 3, 100), 0.0, 1.0,
                                       COLS["value"])
    else:
        cuda_segment.segment_histogram(
            pay, start, count, num_features=F, num_bins=B,
            grad_col=COLS["grad"], hess_col=COLS["hess"],
            cnt_col=COLS["cnt"])
    torch.cuda.synchronize()
    print("returned", flush=True)
    return 0


def bounds_phase() -> str:
    """One B2 and one B1 call whose segment ends past the payload's rows,
    each in a child process (a device assertion leaves the child's CUDA
    context unusable): each child must exit non-zero, with the kernel's
    message naming it and the segment; this process carries on.  The
    children run at the same time."""
    seen = {}
    t0 = time.perf_counter()
    procs = {kind: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--bounds-child", kind],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for kind in BOUNDS_CALLS}
    try:
        for kind, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            text = out + err
            lines = [ln for ln in text.splitlines()
                     if "outside the payload" in ln
                     and any(k in ln for k in BOUNDS_CALLS[kind])]
            check(proc.returncode != 0 and "returned" not in out and lines,
                  "bounds: the out-of-range %s call was not refused (exit "
                  "%d): %s" % (kind, proc.returncode, text[-2000:]))
            cuda_err = [ln for ln in text.splitlines() if "CUDA error" in ln]
            seen[kind] = dict(exit=proc.returncode, kernel=lines[0].strip(),
                              error=cuda_err[0].strip() if cuda_err
                              else None,
                              seconds=round(time.perf_counter() - t0, 3))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    x = torch.ones(4, device="cuda")
    check(float(x.sum()) == 4.0, "bounds: this process's context broke")
    return ("bounds: a B2 and a B1 call with start + count past the "
            "payload's rows, each in a child process, fail with the "
            "kernel's check and this process carries on: %s"
            % json.dumps(seen))


# ---------------------------------------------------------------------------
# phases: the training runtime's seams
# ---------------------------------------------------------------------------

#: the preempted child's rows, its fault and the iterations of the runs
PREEMPT_ROWS = 200_000
PREEMPT_FAULT = "sigterm_at_iter:3"
SEAM_ITERS = 10
#: the snapshot that resumes in process, and keep-last
RESUME_AT, SNAPSHOT_KEEP = 5, 3
BAG_PARAMS = dict(bagging_fraction=0.5, bagging_freq=1)
#: the sentinel's burst: every 7th gradient NaN at this iteration
BURST_AT, BURST_STRIDE, SENTINEL_ITERS = 3, 7, 5
#: the profiler hook's iterations (2 before the entry layers joined the
#: script), and the kernels its trace must show
PROFILE_ITERS = 1
PROFILE_KERNELS = {"B1": "segment_hist_kernel", "B2": "part_move"}


def phases_phase(data, main_run: dict, rows: int, iters: int) -> tuple:
    """The main path with tpu_profile_phases=true: the same model text
    (sha256) as the unprofiled main path, the phase table printed with
    its sum within the training's wall time, and the profile_sync waits
    (one at the end of each timed phase) beside the tree fetches."""
    ds, Xv, yv = data
    before = syncs.snapshot()
    r = train_path("phases", ds, Xv, yv,
                   train_params(255, tpu_profile_phases=True), iters,
                   syncs_per_tree=4)
    by_label = syncs.delta(before)["by_label"]
    check(sha(r["model_text"]) == sha(main_run["model_text"]),
          "phases: the profiled model text differs from the main path's "
          "at %s" % first_difference(r["model_text"],
                                     main_run["model_text"]))
    table = r["bst"].phase_timings()
    check(list(table) == ["boosting (gradients)",
                          "tree (hist+split+partition)",
                          "tree assemble (host)", "train score update",
                          "valid score update"],
          "phases: phase names %s" % list(table))
    total = sum(table.values())
    check(total <= r["t_train"], "phases: the phases sum to %.4f s, past "
          "the %.4f s of training" % (total, r["t_train"]))
    line = path_line(r, rows, iters, ", model sha256 %s (the main path's), "
                     "phases %s (sum %.4f s of %.4f s wall; main path "
                     "%.4f s/iter unprofiled), syncs by label %s"
                     % (sha(r["model_text"]),
                        json.dumps({k: round(v, 4)
                                    for k, v in table.items()}),
                        total, r["t_train"], main_run["s_per_iter"],
                        json.dumps(by_label)))
    del r["bst"]
    return line, r


def profiled_kernels(path: str) -> dict:
    """{kernel name: events} of a Chrome trace's device kernels."""
    with open(path) as fh:
        doc = json.load(fh)
    out = {}
    for e in doc.get("traceEvents", []):
        if e.get("cat") == "kernel":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def observe_phase(data, main_run: dict, rows: int, iters: int) -> tuple:
    """The main path with the seams on (telemetry, tracing and the program
    ledger, as they are by default) and with telemetry and tracing off,
    in this call, in the order off, on, on, off (s/iter of each): the
    same model text; in the first run with them on, 10 iterations
    counted, the last one's blocking syncs 1, no capture, build or cache
    miss in the ledger after the first iteration's captures, and one
    `tree dispatch` instant per tree in the exported Chrome trace."""
    import tempfile
    from lightgbm_tpu_torch.runtime import graph_obs, telemetry, tracing
    ds, Xv, yv = data
    params = train_params(255)
    runs = {"off": [], "on": []}
    marks = {}

    def after_first(env):
        if env.iteration == 0:
            marks["builds"] = graph_obs.snapshot()
            marks["misses"] = graph_obs.LEDGER.misses_snapshot()
            marks["replays"] = graph_obs.calls_snapshot()

    for mode in ("off", "on", "on", "off"):
        prev = (telemetry.set_enabled(mode == "on"),
                tracing.set_enabled(mode == "on"))
        first = mode == "on" and not runs["on"]
        if first:
            telemetry.reset()
            tracing.reset()
        try:
            r = train_path("observe " + mode, ds, Xv, yv, params, iters,
                           callbacks=[after_first] if first else None)
        finally:
            telemetry.set_enabled(prev[0])
            tracing.set_enabled(prev[1])
        del r["bst"]
        check(r["model_text"] == main_run["model_text"],
              "observe %s: the model text differs from the main path's at "
              "%s" % (mode, first_difference(r["model_text"],
                                             main_run["model_text"])))
        runs[mode].append(r)
        if not first:
            continue
        counted = telemetry.counter("lgbm_train_iterations_total").total()
        gauge = telemetry.gauge("lgbm_train_host_syncs_per_iter") \
            .value(path="total")
        check(counted == iters and gauge == 1.0,
              "observe: %s iterations counted, %s syncs in the last"
              % (counted, gauge))
        builds = graph_obs.delta(marks["builds"])
        misses = {k: v - marks["misses"].get(k, 0)
                  for k, v in graph_obs.LEDGER.misses_snapshot().items()
                  if v != marks["misses"].get(k, 0)}
        replays = graph_obs.calls_delta(marks["replays"])
        check(not builds and not misses,
              "observe: after the first iteration the ledger recorded "
              "builds %s and cache misses %s" % (builds, misses))
        with tempfile.TemporaryDirectory() as tmp:
            doc = tracing.export_chrome(os.path.join(tmp, "trace.json"))
        dispatch = [e for e in doc["traceEvents"]
                    if e.get("name") == "tree dispatch"]
        check(len(dispatch) == iters, "observe: %d tree dispatch instants "
              "for %d trees" % (len(dispatch), iters))
    s_on = [r["s_per_iter"] for r in runs["on"]]
    s_off = [r["s_per_iter"] for r in runs["off"]]
    overhead = np.mean(s_on) / np.mean(s_off) - 1.0
    return ("observe: the main path (%dx%d, %d iters) with telemetry, "
            "tracing and the program ledger on: model text the main "
            "path's (sha256 %s) with the seams off and on; s/iter off, on, "
            "on, off %s (on / off %+.2f %%); %d iterations counted, %d "
            "blocking syncs in the last, no build or cache miss after the "
            "first iteration (graph replays since: %s), %d tree dispatch "
            "instants in the Chrome trace"
            % (rows, F, iters, sha(main_run["model_text"]),
               ["%.4f" % r["s_per_iter"] for r in (runs["off"][0],
                                                   *runs["on"],
                                                   runs["off"][1])],
               100.0 * overhead, counted, gauge, json.dumps(replays),
               len(dispatch))), runs["on"][0]


def profile_hook_phase(data, iters: int = PROFILE_ITERS) -> str:
    """LGBM_TPU_PROFILE=<dir> with LGBM_TPU_PROFILE_ITERS=`iters`: the
    main path's first `iters` iterations in one torch.profiler trace of
    CUDA activity, whose device kernels must include B1's and B2's."""
    import tempfile
    from lightgbm_tpu_torch.runtime import telemetry
    ds = data[0]
    with tempfile.TemporaryDirectory() as tmp:
        os.environ[telemetry.PROFILE_ENV] = tmp
        os.environ[telemetry.PROFILE_ITERS_ENV] = str(iters)
        telemetry._reset_profile_hooks()
        try:
            t0 = time.perf_counter()
            with grower_mode():
                lt.train(train_params(255), ds, iters, verbose_eval=False)
            torch.cuda.synchronize()
            t_prof = time.perf_counter() - t0
            hook = telemetry.profile_hook("train")
            check(hook.done and hook.ticks == iters and hook.cuda
                  and os.path.exists(hook.path or ""),
                  "profile hook: no trace of %d iterations (ticks %d, done "
                  "%s)" % (iters, hook.ticks, hook.done))
            trace_mb = os.path.getsize(hook.path) / 2**20
            t0 = time.perf_counter()
            kernels = profiled_kernels(hook.path)
            t_read = time.perf_counter() - t0
        finally:
            os.environ.pop(telemetry.PROFILE_ENV, None)
            os.environ.pop(telemetry.PROFILE_ITERS_ENV, None)
            telemetry._reset_profile_hooks()
    found = {b: sum(n for k, n in kernels.items() if name in k)
             for b, name in PROFILE_KERNELS.items()}
    check(all(found.values()), "profile hook: the trace's kernels lack %s"
          % [b for b, n in found.items() if not n])
    return ("profile hook: LGBM_TPU_PROFILE wrapped the main path's first "
            "%d iterations in one torch.profiler trace of CUDA activity: "
            "%.3f s of training (the profiler's stop %.3f s and export "
            "%.3f s inside), trace %.1f MiB read in %.3f s, %d device "
            "kernel names, B1 (%s) %d and B2 (%s) %d launches"
            % (iters, t_prof, hook.stop_s, hook.export_s, trace_mb, t_read,
               len(kernels), PROFILE_KERNELS["B1"], found["B1"],
               PROFILE_KERNELS["B2"], found["B2"]))


def snapshotting_train(ds, params: dict, iters: int, out: str,
                       keep_at: int) -> tuple:
    """lt.train on the card writing a snapshot every iteration (keep-last
    SNAPSHOT_KEEP), as the JAX package's CLI does with snapshot_freq=1;
    the snapshot of iteration `keep_at` is copied aside.  Returns (the
    booster, each snapshot's ms, the kept copy's path)."""
    import shutil
    from lightgbm_tpu_torch.runtime import resilience
    ms, kept = [], out + ".kept_%d" % keep_at

    def snapshot(env):
        total = env.model.current_iteration()
        t0 = time.perf_counter()
        path = resilience.write_snapshot(env.model, out, total_iter=total,
                                         retention=SNAPSHOT_KEEP)
        ms.append(1e3 * (time.perf_counter() - t0))
        if total == keep_at:
            shutil.copy(path, kept)

    with grower_mode():
        bst = lt.train(params, ds, iters, callbacks=[snapshot],
                       verbose_eval=False)
    return bst, ms, kept


def resumed_text(ds, params: dict, iters: int, snap: str) -> str:
    """The model text of a run resumed from snapshot `snap` (the JAX
    package's CLI resume: init_model = the snapshot, its state restored
    before the first iteration) and trained to `iters` iterations."""
    from lightgbm_tpu_torch.runtime import resilience
    ok, why = resilience.validate_snapshot(snap)
    check(ok, "resume: snapshot %s is invalid: %s" % (snap, why))
    state = resilience.load_snapshot_state(snap)
    with grower_mode():
        bst = lt.train(params, ds, iters - state["total_iter"],
                       init_model=snap,
                       callbacks=[resilience.make_resume_callback(state)],
                       verbose_eval=False)
    return bst.model_to_string()


def resume_phase(data, main_run: dict, iters: int, smi: str) -> str:
    """Snapshots and resume on the card.  The main path and BAG_PARAMS
    bagging, each 10 iterations writing a snapshot every iteration
    (keep-last SNAPSHOT_KEEP; each snapshot's ms recorded): the main
    path's text must be the main path's; a resume from iteration
    RESUME_AT must give each uninterrupted model byte for byte, and so
    must the bagging run's resume after corrupt_snapshot truncated its
    last snapshot (the scan falls back to the one before)."""
    import tempfile
    from lightgbm_tpu_torch.runtime import resilience
    ds = data[0]
    tmp = tempfile.mkdtemp(prefix="lgbm_resume_")
    out = {}
    for label, params in (("main", train_params(255)),
                          ("bagging", train_params(255, **BAG_PARAMS))):
        target = os.path.join(tmp, label + ".txt")
        if label == "bagging":
            os.environ["LGBM_TPU_FAULT"] = "corrupt_snapshot:%d" % iters
        try:
            bst, ms, kept = snapshotting_train(ds, params, iters, target,
                                               RESUME_AT)
        finally:
            os.environ.pop("LGBM_TPU_FAULT", None)
        text = bst.model_to_string()
        del bst
        if label == "main":
            check(text == main_run["model_text"], "resume: the snapshotting "
                  "main path's text differs at %s"
                  % first_difference(text, main_run["model_text"]))
        kept_iters = [it for it, _ in resilience.snapshot_paths(target)]
        check(kept_iters == list(range(iters, iters - SNAPSHOT_KEEP, -1)),
              "resume: %s kept snapshots %s" % (label, kept_iters))
        t0 = time.perf_counter()
        again = resumed_text(ds, params, iters, kept)
        t_resume = time.perf_counter() - t0
        check(again == text, "resume: %s from iteration %d differs at %s"
              % (label, RESUME_AT, first_difference(again, text)))
        rec = dict(sha256=sha(text), snapshot_ms=[round(m, 2) for m in ms],
                   snapshot_ms_mean=round(float(np.mean(ms)), 2),
                   snapshot_mib=round(os.path.getsize(kept) / 2**20, 2),
                   resume_s=round(t_resume, 3))
        if label == "bagging":
            snap, state = resilience.find_resume_snapshot(target)
            check(snap is not None and state["total_iter"] == iters - 1,
                  "resume: the scan past the corrupt snapshot found %s"
                  % snap)
            check(again == resumed_text(ds, params, iters, snap),
                  "resume: bagging from the fallback snapshot differs")
            rec["fallback_from"] = state["total_iter"]
        out[label] = rec
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    return ("resume (%s): %d iterations each writing a snapshot every "
            "iteration (keep-last %d), resumed from iteration %d "
            "byte-identical to the uninterrupted model (the main path's "
            "text), bagging %s also from the scan past its truncated last "
            "snapshot: %s" % (smi, iters, SNAPSHOT_KEEP, RESUME_AT,
                              json.dumps(BAG_PARAMS), json.dumps(out)))


def cli_args(params: dict) -> list:
    """The CLI's `key=value` arguments for a parameter dict."""
    return ["%s=%s" % kv for kv in params.items()]


def start_cli(args: list, **env) -> dict:
    """`python -m lightgbm_tpu_torch <args>` as a child process of this
    checkout, with `env` added to its environment; `cli_done` ends it."""
    child = subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch", *args], cwd=HERE,
        env=dict(os.environ, PYTHONPATH=HERE, **env), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return dict(child=child, t0=time.perf_counter())


def cli_done(run: dict, timeout: float = 600) -> tuple:
    """(exit code, output, seconds since its start) of a `start_cli`
    child, killed if it outlives `timeout`."""
    proc = run["child"]
    try:
        text, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, text or "", time.perf_counter() - run["t0"]


def start_preempt_child(seed: int) -> dict:
    """The CLI under LGBM_TPU_FAULT=PREEMPT_FAULT, as a child: task=train
    snapshot_freq=1 on a binary cache of PREEMPT_ROWS rows of the main
    path's generator, SEAM_ITERS iterations; the parent goes on with other
    phases (preempt_done ends it)."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="lgbm_preempt_")
    X, y = synth(PREEMPT_ROWS, F, seed)
    cache = os.path.join(tmp, "preempt.bin")
    lt.Dataset(X, label=y).construct(lt.Config(train_params(255))) \
        .save_binary(cache)
    out = os.path.join(tmp, "preempt.txt")
    args = ["task=train", "data=" + cache, "output_model=" + out,
            "num_trees=%d" % SEAM_ITERS, "snapshot_freq=1",
            "snapshot_retention=%d" % SNAPSHOT_KEEP] \
        + cli_args(train_params(255))
    return dict(start_cli(args, LGBM_TPU_FAULT=PREEMPT_FAULT), out=out,
                tmp=tmp, cache=cache, args=args)


def preempt_done(run: dict, seed: int, iters: int) -> str:
    """The preempted CLI child's end: exit 0 with a valid snapshot and no
    model, then `task=train resume=true` here, whose model file must be
    the uninterrupted run's save_model file byte for byte."""
    import shutil
    from lightgbm_tpu_torch import application
    from lightgbm_tpu_torch.runtime import resilience
    rc, text, child_s = cli_done(run)
    check(rc == 0, "cli resume: the preempted CLI exited %d: %s"
          % (rc, text[-2000:]))
    check("preemption signal" in text and not os.path.exists(run["out"]),
          "cli resume: the CLI was not preempted: %s" % text[-2000:])
    snap, state = resilience.find_resume_snapshot(run["out"])
    check(snap is not None, "cli resume: the preempted CLI left no valid "
          "snapshot")
    t0 = time.perf_counter()
    with grower_mode():
        application.main(run["args"] + ["resume=true"])
    t_resume = time.perf_counter() - t0
    ds = lt.Dataset(run["cache"])
    with grower_mode():
        whole = lt.train(train_params(255), ds, iters, verbose_eval=False)
    whole_file = run["out"] + ".whole"
    whole.save_model(whole_file)
    check(read_bytes(run["out"]) == read_bytes(whole_file),
          "cli resume: the resumed model file differs from the "
          "uninterrupted run's at %s"
          % first_difference(open(run["out"]).read(),
                             open(whole_file).read()))
    shutil.rmtree(run["tmp"], ignore_errors=True)
    said = [ln.split("] ", 1)[-1] for ln in text.splitlines()
            if "preemption signal" in ln]
    return ("cli resume: %d rows as a binary cache, `python -m "
            "lightgbm_tpu_torch task=train snapshot_freq=1` under "
            "LGBM_TPU_FAULT=%s: exit 0 after %.1f s (%s), its snapshot of "
            "iteration %d resumed here by task=train resume=true (%.3f s) "
            "to %d iterations: the model file is the uninterrupted run's "
            "save_model file byte for byte (its trees' sha256 %s)"
            % (PREEMPT_ROWS, PREEMPT_FAULT, child_s,
               said[0].strip()[:120] if said else "?", state["total_iter"],
               t_resume, iters, sha(whole.model_to_string())))


def burst_fobj(at: int):
    """logloss_fobj with every BURST_STRIDE-th gradient NaN at its call
    `at` (the engine's iteration `at`)."""
    calls = {"n": 0}

    def fobj(preds, dataset):
        g, h = logloss_fobj(preds, dataset)
        if calls["n"] == at:
            g = g.copy()
            g[::BURST_STRIDE] = np.nan
        calls["n"] += 1
        return g, h
    return fobj


def sentinel_phase(data) -> str:
    """The non-finite sentinel on the card, on the main path's data with a
    held-out validation set: a real burst (burst_fobj at iteration
    BURST_AT, the custom objective of the custom-objective phase) and
    LGBM_TPU_FAULT=nan_grad:BURST_AT on the builtin objective.  abort
    must raise NonFiniteDetected naming iteration BURST_AT (the field
    that caught it is printed: "gradients" where the card's fixed-point
    sums left the leaf values finite); rollback must return finished with
    BURST_AT iterations of trees, its training and validation scores the
    pre-iteration ones bit for bit, and the blocking syncs per tree are
    printed."""
    from lightgbm_tpu_torch.runtime import resilience
    ds, Xv, yv = data
    dv = lt.Dataset(Xv, label=yv, reference=ds)
    out = {}
    for source in ("burst", "nan_grad"):
        fobj = None
        params = train_params(255, metric="auc")
        if source == "nan_grad":
            os.environ["LGBM_TPU_FAULT"] = "nan_grad:%d" % BURST_AT
        try:
            for policy in ("abort", "rollback"):
                if source == "burst":
                    fobj = burst_fobj(BURST_AT)
                    params = train_params(255, objective="none",
                                          metric="auc")
                p = dict(params, sentinel_nonfinite=policy)
                with grower_mode(strict=False):
                    bst = lt.Booster(p, ds)
                    bst.add_valid(dv, "valid")
                    raised, done, pre = None, None, None
                    t0 = time.perf_counter()
                    try:
                        for i in range(SENTINEL_ITERS):
                            if i == BURST_AT:
                                pre = (bst._engine.raw_train_score(),
                                       bst._engine.raw_valid_score(0))
                            done = bst.update(fobj=fobj)
                            if done:
                                break
                    except resilience.NonFiniteDetected as e:
                        raised = e
                    secs = time.perf_counter() - t0
                key = "%s %s" % (source, policy)
                if policy == "abort":
                    check(raised is not None and raised.iteration == BURST_AT,
                          "sentinel %s: raised %r" % (key, raised))
                    # the burst's stump carries the JAX package's non-finite
                    # leaf value, whichever field the fixed-point sums hid
                    check(raised.field == "leaf values",
                          "sentinel %s: caught by %r, not the JAX package's "
                          "'leaf values'" % (key, raised.field))
                    out[key] = dict(iteration=raised.iteration,
                                    field=raised.field,
                                    trees=bst.num_trees(),
                                    seconds=round(secs, 3))
                    continue
                check(raised is None and done and i == BURST_AT
                      and bst.current_iteration() == BURST_AT,
                      "sentinel %s: finished %s at update %d with %d "
                      "iterations (raised %r)" % (key, done, i,
                                                  bst.current_iteration(),
                                                  raised))
                post = (bst._engine.raw_train_score(),
                        bst._engine.raw_valid_score(0))
                same = all(np.array_equal(a.view(np.int32), b.view(np.int32))
                           for a, b in zip(pre, post))
                check(same, "sentinel %s: the scores are not the "
                      "pre-iteration ones bit for bit" % key)
                check(np.isfinite(bst.predict(Xv[:1000])).all(),
                      "sentinel %s: non-finite predictions" % key)
                out[key] = dict(trees=bst.num_trees(),
                                syncs_per_tree=bst.host_syncs_per_tree(),
                                seconds=round(secs, 3))
        finally:
            os.environ.pop("LGBM_TPU_FAULT", None)
    out["burst unguarded"] = unguarded_burst(Xv, yv)
    return ("sentinel: %dx%d (+%d held out), NaN in every %dth gradient at "
            "iteration %d (custom logloss) and nan_grad:%d (binary): %s"
            % (ds.num_data(), F, len(yv), BURST_STRIDE, BURST_AT, BURST_AT,
               json.dumps(out)))


#: rows of the burst run without the sentinel, on the card and the CPU
UNGUARDED_ROWS = 20_000


def unguarded_burst(X, y) -> dict:
    """The burst without the sentinel, on UNGUARDED_ROWS rows, on the card
    and on the CPU: iteration BURST_AT's tree must be the same text on
    both, a stump whose leaf value is not finite (the JAX package's; the
    card's fixed-point sums alone would grow a tree of finite values)."""
    X, y = X[:UNGUARDED_ROWS], y[:UNGUARDED_ROWS]
    trees = {}
    for device in ("cuda", "cpu"):
        fobj = burst_fobj(BURST_AT)
        params = train_params(255, objective="none", device_type=device)
        bst = lt.Booster(params, lt.Dataset(X, label=y))
        for _ in range(BURST_AT + 1):
            if bst.update(fobj=fobj):
                break
        check(bst.current_iteration() == BURST_AT + 1,
              "burst unguarded on %s: %d iterations"
              % (device, bst.current_iteration()))
        trees[device] = tree_texts(bst.model_to_string())[BURST_AT]
    tree = trees["cuda"]
    leaf = [ln for ln in tree.splitlines() if ln.startswith("leaf_value=")]
    check(trees["cpu"] == tree and "num_leaves=1" in tree.splitlines()
          and leaf and not np.isfinite(float(leaf[0].split("=")[1])),
          "burst unguarded: iteration %d's tree on the card %r, on the CPU "
          "%r" % (BURST_AT, tree[:300], trees["cpu"][:300]))
    return dict(rows=UNGUARDED_ROWS, tree=BURST_AT, leaf=leaf[0],
                card_equals_cpu=True)


def seam_phases(data, main_run: dict, rows: int, iters: int, seed: int,
                smi: str) -> dict:
    """phases, observe (its timed runs first, then the profiler hook
    beside the preempted child's start), sentinel and resume (in process,
    then the child's end); returns their paths' launches."""
    t0 = time.perf_counter()
    line, r = phases_phase(data, main_run, rows, iters)
    say(line)
    line, on = observe_phase(data, main_run, rows, iters)
    say(line)
    child = start_preempt_child(seed)
    say(profile_hook_phase(data))
    say(sentinel_phase(data))
    say(resume_phase(data, main_run, iters, smi))
    say(preempt_done(child, seed, iters))
    say("seams: the phases, observe, sentinel and resume phases took "
        "%.1f s" % (time.perf_counter() - t0))
    return {"phases": r["launches"], "observe": on["launches"]}


# ---------------------------------------------------------------------------
# phases: what the JAX package trains on its masked grower, and the
# scikit-learn estimators
# ---------------------------------------------------------------------------

#: GOSS at lr 0.5: the warm-up lasts int(1 / 0.5) = 2 iterations, so
#: iterations 3 and 4 sample
GOSS_HALF = dict(GOSS_PARAMS, learning_rate=0.5)
GOSS_HALF_ITERS = 4
RF_RANK_ITERS = 3
#: the card-against-CPU cut of the GOSS rank path
GOSS_RANK_PARITY_ROWS = 20_000

#: the model-text fields two equivalent models share exactly, and those
#: held within a tolerance (the rule of the tests' assert_models_equivalent)
EXACT_FIELDS = ("split_feature=", "threshold=", "decision_type=",
                "left_child=", "right_child=", "leaf_count=",
                "internal_count=", "num_leaves=", "num_cat=",
                "cat_threshold=", "cat_boundaries=", "shrinkage=")
CLOSE_FIELDS = ("leaf_value=", "internal_value=", "split_gain=",
                "leaf_weight=", "internal_weight=")


def models_equivalent(a: str, b: str, rtol: float = 1e-4,
                      atol: float = 1e-6) -> str:
    """'' if two model texts are equivalent by the tests' rule
    (tests/conftest.py assert_models_equivalent: structure exact, values
    within rtol / atol, split gains within 5e-3 / 1e-3), else the first
    line that is not."""
    la, lb = a.splitlines(), b.splitlines()
    if len(la) != len(lb):
        return "%d vs %d lines" % (len(la), len(lb))
    for xa, xb in zip(la, lb):
        if xa == xb:
            continue
        key = xa.split("=")[0] + "="
        if key == "tree_sizes=":
            continue
        if key != xb.split("=")[0] + "=" or key in EXACT_FIELDS \
                or key not in CLOSE_FIELDS:
            return "%s vs %s" % (xa[:120], xb[:120])
        va = np.asarray([float(v) for v in xa.split("=")[1].split()])
        vb = np.asarray([float(v) for v in xb.split("=")[1].split()])
        r, t = (max(rtol, 5e-3), max(atol, 1e-3)) if key == "split_gain=" \
            else (rtol, atol)
        if not np.allclose(va, vb, rtol=r, atol=t):
            return "%s max |diff| %.3g" % (key, float(np.abs(va - vb).max()))
    return ""


def original_order_run(label: str, ds, Xv, yv, params: dict, iters: int,
                       **kwargs) -> tuple:
    """train_path of a configuration the JAX package grows on its masked
    grower, which the port grows on the payload: B1 and B2 and no other
    kernel, the payload active.  Under GOSS the first sampled
    iteration's selection, drawn over the rows in original order, is
    held bit for bit against the host's (goss_mask_check).  Returns (the
    run, the selection's note)."""
    rec = {}
    goss = params.get("boosting") == "goss"
    with goss_recorder(int(1.0 / params["learning_rate"]), rec) if goss \
            else contextlib.nullcontext():
        r = train_path(label, ds, Xv, yv, params, iters, **kwargs)
    check(r["bst"]._engine._fast_active, "%s: the payload was left" % label)
    b1_b2_ran(label, r["launches"], len(r["leaves"]))
    if not goss:
        return r, ""
    check(rec.get("rows") is not None, "%s: the selection was not drawn in "
          "original order" % label)
    return r, goss_mask_check(label, rec)


def original_order_line(label: str, r: dict, extra: str, smi: str) -> str:
    return ("%s: %d iters: %.4f s/iter (train %.3f s), syncs/tree %s, "
            "splits/tree %.2f, %s, peak %.1f MiB (max_memory_allocated %d "
            "B, %d B before), sha256 %s%s, graph replays %s, launches %s "
            "(%s)"
            % (label, len(r["leaves"]) // max(
                1, r["bst"]._model.num_tree_per_iteration),
               r["s_per_iter"], r["t_train"], r["syncs"],
               r["splits_per_tree"], launches_of(r), r["peak"] / 2 ** 20,
               r["peak"], r["peak_before"], sha(r["model_text"]), extra,
               json.dumps(r["replays"]), json.dumps(r["launches"]), smi))


def goss_fobj_phase(data, smi: str) -> dict:
    """GOSS with the custom objective phase's numpy logloss fobj on the
    main path's data, lr 0.5, 4 iterations: tree 1 (the warm-up's)
    equivalent to a GBDT fobj run's at lr 0.5, two blocking syncs a tree,
    held-out AUC above iteration 1's; the repeat check.  Returns its
    launches."""
    ds, Xv, yv = data
    params = train_params(255, **GOSS_HALF)
    r, masks = original_order_run("goss fobj", ds, Xv, yv, params,
                                  GOSS_HALF_ITERS, syncs_per_tree=2,
                                  fobj=logloss_fobj)
    part = train_path("fobj lr 0.5", ds, Xv, yv,
                      train_params(255, learning_rate=0.5), 1,
                      syncs_per_tree=2, fobj=logloss_fobj)
    t1, p1 = tree_texts(r["model_text"])[0], tree_texts(part["model_text"])[0]
    diff = models_equivalent(t1, p1)
    check(not diff, "goss fobj: tree 1 not the GBDT fobj run's: %s" % diff)
    auc1 = auc_score(yv, r["bst"].predict(Xv, raw_score=True,
                                          num_iteration=1))
    check(r["auc"] > auc1, "goss fobj: AUC %.6f after %d iterations, %.6f "
          "after 1" % (r["auc"], GOSS_HALF_ITERS, auc1))
    say(original_order_line(
        "goss fobj", r, ", tree 1 %s the GBDT fobj run's at lr 0.5, held-"
        "out AUC %.6f (%.6f after iteration 1); %s"
        % ("byte-identical to" if t1 == p1 else "equivalent to", r["auc"],
           auc1, masks), smi))
    launches, text = r["launches"], r["model_text"]
    del r, part
    say(repeat_check("goss fobj", lambda: lt.train(
        params, ds, GOSS_HALF_ITERS, fobj=logloss_fobj, verbose_eval=False),
        text))
    return launches


def sklearn_module():
    """The port's sklearn module as a process without scikit-learn has
    it: the imported one where scikit-learn is absent, else a fresh copy
    loaded with scikit-learn hidden from sys.modules."""
    if importlib.util.find_spec("sklearn") is None:
        return lt.sklearn, "scikit-learn absent"
    saved = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k == "sklearn" or k.startswith("sklearn.")}
    sys.modules["sklearn"] = None
    try:
        spec = importlib.util.spec_from_file_location(
            "lightgbm_tpu_torch._sklearn_alone", lt.sklearn.__file__)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        del sys.modules["sklearn"]
        sys.modules.update(saved)
    return mod, "scikit-learn installed, hidden"


def sklearn_phase(rows: int, seed: int, main_run: dict, iters: int,
                  smi: str) -> dict:
    """LGBMClassifier(n_estimators=10, num_leaves=255, learning_rate=0.1,
    max_bin=255) fitted on the main path's rows with scikit-learn absent:
    one blocking sync a tree, B1 and B2 launched, its trees equivalent to
    the main path's (sha256 of both printed), predict_proba[:, 1] the main
    path's Booster.predict within 1e-6, predict the classes of argmax;
    the repeat check.  Returns its launches."""
    mod, how = sklearn_module()
    check(mod._SKBase is object, "sklearn: the estimators derive from %s"
          % mod._SKBase)
    X, y = synth(rows + 100_000, F, seed)
    Xt, yt, Xv = X[:rows], y[:rows], X[rows:]

    def fit():
        return mod.LGBMClassifier(n_estimators=iters, num_leaves=255,
                                  learning_rate=0.1, max_bin=255).fit(Xt, yt)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with grower_mode():
        est = fit()
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    bst = est.booster_
    check_trees_stopped("sklearn", bst)
    check(bst.device.type == "cuda", "sklearn fit ran on %s" % bst.device)
    b1_b2_ran("sklearn", launches, iters)
    syncs_ = bst.host_syncs_per_tree()
    check(syncs_ == [1] * iters, "sklearn: syncs per tree %s" % syncs_)
    text = bst.model_to_string()
    diff = models_equivalent(text, main_run["model_text"])
    check(not diff, "sklearn: not equivalent to the main path: %s" % diff)
    proba = est.predict_proba(Xv)
    d = float(np.abs(proba[:, 1] - main_run["pred"]).max())
    check(proba.shape == (len(Xv), 2) and d <= 1e-6,
          "sklearn: predict_proba[:, 1] vs Booster.predict max |diff| %.3g"
          % d)
    labels = est.predict(Xv)
    check(np.array_equal(labels, est.classes_[np.argmax(proba, axis=1)]),
          "sklearn: predict is not the argmax class")
    say("sklearn: LGBMClassifier(n_estimators=%d, num_leaves=255, "
        "learning_rate=0.1, max_bin=255).fit on %dx%d (%s, the estimators "
        "derive from object): %.4f s/iter (fit %.3f s, binning included; "
        "main path %.4f s/iter), syncs/tree %s, trees %s the main path's "
        "(sha256 %s, main path %s), predict_proba[:, 1] vs the main path's "
        "Booster.predict max |diff| %.3g on %d held-out rows, peak %.1f MiB, "
        "launches %s (%s)"
        % (iters, rows, F, how, t_fit / iters, t_fit,
           main_run["s_per_iter"], syncs_,
           "byte-identical to" if text == main_run["model_text"]
           else "equivalent to", sha(text), sha(main_run["model_text"]), d,
           len(Xv), peak / 2 ** 20, json.dumps(launches), smi))
    del est, bst
    say(repeat_check("sklearn", lambda: fit().booster_,
                     main_run["model_text"] if text ==
                     main_run["model_text"] else text))
    return launches


def goss_l1_phase(data, smi: str) -> dict:
    """GOSS with regression_l1 on the year-shaped data, lr 0.5, 4
    iterations: two blocking syncs a tree (the tree's and the renewal's),
    held-out L1 below the constant median's, the host renewal's ms a
    tree; the repeat check.  Returns its launches."""
    from lightgbm_tpu_torch.objective import regression as treg
    ds, _, Xv, yv = data
    params = train_params(255, objective="regression_l1", **GOSS_HALF)
    base = float(np.mean(np.abs(yv - np.median(ds.get_label()))))

    def quality(yv_, pred):
        l1 = float(np.mean(np.abs(pred - yv_)))
        return l1, l1 < base

    spent = []
    real = treg.RegressionL1.renew_leaf_values

    def timed(obj, *args, **kwargs):
        t0 = time.perf_counter()
        out = real(obj, *args, **kwargs)
        spent.append(time.perf_counter() - t0)
        return out

    treg.RegressionL1.renew_leaf_values = timed
    try:
        r, masks = original_order_run("goss l1", ds, Xv, yv, params,
                                      GOSS_HALF_ITERS, syncs_per_tree=2,
                                      quality=quality)
    finally:
        treg.RegressionL1.renew_leaf_values = real
    check(len(spent) == GOSS_HALF_ITERS, "goss l1: %d renewals for %d "
          "trees" % (len(spent), GOSS_HALF_ITERS))
    say(original_order_line(
        "goss l1", r, ", held-out L1 %.4f (constant median %.4f), host "
        "renewal %.2f ms a tree (%s); %s"
        % (r["auc"], base, 1e3 * float(np.mean(spent)),
           json.dumps([round(1e3 * v, 2) for v in spent]), masks), smi))
    launches, text = r["launches"], r["model_text"]
    del r
    say(repeat_check("goss l1", lambda: lt.train(
        params, ds, GOSS_HALF_ITERS, verbose_eval=False), text))
    return launches


def rank_variant_phases(rank: dict, smi: str) -> dict:
    """GOSS with lambdarank on the rank path's data (top_rate 0.2,
    other_rate 0.1, lr 0.5, 4 iterations, the held-out queries scored
    every iteration): trees 1 and 2 (the warm-up's) equivalent to those
    of the GBDT lambdarank run at lr 0.5, held-out NDCG@10 above
    iteration 1's and a random ranking's, the repeat check; the card
    against the CPU on a 20,000-row cut; then RF with lambdarank
    (bagging_fraction 0.632, bagging_freq 1, feature_fraction 0.7, 3
    iterations): NDCG@10 above a random ranking's, the repeat check.
    Returns each path's launches."""
    ds, dv, Xv, yv = rank["ds"], rank["dv"], rank["Xv"], rank["yv"]
    ndcg10, rand = rank["ndcg10"], rank["rand"]

    def quality(yv_, pred):
        v = ndcg10.eval(pred, None)
        return v, v > rand

    base = dict(objective="lambdarank", metric="ndcg", eval_at=[10])
    params = train_params(255, **base, **GOSS_HALF)
    evals = {}
    r, masks = original_order_run("goss rank", ds, Xv, yv, params,
                                  GOSS_HALF_ITERS, valid_sets=[dv],
                                  quality=quality, evals_result=evals)
    curve = evals["valid_0"]["ndcg@10"]
    check(curve[-1] > curve[0] and curve[-1] > rand,
          "goss rank: NDCG@10 %s, random %.6f" % (curve, rand))
    part = train_path("rank lr 0.5", ds, Xv, yv,
                      train_params(255, **base, learning_rate=0.5), 2,
                      quality=quality)
    ta, tb = tree_texts(r["model_text"]), tree_texts(part["model_text"])
    for i in (0, 1):
        diff = models_equivalent(ta[i], tb[i])
        check(not diff, "goss rank: tree %d not the GBDT run's: %s"
              % (i + 1, diff))
    say(original_order_line(
        "goss rank", r, ", trees 1 and 2 %s the GBDT lambdarank run's at lr "
        "0.5, held-out NDCG@10 by iteration %s (random ranking %.6f); %s"
        % ("byte-identical to" if ta[:2] == tb[:2] else "equivalent to",
           json.dumps([round(v, 6) for v in curve]), rand, masks), smi))
    runs = {"goss rank": r["launches"]}
    text = r["model_text"]
    del r, part
    say(repeat_check("goss rank", lambda: lt.train(
        params, ds, GOSS_HALF_ITERS, valid_sets=[dv], verbose_eval=False),
        text))
    say(goss_rank_parity_line(rank, params))
    rf_params = train_params(255, **base, **RF_PARAMS)
    r, _ = original_order_run("rf rank", ds, Xv, yv, rf_params,
                              RF_RANK_ITERS, quality=quality)
    say(original_order_line("rf rank", r, ", held-out NDCG@10 %.6f (random "
                            "ranking %.6f)" % (r["auc"], rand), smi))
    runs["rf rank"], text = r["launches"], r["model_text"]
    del r
    say(repeat_check("rf rank", lambda: lt.train(
        rf_params, ds, RF_RANK_ITERS, verbose_eval=False), text))
    return runs


def goss_rank_parity_line(rank: dict, params: dict) -> str:
    """The GOSS rank path on its first queries up to GOSS_RANK_PARITY_ROWS
    rows (31 leaves), the card against the CPU under the objectives
    parity rule: the same structure and each tree's leaf values within
    LEAF_RTOL of its largest |leaf value|."""
    sizes = rank["gt"]
    nq = int(np.searchsorted(np.cumsum(sizes), GOSS_RANK_PARITY_ROWS,
                             side="right"))
    n = int(np.sum(sizes[:nq]))
    X, y, g = rank["Xt"][:n], rank["yt"][:n], sizes[:nq]
    p = dict(params, num_leaves=31)
    with grower_mode():
        bc = lt.train(p, lt.Dataset(X, label=y, group=g), GOSS_HALF_ITERS,
                      verbose_eval=False)
    bh = lt.train(dict(p, device_type="cpu"), lt.Dataset(X, label=y,
                                                         group=g),
                  GOSS_HALF_ITERS, verbose_eval=False)
    where = same_structure(bc, bh, X)
    check(not where, "goss rank parity: card vs CPU structure differs: %s"
          % where)
    worst = 0.0
    for tc, th in zip(bc._model.trees, bh._model.trees):
        nl = tc.num_leaves
        scale = float(np.abs(th.leaf_value[:nl]).max())
        d = float(np.abs(tc.leaf_value[:nl] - th.leaf_value[:nl]).max())
        check(d <= LEAF_RTOL * scale, "goss rank parity: leaf values %.3g "
              "apart, beyond %g of %.4g" % (d, LEAF_RTOL, scale))
        worst = max(worst, d / scale)
    return ("goss rank parity: %d rows x %d in %d queries, 31 leaves, %d "
            "iters, card vs CPU: structure equal, leaf values within %g of "
            "each tree's largest |leaf| (largest share %.3g), leaves %s"
            % (n, X.shape[1], nq, GOSS_HALF_ITERS, LEAF_RTOL, worst,
               [t.num_leaves for t in bc._model.trees]))


# ---------------------------------------------------------------------------
# phases: the distributed learners
# ---------------------------------------------------------------------------

#: the distributed runs on the main data: (name, extra params); two ranks
#: on cuda:0 over gloo, DIST_ITERS iterations each
DIST_RUNS = (("data", dict(tree_learner="data")),
             ("feature", dict(tree_learner="feature")),
             ("voting top_k 20", dict(tree_learner="voting", top_k=20)),
             ("voting top_k 5", dict(tree_learner="voting", top_k=5)),
             ("data int8", dict(tree_learner="data",
                                gradient_quantization=True,
                                gradient_quant_dtype="int8")))
DIST_ITERS = 3
#: the wide distributed run: rows x F 968 (B7 and B3 on the path)
DIST_WIDE_ROWS, DIST_WIDE_F, DIST_WIDE_ITERS = 131_072, 968, 2
#: the runs that must write the serial model cut at the same iteration
#: byte for byte (the exchange sums raw int64 cells exactly; voting at
#: top_k 20 sums all 28 features, 2 top_k >= F)
DIST_EXACT = ("data", "feature", "voting top_k 20", "wide data")
#: the restricted vote's held-out AUC bound against the serial cut (its
#: summed cells are exact, so the model is the same in every run; the
#: gap measured on an H100 was 6.4e-9)
VOTE_AUC = 1e-7
#: the runs held to a serial run's held-out AUC: (the path whose model is
#: the reference, None for the main path's cut; the bound)
DIST_AUC = {"voting top_k 5": (None, VOTE_AUC),
            "data int8": ("quantized int8", AGREE_AUC)}


def dist_child(rank: int, spec_path: str) -> int:
    """One rank of the distributed phase (a child process): joins the
    gloo group through the FileStore of the spec, loads each run's binary
    Dataset cache, trains it on cuda:0 (the parent built the kernels; this
    process loads them from the build cache) with every launch count set
    to 0 just before and read just after, and writes each run's model
    text, s/iter, blocking syncs per tree, exchange bytes per tree, peak
    memory and launches as JSON."""
    from lightgbm_tpu_torch.parallel import comm, launch
    import torch.distributed as tdist
    with open(spec_path) as fh:
        spec = json.load(fh)
    torch.cuda.set_device(0)
    build.build_all()
    launch.init_group(store=tdist.FileStore(spec["store"], spec["world"]),
                      world_size=spec["world"], rank=rank, timeout_s=600,
                      attempts=1)
    out = {}
    try:
        for job in spec["jobs"]:
            params = train_params(255, **job["params"])
            t0 = time.perf_counter()
            ds = lt.Dataset(job["cache"], params=params)
            ds.construct(lt.Config(params))
            t_load = time.perf_counter() - t0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            comm.bytes_sent = 0
            t0 = time.perf_counter()
            bst = lt.train(params, ds, job["iters"], verbose_eval=False)
            torch.cuda.synchronize()
            t_train = time.perf_counter() - t0
            trees = bst.num_trees()
            text = bst.model_to_string()
            out[job["name"]] = dict(
                mode=bst._engine.parallel_mode, world=bst._engine.world,
                sha=sha(text), text=text if rank == 0 else None,
                s_per_iter=t_train / job["iters"], load_s=t_load,
                syncs_per_tree=float(np.mean(bst.host_syncs_per_tree())),
                exchange_bytes_per_tree=comm.bytes_sent / trees,
                peak_mib=mib(torch.cuda.max_memory_allocated()),
                payload_rows=int(bst._engine._fast.payload.shape[0]),
                launches=read_counts(),
                hist_engine=bst._engine.grower.hist_engine,
                part_engine=bst._engine.grower.part_engine)
            del bst, ds
            torch.cuda.empty_cache()
    finally:
        tdist.destroy_process_group()
    with open(spec["out"] % rank, "w") as fh:
        json.dump(out, fh)
    return 0


def run_ranks(spec: dict, world: int = 2, timeout: float = 600) -> list:
    """Start `world` rank children on the spec, join them under a timeout
    that kills the ones left; returns each rank's results."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="lgbm_dist_")
    spec = dict(spec, world=world, store=os.path.join(tmp, "store"),
                out=os.path.join(tmp, "rank%d.json"))
    spec_path = os.path.join(tmp, "spec.json")
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-child", str(r),
         "--dist-spec", spec_path], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        deadline = time.time() + timeout
        for proc in procs:
            logs.append(proc.communicate(
                timeout=max(deadline - time.time(), 1))[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, proc in enumerate(procs):
        check(proc.returncode == 0, "distributed: rank %d exited %s:\n%s"
              % (r, proc.returncode, (logs[r] if r < len(logs) else "")
                 [-3000:]))
    res = []
    for r in range(world):
        with open(spec["out"] % r) as fh:
            res.append(json.load(fh))
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    return res


def host_auc(text: str, Xv, yv) -> float:
    """The held-out AUC of a model text, predicted on the host."""
    b = lt.Booster(params={"device_type": "cpu"}, model_str=text)
    return auc_score(yv, b.predict(Xv))


def distributed_phase(cache: str, data, main_cut: str, runs: dict,
                      seed: int, dev, smi: str) -> tuple:
    """The distributed learners on the card: two rank processes on cuda:0
    (gloo; NCCL refuses two ranks on one device) load the main path's
    binary cache and train DIST_ITERS iterations at 255 leaves in each
    mode of DIST_RUNS, then tree_learner=data at DIST_WIDE_ROWS x 968
    (B7 and B3) beside this process's serial run on the same rows.  Every
    rank's model must be rank 0's; data, feature, voting top_k 20 (a
    vote of every feature) and wide data must be the serial model cut at
    the same iteration byte for byte (main_cut for the main data); the
    restricted vote (top_k 5) within VOTE_AUC and data int8 within
    AGREE_AUC of their serial runs' held-out AUC.  Returns its line and each run's
    launches (rank 0's)."""
    import tempfile
    _, Xv, yv = data
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # the wide rows: binned here, trained serially here, cached for
        # the ranks
        X, y = wide_synth(DIST_WIDE_ROWS, DIST_WIDE_F, seed + 19, dev,
                          WIDE_NAN[DIST_WIDE_F])
        params = train_params(255)
        dw = lt.Dataset(X, label=y)
        dw.construct(lt.Config(params))
        del X
        wide_cache = os.path.join(tmp, "wide.bin")
        dw.save_binary(wide_cache)
        reset_counts()
        t0 = time.perf_counter()
        wide_serial = lt.train(params, dw, DIST_WIDE_ITERS,
                               verbose_eval=False).model_to_string()
        t_wide_serial = time.perf_counter() - t0
        del dw
        torch.cuda.empty_cache()
        jobs = [dict(name=name, cache=cache, params=extra, iters=DIST_ITERS)
                for name, extra in DIST_RUNS]
        jobs.append(dict(name="wide data", cache=wide_cache,
                         params=dict(tree_learner="data"),
                         iters=DIST_WIDE_ITERS))
        t0 = time.perf_counter()
        ranks = run_ranks(dict(jobs=jobs))
        t_ranks = time.perf_counter() - t0
    serial = {"data": main_cut, "feature": main_cut,
              "voting top_k 20": main_cut, "voting top_k 5": main_cut,
              "wide data": wide_serial}
    out, launches = {}, {}
    for job in jobs:
        name = job["name"]
        r0, r1 = ranks[0][name], ranks[1][name]
        mode = job["params"]["tree_learner"]
        check(r0["mode"] == mode and r0["world"] == 2,
              "distributed %s trained %s over %d ranks"
              % (name, r0["mode"], r0["world"]))
        check(r1["sha"] == r0["sha"], "distributed %s: rank 1's model "
              "differs from rank 0's" % name)
        n = r0["launches"]
        hist = "segment_histogram_quant" if "int8" in name else (
            "segment_histogram_colblock" if name == "wide data"
            else "segment_histogram")
        part = "partition_segment_rmw" if name == "wide data" \
            else "partition_segment"
        check(n[hist] > 0 and n[part] > 0,
              "distributed %s: %s %d, %s %d launches"
              % (name, hist, n[hist], part, n[part]))
        rec = {k: r0[k] for k in ("s_per_iter", "syncs_per_tree",
                                  "exchange_bytes_per_tree", "payload_rows",
                                  "hist_engine", "part_engine", "load_s")}
        rec["peak_mib"] = [r0["peak_mib"], r1["peak_mib"]]
        rec["sha256"] = r0["sha"][:12]
        if name in serial:
            same = r0["text"] == serial[name]
            rec["serial_identical"] = same
            if name in DIST_EXACT:
                check(same, "distributed %s: the model differs from the "
                      "serial cut at %s" % (name, first_difference(
                          r0["text"], serial[name])))
        if name in DIST_AUC:
            path, bound = DIST_AUC[name]
            ref = main_cut if path is None else \
                lt.Booster(params={"device_type": "cpu"},
                           model_str=runs[path]["model_text"]) \
                .model_to_string(num_iteration=DIST_ITERS)
            a, b = host_auc(r0["text"], Xv, yv), host_auc(ref, Xv, yv)
            rec["auc"], rec["serial_auc"] = a, b
            check(abs(a - b) <= bound, "distributed %s: held-out AUC "
                  "%.6f vs serial %.6f (bound %g)" % (name, a, b, bound))
        rec["launches"] = n
        out[name] = rec
        launches["distributed " + name] = n
    line = ("distributed: two gloo ranks on cuda:0, the main data's binary "
            "cache (%d iterations, 255 leaves) and %dx%d (%d iterations; "
            "serial run here %.3f s); each rank's model equals rank 0's, "
            "data / feature / voting top_k 20 / wide data byte-identical "
            "to the serial cut; "
            "ranks %.1f s, phase %.1f s (%s): %s"
            % (DIST_ITERS, DIST_WIDE_ROWS, DIST_WIDE_F, DIST_WIDE_ITERS,
               t_wide_serial, t_ranks, time.perf_counter() - t_all, smi,
               json.dumps(out)))
    return line, launches


# ---------------------------------------------------------------------------
# phases: online training and serving (runtime/continuous.py,
# runtime/serving.py, task=train_online / task=serve)
# ---------------------------------------------------------------------------

#: the online trainer's window: the main path's 1,000,000 training rows,
#: written once as a TSV (label first) by a child while the kernel phases
#: run
ONLINE_ROWS = 1_000_000
ONLINE_ROUNDS = 2
ONLINE_CYCLES = 3
#: the gate on (publish_gate_tolerance defaults to inf, which turns it off)
ONLINE_GATE = dict(publish_gate_tolerance=0.05, publish_gate_holdout=0.1)
#: generation 3 against the main path's model at the same iterations
ONLINE_AUC_TOL = 0.01
#: the serve line: client threads, ragged request rows, the stream's rows
SERVE_CLIENTS = 8
SERVE_MAX_REQUEST = 4096
SERVE_STREAM_ROWS = 2_000_000
SERVE_POOL_ROWS = 262_144
#: the stream's share served before the serving-shape model is published
SERVE_SWAP_SHARE = 0.4
#: the manifest's row buckets for the first generation: every bucket a
#: batch of requests up to SERVE_MAX_REQUEST rows can reach (16..8192)
SERVE_BUCKETS = tuple(16 << i for i in range(10))
#: requests the task=serve child answers
CLI_SERVE_REQUESTS = 200
#: the serve fault line's predict deadline and the slow_predict stall
FAULT_DEADLINE_S = 2.0
FAULT_STALL_S = 4.0


def tsv_child(path: str, rows: int, seed: int) -> int:
    """`--tsv-child PATH ROWS SEED`: the main path's first `rows` training
    rows (its generator and seed) written as a label-first TSV, each
    float32 value in '%.9g' (which reads back as the same float32)."""
    t0 = time.perf_counter()
    X, y = synth(rows + 100_000, F, seed)
    fmt = "\t".join(["%.9g"] * (F + 1)) + "\n"
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        for s in range(0, rows, 50_000):
            e = min(s + 50_000, rows)
            block = np.column_stack([y[s:e], X[s:e].astype(np.float64)])
            fh.write((fmt * (e - s)) % tuple(block.ravel().tolist()))
    os.replace(tmp, path)
    print("tsv %.3f s" % (time.perf_counter() - t0), flush=True)
    return 0


def start_tsv_child(work: str, seed: int) -> dict:
    path = os.path.join(work, "online.tsv")
    child = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--tsv-child",
         path, "--rows", str(ONLINE_ROWS), "--seed", str(seed)],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return dict(child=child, path=path, t0=time.perf_counter())


def tsv_done(run: dict) -> tuple:
    """(the TSV's path, the child's own seconds to write it)."""
    rc, out, _ = cli_done(run, timeout=600)
    check(rc == 0 and os.path.exists(run["path"]),
          "online: the TSV child exited %s: %s" % (rc, out[-2000:]))
    return run["path"], float(out.rsplit("tsv ", 1)[1].split()[0])


def online_params(tsv: str, out: str, cycles: int) -> dict:
    return dict(train_params(255), data=tsv, output_model=out,
                publish_dir=out + ".pub", online_window_rows=ONLINE_ROWS,
                online_rounds=ONLINE_ROUNDS, online_cycles=cycles,
                online_interval=0, **ONLINE_GATE)


def published(pub_dir: str) -> dict:
    """{generation: (model text, meta)} of a publish dir."""
    from lightgbm_tpu_torch.runtime import publish
    out = {}
    for gen, path in publish.generation_paths(pub_dir):
        with open(path) as fh:
            out[gen] = publish._split_validate(fh.read())
    return out


def online_phase(tsv: str, t_tsv: float, work: str, main_text: str, Xv,
                 yv, smi: str) -> tuple:
    """`ContinuousTrainer` in this process, alone on the card, with the
    main path's parameters over the 1M x 28 TSV: 3 cycles of 2 rounds, the
    gate on.  Per cycle: the ingest, train and publish seconds from the
    stage trail and B1's and B2's launches (the counts read around each
    cycle).  Held: B1 and B2 launch in every cycle and no wide kernel
    (B3, B7, B8) ever; generations 1-3 carry total_iter 2/4/6; the saved
    model starts with generation 3's text; generation 3's AUC on the main
    path's validation set within ONLINE_AUC_TOL of the main path's model
    at 6 iterations."""
    from lightgbm_tpu_torch.runtime import continuous
    out = os.path.join(work, "online.txt")
    per_cycle = {}

    class Counting(continuous.ContinuousTrainer):
        def _run_cycle(self, cycle, producer, guard):
            before = read_counts()
            super()._run_cycle(cycle, producer, guard)
            after = read_counts()
            per_cycle[cycle] = {k: after[k] - before[k] for k in COUNTED}

    trainer = Counting(online_params(tsv, out, ONLINE_CYCLES))
    trainer.wd.stream = sys.stderr
    reset_counts()
    t0 = time.perf_counter()
    rc = trainer.run()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = read_counts()
    check(rc == 0, "online: the trainer returned %d" % rc)
    gens = published(out + ".pub")
    check(sorted(gens) == [1, 2, 3], "online: generations %s" % sorted(gens))
    iters = {g: gens[g][1]["total_iter"] for g in gens}
    check(iters == {1: 2, 2: 4, 3: 6}, "online: total_iter %s" % iters)
    with open(out) as fh:
        check(fh.read().startswith(gens[3][0]),
              "online: the saved model does not start with generation 3")
    for c in range(1, ONLINE_CYCLES + 1):
        got = per_cycle.get(c, {})
        check(got.get("segment_histogram", 0) > 0
              and got.get("partition_segment", 0) > 0,
              "online: cycle %d launched B1 %s, B2 %s" % (
                  c, got.get("segment_histogram"),
                  got.get("partition_segment")))
    check(not any(launches[k] for k in WIDE_ONLY),
          "online: a wide kernel launched: %s"
          % {k: launches[k] for k in WIDE_ONLY})
    stages = {s["name"]: s for s in trainer.wd.stages}
    rows = []
    for c in range(1, ONLINE_CYCLES + 1):
        st = {k: stages.get("cycle %d: %s" % (c, k), {})
              for k in ("ingest", "train", "gate", "publish")}
        rows.append(dict(
            cycle=c, ingest_s=st["ingest"].get("dur_s"),
            train_s=st["train"].get("dur_s"),
            gate=st["gate"].get("publish_gate", {}).get("verdict"),
            publish_latency_s=st["publish"].get("publish_latency_s"),
            syncs=st["train"].get("syncs"),
            builds=st["train"].get("program_builds"),
            b1=per_cycle[c]["segment_histogram"],
            b2=per_cycle[c]["partition_segment"]))
    check(all(r["gate"] in ("no_incumbent", "pass") for r in rows),
          "online: gate verdicts %s" % [r["gate"] for r in rows])
    first = trainer.wd.stages[0] if trainer.wd.stages else {}
    parse = [s["ingest"] for s in trainer.wd.stages if "ingest" in s]
    auc3 = auc_score(yv, lt.Booster(model_str=gens[3][0]).predict(Xv))
    auc_main = auc_score(yv, lt.Booster(model_str=main_text).predict(
        Xv, num_iteration=ONLINE_ROUNDS * ONLINE_CYCLES))
    check(abs(auc3 - auc_main) <= ONLINE_AUC_TOL,
          "online: generation 3 AUC %.6f vs the main path's %.6f at %d "
          "iterations" % (auc3, auc_main, ONLINE_ROUNDS * ONLINE_CYCLES))
    line = ("online (%s): ContinuousTrainer in this process over the %d x "
            "%d TSV (written by a child in %.2f s), 255 leaves, %d cycles "
            "of %d rounds, online_interval 0, the gate on (tolerance %.2f, "
            "holdout %.2f): %.2f s in all (first stage %s); parse %s; per "
            "cycle %s; launches B1 %d and B2 %d in all (B3/B7/B8 0); "
            "generations 1-3 at total_iter 2/4/6, the saved model starts "
            "with generation 3's text; generation 3 AUC %.6f, the main "
            "path's at %d iterations %.6f (|d| %.6f <= %.2f)"
            % (smi, ONLINE_ROWS, F, t_tsv, ONLINE_CYCLES, ONLINE_ROUNDS,
               ONLINE_GATE["publish_gate_tolerance"],
               ONLINE_GATE["publish_gate_holdout"], t_run,
               first.get("name"), json.dumps(parse[:1]), json.dumps(rows),
               launches["segment_histogram"], launches["partition_segment"],
               auc3, ONLINE_ROUNDS * ONLINE_CYCLES, auc_main,
               abs(auc3 - auc_main), ONLINE_AUC_TOL))
    return line, launches, out + ".pub", gens


def offline(text: str, X, **kw):
    """The offline device predict of a model text (a Booster of its own)."""
    return lt.Booster(model_str=text).predict(X, device=True, **kw)


def serve_phase(pub_dir: str, gens: dict, seed: int, smi: str) -> tuple:
    """A `ServingRuntime` on the card over the online line's publish dir
    (returned running, with the JSON stream's figures, for the wire,
    die_at_ring and loadgen lines),
    its manifest naming SERVE_BUCKETS for generation 3: SERVE_CLIENTS
    client threads send ragged requests of 1..SERVE_MAX_REQUEST rows
    (slices of a seeded pool, about SERVE_STREAM_ROWS rows in all);
    after SERVE_SWAP_SHARE of the stream a host `ModelPublisher`
    publishes the serving-shape model (synth_serving_model, 500 x 255 x
    28) as generation 4.  Held: no drop; every response is generation 3
    or 4, byte for byte the offline device predict of its generation on
    its rows, served by the device; 0 host batches, 0 prewarm failures,
    0 breaker trips; after the prewarm, the captures at the predictor's
    site are generation 4's programs only."""
    import threading
    from lightgbm_tpu_torch.runtime import (graph_obs, publish, serving,
                                            telemetry, warmup)
    text4 = synth_serving_model(SERVE_TREES, SERVE_LEAVES, F, seed) \
        .save_model_to_string()
    pool = np.random.default_rng(seed + 23).standard_normal(
        (SERVE_POOL_ROWS, F)).astype(np.float32)
    pub = publish.ModelPublisher(pub_dir, keep_last=0)
    pub.publish_manifest("serving", warmup.build_serving_section(
        F, list(SERVE_BUCKETS), generation=3))
    hist = telemetry.histogram("lgbm_serve_latency_seconds")
    t0 = time.perf_counter()
    rt = serving.ServingRuntime(
        publish_dir=pub_dir, poll_interval_s=0.02, max_queue=256,
        max_batch_rows=SERVE_MAX_REQUEST, batch_window_s=0.002,
        default_deadline_s=120.0, predict_deadline_s=120.0)
    rt.start()
    t_start = time.perf_counter() - t0
    prewarm = rt.prewarm_events[0] if rt.prewarm_events else {}
    check(prewarm.get("outcome") == "manifest_ok"
          and prewarm.get("buckets") == list(SERVE_BUCKETS),
          "serve: the manifest prewarm %s" % prewarm)
    entry3 = rt._entries["default"]
    check(entry3.generation == 3, "serve: started at generation %d"
          % entry3.generation)
    caps3 = entry3.booster._dev_predictor.capture_count()
    caps0 = graph_obs.total_compiles(warmup.PREDICT_SITE)
    st0 = rt.stats()
    h0 = hist.state()
    per_client = SERVE_STREAM_ROWS // SERVE_CLIENTS
    swap_at = int(SERVE_STREAM_ROWS * SERVE_SWAP_SHARE)
    lock = threading.Lock()
    shared = {"rows": 0, "published": None, "seen4": None}
    results = [[] for _ in range(SERVE_CLIENTS)]
    errors = []

    def client(i):
        rng = np.random.default_rng(seed + 31 + i)
        sent = 0
        while sent < per_client:
            n = int(rng.integers(1, SERVE_MAX_REQUEST + 1))
            s = int(rng.integers(0, SERVE_POOL_ROWS - n + 1))
            try:
                rec = rt.submit(pool[s:s + n]).wait(timeout=300)
            except BaseException as e:       # noqa: BLE001 — a drop
                errors.append("%s: %s" % (type(e).__name__, e))
                return
            results[i].append((s, n, rec.generation, rec.served_by,
                               rec.values))
            sent += n
            with lock:
                shared["rows"] += n
                publish_now = (shared["published"] is None
                               and shared["rows"] >= swap_at)
                if publish_now:
                    shared["published"] = time.perf_counter()
                if rec.generation == 4 and shared["seen4"] is None:
                    shared["seen4"] = time.perf_counter()
            if publish_now:
                pub.publish(text4, meta={"cycle": 4})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    t_stream = time.perf_counter() - t0
    h1 = hist.state()
    st = rt.stats()
    entry4 = rt._entries["default"]
    caps_new = graph_obs.total_compiles(warmup.PREDICT_SITE) - caps0
    caps4 = entry4.booster._dev_predictor.capture_count() \
        if entry4.generation == 4 else None
    caps3_after = entry3.booster._dev_predictor.capture_count()
    swap_events = [s["last_swap"] for s in rt.wd.stages
                   if isinstance(s.get("last_swap"), dict)
                   and s["last_swap"].get("generation") == 4]
    check(not errors, "serve: %d requests dropped: %s"
          % (len(errors), errors[:3]))
    check(entry4.generation == 4, "serve: never swapped to generation 4")
    check(st["batches_host"] == st0["batches_host"] == 0
          and st["prewarm_failures"] == 0 and st["degradations"] == 0,
          "serve: host batches %d, prewarm failures %d, breaker trips %d"
          % (st["batches_host"], st["prewarm_failures"],
             st["degradations"]))
    check(caps3_after == caps3, "serve: generation 3 captured %d programs "
          "after its prewarm" % (caps3_after - caps3))
    check(caps_new == caps4, "serve: %d captures at %s after the prewarm, "
          "generation 4's programs %s" % (caps_new, warmup.PREDICT_SITE,
                                          caps4))
    want = {3: offline(gens[3][0], pool), 4: offline(text4, pool)}
    n_req = n_rows = 0
    by_gen = {3: 0, 4: 0}
    for res in results:
        for s, n, gen, by, values in res:
            check(gen in want, "serve: a response names generation %s"
                  % gen)
            check(by == "device", "serve: a response served by %s" % by)
            check(np.array_equal(values, want[gen][s:s + n]),
                  "serve: a %d-row response of generation %d is not the "
                  "offline device predict of its rows" % (n, gen))
            n_req += 1
            n_rows += n
            by_gen[gen] += 1
    check(by_gen[3] and by_gen[4], "serve: responses by generation %s"
          % by_gen)
    dh = telemetry.state_delta(h1, h0)
    p50 = telemetry.quantile_from_state(dh, 0.5)
    p99 = telemetry.quantile_from_state(dh, 0.99)
    batches = st["batches_device"] - st0["batches_device"]
    swap_s = (shared["seen4"] - shared["published"]) \
        if shared["seen4"] and shared["published"] else None
    line = ("serve (%s): ServingRuntime on the card over the online "
            "publish dir (start %.3f s with the manifest prewarm of "
            "buckets %s), %d client threads, %d ragged requests of 1..%d "
            "rows (%d rows) in %.3f s: %.1f requests/s, %.1f rows/s; "
            "latency p50 %.6f s p99 %.6f s (lgbm_serve_latency_seconds); "
            "%d device batches, %.1f rows a batch, 0 host; generation 4 "
            "(%d x %d x %d) published after %d rows, first answered %.3f "
            "s later (load + prewarm %s); responses by generation %s, "
            "every one the offline device predict of its generation byte "
            "for byte; captures after the prewarm %d, all generation 4's"
            % (smi, t_start, list(SERVE_BUCKETS), SERVE_CLIENTS, n_req,
               SERVE_MAX_REQUEST, n_rows, t_stream, n_req / t_stream,
               n_rows / t_stream, p50 or -1.0, p99 or -1.0, batches,
               n_rows / max(batches, 1), SERVE_TREES, SERVE_LEAVES, F,
               swap_at, swap_s if swap_s is not None else -1.0,
               json.dumps([{k: e.get(k) for k in ("load_s",
                                                  "prewarm_compiles")}
                           for e in swap_events]), by_gen, caps_new))
    figures = {"requests/s": n_req / t_stream, "rows/s": n_rows / t_stream,
               "p50_s": p50, "p99_s": p99}
    return line, text4, pool, want, rt, figures


def serve_fault_phase(pub_dir: str, text4: str, pool, smi: str) -> str:
    """`die_at_predict` on one batch and `slow_predict` past the predict
    deadline on another, on a raw-score runtime over the publish dir:
    exactly those two batches are host-served, within 1e-5 of the
    device's raw score; each trips the breaker once and recovers once
    (a probe after the cooldown, once the abandoned call has left the
    predictor); every other response is the device's, byte for byte."""
    from lightgbm_tpu_torch.runtime import resilience, serving
    rows = 1000
    X = pool[:8 * rows]
    raw = offline(text4, X, raw_score=True)
    # no manifest prewarm or export: one bucket (1024 rows) serves it
    rt = serving.ServingRuntime(
        publish_dir=pub_dir, raw_score=True, batch_window_s=0.0,
        predict_deadline_s=FAULT_DEADLINE_S, breaker_cooldown_s=0.2,
        default_deadline_s=120.0, prewarm_manifest=False,
        export_manifest=False)
    rt.start()
    served = []

    def ask(k):
        rec = rt.submit(X[k * rows:(k + 1) * rows]).wait(timeout=300)
        want = raw[k * rows:(k + 1) * rows]
        if rec.served_by == "device":
            check(np.array_equal(rec.values, want),
                  "serve fault: device batch %d is not the offline "
                  "predict" % k)
            err = 0.0
        else:
            err = float(np.abs(rec.values - want).max())
            check(err <= 1e-5, "serve fault: host batch %d max |d| %.3g"
                  % (k, err))
        served.append((k, rec.served_by, err))
        return rec

    def recovered():
        end = time.monotonic() + 60
        while time.monotonic() < end:
            st = rt.stats()
            if st["abandoned_running"] == 0 \
                    and time.monotonic() > st["breaker"]["open_until"]:
                return
            time.sleep(0.01)
        raise SmokeFailure("serve fault: the abandoned call never ended")

    ask(0)
    counters = []
    t = {}
    for name, spec in (("die_at_predict", "die_at_predict:%d"
                        % (resilience._PREDICT_FAULT["batches"] + 1)),
                       ("slow_predict", "slow_predict:%g" % FAULT_STALL_S)):
        st0 = rt.stats()
        os.environ["LGBM_TPU_FAULT"] = spec
        t0 = time.perf_counter()
        try:
            ask(1 if name == "die_at_predict" else 4)
        finally:
            os.environ.pop("LGBM_TPU_FAULT", None)
        t[name] = time.perf_counter() - t0
        recovered()
        ask(2 if name == "die_at_predict" else 5)
        ask(3 if name == "die_at_predict" else 6)
        st1 = rt.stats()
        counters.append({k: st1[k] - st0[k] for k in (
            "degradations", "recoveries", "batches_host", "abandoned")})
    ask(7)
    rt.stop()
    host = [k for k, by, _ in served if by == "host"]
    check(host == [1, 4], "serve fault: host-served batches %s, not [1, 4]"
          % host)
    for name, c in zip(("die_at_predict", "slow_predict"), counters):
        check(c["degradations"] == 1 and c["recoveries"] == 1,
              "serve fault: %s tripped %d, recovered %d" % (
                  name, c["degradations"], c["recoveries"]))
    return ("serve fault (%s): raw-score runtime, %d-row batches, predict "
            "deadline %.1f s: die_at_predict served batch 1 from the host "
            "(max |d| %.3g against the device's raw score, %.3f s), "
            "slow_predict:%g past the deadline batch 4 (max |d| %.3g, "
            "answered in %.3f s); counters per fault %s; batches by path "
            "%s; every later response the device's byte for byte"
            % (smi, rows, FAULT_DEADLINE_S, served[1][2],
               t["die_at_predict"], FAULT_STALL_S, served[4][2],
               t["slow_predict"], json.dumps(counters),
               [by for _, by, _ in served]))


#: the wire line: rows each plane carries (the serve line's seeded slices)
WIRE_PLANE_ROWS = 500_000
#: the loadgen line: seconds of open-loop arrivals at LOADGEN_RPS, the
#: verifier's probe rows (its host reference runs over them)
LOADGEN_S, LOADGEN_RPS, LOADGEN_PROBE_ROWS = 3.0, 200.0, 4096
#: the fleet line: replicas, requests over each transport
FLEET_REPLICAS, FLEET_REQUESTS = 2, 200
#: die_at_ring: the request frame in flight at which the ring client dies
RING_DIE_AT = 6

RING_CHILD = """
import sys
import numpy as np
from lightgbm_tpu_torch.runtime import shm_ring
c = shm_ring.ShmClient(sys.argv[1], resp_capacity=shm_ring.MIN_CAPACITY)
X = np.ones((160, int(sys.argv[2])), np.float32)
for _ in range(8):
    assert c.submit_nowait(X) is None
print("the fault never fired", file=sys.stderr)
sys.exit(3)
"""


def ring_maps() -> int:
    """Shared-memory ring segments mapped in this process."""
    with open("/proc/self/maps") as fh:
        return fh.read().count("lgbm-shm-ring")


def plane_stream(make_client, pool, want4, seed: int, rows: int) -> dict:
    """SERVE_CLIENTS threads, each with its own client from
    `make_client()`, send the serve line's seeded slices of the pool (the
    same generators) until `rows` rows in all; every answer must be
    generation 4 from the device, byte for byte the offline device
    predict of its rows as float32.  Returns the plane's figures: client
    round trips and the server's latency histogram over the plane."""
    import threading
    from lightgbm_tpu_torch.runtime import telemetry
    hist = telemetry.histogram("lgbm_serve_latency_seconds")
    per_client = rows // SERVE_CLIENTS
    lat = [[] for _ in range(SERVE_CLIENTS)]
    sent = [0] * SERVE_CLIENTS
    errors = []

    def client(i):
        rng = np.random.default_rng(seed + 31 + i)
        try:
            with make_client() as c:
                while sent[i] < per_client:
                    n = int(rng.integers(1, SERVE_MAX_REQUEST + 1))
                    s = int(rng.integers(0, SERVE_POOL_ROWS - n + 1))
                    t0 = time.perf_counter()
                    out = c.request_once(pool[s:s + n])
                    lat[i].append(time.perf_counter() - t0)
                    if "error" in out:
                        errors.append("rejected %s" % out)
                        return
                    if out["generation"] != 4 \
                            or out["served_by"] != "device" \
                            or not np.array_equal(out["values"][:, 0],
                                                  want4[s:s + n]):
                        errors.append("a %d-row answer (generation %s, %s) "
                                      "is not the offline device predict"
                                      % (n, out["generation"],
                                         out["served_by"]))
                        return
                    sent[i] += n
        except BaseException as e:       # noqa: BLE001 — a failed plane
            errors.append("%s: %s" % (type(e).__name__, e))

    h0 = hist.state()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    secs = time.perf_counter() - t0
    check(not errors, "wire: %d failed requests: %s" % (len(errors),
                                                          errors[:3]))
    dh = telemetry.state_delta(hist.state(), h0)
    rt_s = np.concatenate([np.asarray(x) for x in lat])
    return {"requests": int(rt_s.size), "rows": int(sum(sent)),
            "s": round(secs, 4), "requests/s": round(rt_s.size / secs, 1),
            "rows/s": round(sum(sent) / secs, 1),
            "p50_s": telemetry.quantile_from_state(dh, 0.5),
            "p99_s": telemetry.quantile_from_state(dh, 0.99),
            "client_p50_s": round(float(np.percentile(rt_s, 50)), 6),
            "client_p99_s": round(float(np.percentile(rt_s, 99)), 6)}


def torn_frames(port: int) -> dict:
    """Two torn-frame classes on one TCP connection each: a bad CRC is
    rejected and the connection answers the next frame; a bad magic is
    rejected and the connection closes."""
    import socket
    from lightgbm_tpu_torch.runtime import wire
    out = {}
    X = np.ones((2, F), np.float32)
    with socket.create_connection(("127.0.0.1", port), timeout=60) as sk:
        rf = sk.makefile("rb")
        bad = bytearray(wire.pack_request(X))
        bad[-1] ^= 0xFF
        sk.sendall(bytes(bad))
        rej = wire.unpack_response(*wire.read_frame(rf))
        sk.sendall(wire.pack_request(X))
        ok = wire.unpack_response(*wire.read_frame(rf))
        check(rej.get("reason") == "bad_crc" and rej.get("retryable")
              and "values" in ok, "wire: bad CRC answered %s, then %s"
              % (rej, {k: ok.get(k) for k in ("error", "reason")}))
        out["bad_crc"] = "rejected, connection kept"
    with socket.create_connection(("127.0.0.1", port), timeout=60) as sk:
        rf = sk.makefile("rb")
        sk.sendall(b"GET / HTTP/1.1\r\n" + b"\0" * 64)
        rej = wire.unpack_response(*wire.read_frame(rf))
        check(rej.get("reason") == "bad_magic" and rf.read(1) == b"",
              "wire: bad magic answered %s and left the connection open"
              % rej)
        out["bad_magic"] = "rejected, connection closed"
    return out


def wire_phase(rt, pool, want4: np.ndarray, seed: int, work: str,
               json_figs: dict, smi: str) -> tuple:
    """The serve line's runtime behind a `WireTCPServer` and a
    `WireUnixServer`, generation 4 first prewarmed for SERVE_BUCKETS
    through the runtime's manifest prewarm: SERVE_CLIENTS clients send
    the serve line's seeded slices, about WIRE_PLANE_ROWS rows a plane,
    over TCP, over the Unix socket and over the shared-memory ring.
    Held: every answer is the JSON path's (the offline device predict of
    generation 4) byte for byte as float32; 0 host batches; 0 captures at the
    predictor's site after readiness; a bad CRC is rejected and keeps
    the connection, a bad magic closes it.  Starts the die_at_ring child
    on the Unix server; returns (line, servers, the child)."""
    import threading
    from lightgbm_tpu_torch.runtime import graph_obs, shm_ring, warmup, wire
    srv = wire.WireTCPServer(rt, port=0)
    uds = os.path.join(work, "wire.sock")
    usrv = wire.WireUnixServer(rt, uds)
    for sv in (srv, usrv):
        threading.Thread(target=sv.serve_forever,
                         kwargs={"poll_interval": 0.2}, daemon=True).start()
    # the wire carries float32: the JSON path's values in the server's
    # own cast
    want32 = want4.astype(np.float32)
    # readiness: generation 4's programs for every bucket a batch can
    # reach, through the runtime's own manifest prewarm (what a start on
    # generation 4 does); the stream captured only the buckets it hit
    caps0 = graph_obs.total_compiles(warmup.PREDICT_SITE)
    t0 = time.perf_counter()
    warmed = rt._prewarm_buckets(rt._entries["default"], list(SERVE_BUCKETS))
    t_warm = time.perf_counter() - t0
    check(warmed == list(SERVE_BUCKETS), "wire: prewarmed %s" % warmed)
    warm_caps = graph_obs.total_compiles(warmup.PREDICT_SITE) - caps0
    st0 = rt.stats()
    caps0 = graph_obs.total_compiles(warmup.PREDICT_SITE)
    planes = {}
    for name, make in (
            ("tcp", lambda: wire.WireClient(("127.0.0.1", srv.port),
                                            timeout=300)),
            ("uds", lambda: wire.WireClient(uds, timeout=300)),
            ("shm", lambda: shm_ring.ShmClient(uds, timeout=300))):
        planes[name] = plane_stream(make, pool, want32, seed,
                                    WIRE_PLANE_ROWS)
    st = rt.stats()
    caps = graph_obs.total_compiles(warmup.PREDICT_SITE) - caps0
    check(st["batches_host"] == 0 and st["degradations"] == 0,
          "wire: host batches %d, breaker trips %d"
          % (st["batches_host"], st["degradations"]))
    check(caps == 0, "wire: %d captures at %s after readiness"
          % (caps, warmup.PREDICT_SITE))
    # the ring client that dies with frames in flight: started now, its
    # start-up overlaps the torn frames and the loadgen line
    ring = dict(before=shm_ring.stats_snapshot(), maps=ring_maps(),
                child=subprocess.Popen(
                    [sys.executable, "-c", RING_CHILD, uds, str(F)],
                    cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE,
                                       LGBM_TPU_FAULT="die_at_ring:%d"
                                       % RING_DIE_AT),
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True), uds=uds)
    torn = torn_frames(srv.port)
    line = ("wire (%s): the serve line's runtime (generation 4 prewarmed "
            "for buckets %s: %d captures, %.3f s) behind WireTCPServer and "
            "WireUnixServer, %d client threads per plane sending the serve "
            "line's seeded slices (1..%d rows): %s; the JSON stream of the "
            "same call: %s; every answer generation 4 from the device, the "
            "JSON path's values byte for byte as float32; host batches 0, "
            "captures after readiness %d (%d device batches in the three "
            "planes); torn frames %s"
            % (smi, list(SERVE_BUCKETS), warm_caps, t_warm, SERVE_CLIENTS,
               SERVE_MAX_REQUEST, json.dumps(planes),
               json.dumps(json_figs), caps,
               st["batches_device"] - st0["batches_device"],
               json.dumps(torn)))
    return line, (srv, usrv), ring


def die_at_ring_done(rt, ring: dict, pool, want4: np.ndarray,
                     smi: str) -> str:
    """The die_at_ring child's end: exit 137 with RING_DIE_AT frames in
    flight; the server reclaims its session (counted `reclaimed`, none
    torn) and unmaps the segment (0 mappings left); a fresh ring client
    on the same runtime is answered byte for byte."""
    from lightgbm_tpu_torch.runtime import shm_ring
    child = ring["child"]
    try:
        _, err = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    check(child.returncode == 137 and "FAULT die_at_ring" in err,
          "die_at_ring: the ring child exited %s: %s"
          % (child.returncode, err[-2000:]))
    before = ring["before"]
    # the planes' own sessions may still be closing: wait for this one
    ended = lambda s: s["reclaimed"] + s["torn"]  # noqa: E731
    t0 = time.perf_counter()
    while ended(shm_ring.stats_snapshot()) <= ended(before) \
            and time.perf_counter() - t0 < 60:
        time.sleep(0.02)
    after = shm_ring.stats_snapshot()
    while ring_maps() > ring["maps"] and time.perf_counter() - t0 < 60:
        time.sleep(0.05)
    t_reclaim = time.perf_counter() - t0
    check(after["reclaimed"] == before["reclaimed"] + 1
          and after["torn"] == before["torn"],
          "die_at_ring: sessions %s, before %s" % (after, before))
    check(ring_maps() == ring["maps"], "die_at_ring: %d ring mappings "
          "leaked" % (ring_maps() - ring["maps"]))
    n = min(1000, SERVE_MAX_REQUEST)
    with shm_ring.ShmClient(ring["uds"], timeout=300) as c:
        out = c.request_once(pool[:n])
    check("error" not in out and out["served_by"] == "device"
          and np.array_equal(out["values"][:, 0],
                             want4[:n].astype(np.float32)),
          "die_at_ring: the runtime's next ring answer %s"
          % {k: out.get(k) for k in ("error", "reason", "served_by")})
    st = rt.stats()
    check(st["batches_host"] == 0, "die_at_ring: %d host batches"
          % st["batches_host"])
    return ("die_at_ring (%s): a ring client on the wire runtime's Unix "
            "socket killed with %d request frames in flight "
            "(LGBM_TPU_FAULT=die_at_ring:%d, exit 137); the session "
            "reclaimed %.3f s after the child's end (sessions %s), ring "
            "mappings %d before and after, none leaked; a fresh ring "
            "client then answered byte for byte from the device"
            % (smi, RING_DIE_AT, RING_DIE_AT, t_reclaim,
               json.dumps({k: after[k] - before[k] for k in (
                   "reclaimed", "torn")}),
               ring["maps"]))


def loadgen_phase(rt, text4: str, pool, seed: int, smi: str) -> str:
    """`LoadGenerator` against the serve line's runtime: LOADGEN_S s of
    open-loop Poisson arrivals at LOADGEN_RPS requests/s, two
    RequestClasses (priority 0 with 1-row requests, priority 2 with
    SERVE_MAX_REQUEST-row ones) over the first LOADGEN_PROBE_ROWS rows of
    the pool, every answer checked by `ResponseVerifier` against the
    offline predictor of its generation.  Held: 0 mismatches (and no
    wrong generation, unverifiable answer or hard error); offered =
    verified + shed; the arrivals are poisson_arrivals of the shape,
    duration and seed; 0 host batches."""
    from lightgbm_tpu_torch.runtime.loadgen import (LoadGenerator,
                                                    RequestClass,
                                                    ResponseVerifier,
                                                    TrafficShape,
                                                    poisson_arrivals)
    probe = pool[:LOADGEN_PROBE_ROWS].astype(np.float64)
    shape = TrafficShape.step([(LOADGEN_S, LOADGEN_RPS)])
    verifier = ResponseVerifier(probe, texts={4: text4})
    t0 = time.perf_counter()
    verifier.refs(4)
    t_refs = time.perf_counter() - t0
    st0 = rt.stats()
    gen = LoadGenerator(
        rt, [RequestClass("p0", 0, weight=3.0, rows=1),
             RequestClass("p2", 2, weight=1.0, rows=SERVE_MAX_REQUEST)],
        shape, LOADGEN_S, probe, seed=seed + 51, verifier=verifier,
        deadline_s=120.0)
    t0 = time.perf_counter()
    led = gen.run()
    t_run = time.perf_counter() - t0
    st = rt.stats()
    ver = led["verification"]
    offered = led["offered_total"]
    shed = sum(c["shed"] for c in led["classes"].values())
    check(np.array_equal(gen.arrivals, poisson_arrivals(
        shape, LOADGEN_S, seed + 51)) and offered == len(gen.arrivals),
        "loadgen: the arrivals are not poisson_arrivals of the seed")
    check(ver.get("mismatch", 0) == 0 and ver.get("wrong_generation", 0)
          == 0 and ver.get("unverifiable", 0) == 0 and not
          led["hard_errors"] and led["non_machine_readable_rejections"]
          == 0, "loadgen: verification %s, errors %s" % (
              ver, led["hard_errors"]))
    check(offered == ver.get("ok", 0) + shed,
          "loadgen: offered %d, verified %d, shed %d"
          % (offered, ver.get("ok", 0), shed))
    check(st["batches_host"] == st0["batches_host"] == 0,
          "loadgen: %d host batches" % st["batches_host"])
    return ("loadgen (%s): LoadGenerator on the serve line's runtime, "
            "%.1f s of open-loop Poisson arrivals at %g requests/s (seed "
            "%d, the arrivals poisson_arrivals' array), classes p0 (1 "
            "row, weight 3) and p2 (%d rows, weight 1) over %d probe rows: "
            "%.3f s; offered %d = verified %d + shed %d; verification %s; "
            "max lag %.4f s; served by %s; classes %s; the verifier's "
            "references (host f64 and device over the probe) %.3f s"
            % (smi, LOADGEN_S, LOADGEN_RPS, seed + 51, SERVE_MAX_REQUEST,
               LOADGEN_PROBE_ROWS, t_run, offered, ver.get("ok", 0), shed,
               json.dumps(ver), led["max_lag_s"],
               json.dumps(led["served_by"]),
               json.dumps({k: {kk: v[kk] for kk in ("offered", "completed",
                                                    "shed")}
                           for k, v in led["classes"].items()}), t_refs))


def start_fleet(pub_dir: str) -> dict:
    """A `FleetController` of FLEET_REPLICAS replicas on the card over the
    online line's publish dir, with die_at_spawn:2 in their environment:
    spawns 1 and 2 start now (the second dies after its prewarm, before
    it is ready, and the controller relaunches it as spawn 3)."""
    import tempfile
    from lightgbm_tpu_torch.runtime.fleet import FleetController
    from lightgbm_tpu_torch.runtime.policy import FleetScalePolicy
    fleet_dir = tempfile.mkdtemp(prefix="lgbm_fleet_")
    check(len(os.path.join(fleet_dir, "replica-001.sock")) < 100,
          "fleet: %s is too long a directory for a Unix socket" % fleet_dir)
    spec = {"models": {"default": pub_dir}, "response_dtype": "float32",
            "max_queue": 256, "max_batch_rows": SERVE_MAX_REQUEST,
            "batch_window_s": 0.002, "shed_policy": False,
            "default_deadline_s": 120.0, "predict_deadline_s": 120.0}
    pol = FleetScalePolicy(min_replicas=FLEET_REPLICAS,
                           max_replicas=FLEET_REPLICAS, slo_p99_s=60.0,
                           high_watermark=0.99, low_watermark=0.0,
                           patience=10 ** 6, scale_down_patience=10 ** 6,
                           interval_s=0.5)
    ctl = FleetController(fleet_dir, spec, policy=pol, interval_s=0.5,
                          spawn_grace_s=600.0, drain_grace_s=60.0,
                          env={"LGBM_TPU_FAULT": "die_at_spawn:2"})
    t0 = time.perf_counter()
    ctl.start()
    return dict(ctl=ctl, dir=fleet_dir, t0=t0)


def fleet_done(run: dict, pool, want4: np.ndarray, seed: int,
               smi: str) -> str:
    """The fleet's end: both replicas ready (spawns 1 and 3; spawn 2 died
    with 137 before it was ready); FLEET_REQUESTS requests of 1..
    SERVE_MAX_REQUEST rows through a `FleetClient` on the wire and as
    many through one on the shared-memory ring, each answer generation 4
    from the device, the offline device predict of its rows byte for
    byte (a retryable `ring_full` from a ring still holding the last
    frame is retried and counted); then a graceful stop: each live
    replica exits 0 having built or loaded no kernel.  Prints each replica's spawn-to-ready seconds
    and peak device MiB (its endpoint file, after its drain)."""
    import shutil
    from lightgbm_tpu_torch.runtime.fleet import FleetClient
    from lightgbm_tpu_torch.runtime.serving import ServeRejected
    ctl = run["ctl"]
    try:
        ctl.wait_ready(FLEET_REPLICAS, timeout=600)
        t_ready = time.perf_counter() - run["t0"]
        check(sorted(h.ordinal for h in ctl.replicas) == [1, 3],
              "fleet: ready spawns %s"
              % sorted(h.ordinal for h in ctl.replicas))
        want32 = want4.astype(np.float32)
        figs = {}
        for kind, shm in (("wire", False), ("shm", True)):
            rng = np.random.default_rng(seed + 61 + shm)
            cli = FleetClient(ctl, workers=SERVE_CLIENTS,
                              predict_deadline_s=120.0,
                              request_timeout_s=300.0, prefer_shm=shm)
            try:
                reqs = []
                for _ in range(FLEET_REQUESTS):
                    n = int(rng.integers(1, SERVE_MAX_REQUEST + 1))
                    s = int(rng.integers(0, SERVE_POOL_ROWS - n + 1))
                    reqs.append((s, n))
                t0 = time.perf_counter()
                futs = [(cli.submit(pool[s:s + n]), s, n) for s, n in reqs]
                retried = 0
                for fut, s, n in futs:
                    while True:
                        try:
                            rec = fut.wait(timeout=300)
                            break
                        except ServeRejected as e:
                            # the ring's typed backpressure: a replica
                            # frees a request frame's bytes just after it
                            # publishes the answer, so a large frame sent
                            # at once can find the ring full; retried as
                            # its hint asks, never a drop
                            check(e.reason == "ring_full" and e.retryable
                                  and retried < FLEET_REQUESTS,
                                  "fleet: a %s request rejected: %s"
                                  % (kind, e))
                            retried += 1
                            time.sleep(e.retry_after_s or 0.002)
                            fut = cli.submit(pool[s:s + n])
                    check(rec.generation == 4 and rec.served_by == "device"
                          and np.array_equal(rec.values, want32[s:s + n]),
                          "fleet: a %d-row %s answer (generation %s, %s) is "
                          "not the offline device predict" % (
                              n, kind, rec.generation, rec.served_by))
                secs = time.perf_counter() - t0
                check(cli.transports[kind] == FLEET_REQUESTS,
                      "fleet: transports %s" % cli.transports)
                figs[kind] = {"s": round(secs, 4), "rows": sum(
                    n for _, n in reqs), "requests/s": round(
                    FLEET_REQUESTS / secs, 1), "ring_full_retried": retried}
            finally:
                cli.close()
    finally:
        rep = ctl.stop()
    live = sorted((h for h in ctl.retired if h.ordinal in (1, 3)),
                  key=lambda h: h.ordinal)
    codes = {h.ordinal: h.proc.returncode for h in ctl.retired}
    check(codes.get(1) == 0 and codes.get(3) == 0 and codes.get(2) == 137,
          "fleet: replica exit codes by spawn %s" % codes)
    replicas = []
    ready = {e["replica"]: e["spawn_to_ready_s"] for e in rep["events"]
             if e["action"] == "ready"}
    for h in live:
        with open(h.endpoint_path) as fh:
            ep = json.load(fh)
        check(ep.get("drained") and ep["kernel_builds"] == 0
              and ep["peak_device_bytes"], "fleet: %s endpoint %s"
              % (h.name, ep))
        replicas.append({"replica": h.name,
                         "spawn_to_ready_s": ready.get(h.name),
                         "peak_device_mib": round(
                             (ep["peak_device_bytes"] or 0) / 2 ** 20, 1),
                         "kernel_builds": ep["kernel_builds"]})
    shutil.rmtree(run["dir"], ignore_errors=True)
    return ("fleet (%s): FleetController of %d replicas on the card "
            "(python -m lightgbm_tpu_torch.runtime.fleet, spawned when the "
            "CLI children started) over the online publish dir, "
            "LGBM_TPU_FAULT=die_at_spawn:2: spawn 2 died before it was ready "
            "(137), spawn 3 took its place; both ready %.1f s after the "
            "start; replicas %s; %d requests of 1..%d rows on each "
            "transport, every one generation 4 from the device, the offline "
            "device predict byte for byte: %s; graceful stop, live replicas "
            "exit 0, events %s"
            % (smi, FLEET_REPLICAS, t_ready, json.dumps(replicas),
               FLEET_REQUESTS, SERVE_MAX_REQUEST, json.dumps(figs),
               [e["action"] for e in rep["events"]]))


def start_cli_online(tsv: str, work: str, profile_dir: str) -> dict:
    """task=train_online as a child: 2 cycles with the online line's
    parameters into a fresh publish dir, its 4 iterations profiled
    (LGBM_TPU_PROFILE) for B1's and B2's launches."""
    out = os.path.join(work, "cli_online.txt")
    params = online_params(tsv, out, 2)
    return dict(start_cli(["task=train_online"] + cli_args(params),
                          LGBM_TPU_PROFILE=profile_dir,
                          LGBM_TPU_PROFILE_ITERS=str(2 * ONLINE_ROUNDS)),
                out=out, profile=profile_dir)


def start_cli_serve(pub_dir: str) -> dict:
    """task=serve on the card as a child over the online publish dir."""
    run = start_cli(["task=serve", "publish_dir=" + pub_dir,
                     "serve_port=0"])
    head = []
    for text in run["child"].stdout:
        head.append(text)
        if text.startswith("serving ") or len(head) > 200:
            break
    check(head and head[-1].startswith("serving "),
          "cli serve: no contract line: %s" % "".join(head)[-2000:])
    run["port"] = int(head[-1].rsplit(":", 1)[1])
    return run


def cli_serve_done(run: dict, pool, want: dict, seed: int) -> tuple:
    """CLI_SERVE_REQUESTS JSON-lines requests over TCP, each the offline
    predict of its generation; then SIGTERM: exit 0, 0 host batches."""
    import signal
    import socket
    rng = np.random.default_rng(seed + 41)
    gens = set()
    t0 = time.perf_counter()
    with socket.create_connection(("127.0.0.1", run["port"]),
                                  timeout=120) as sk:
        fh = sk.makefile("rw")
        for _ in range(CLI_SERVE_REQUESTS):
            n = int(rng.integers(1, 65))
            s = int(rng.integers(0, len(pool) - n))
            fh.write(json.dumps({"features": pool[s:s + n].astype(
                np.float64).tolist()}) + "\n")
            fh.flush()
            resp = json.loads(fh.readline())
            gen = resp.get("generation")
            check(gen in want and resp.get("served_by") == "device",
                  "cli serve: response %s" % str(resp)[:300])
            check(np.array_equal(np.asarray(resp["values"]),
                                 want[gen][s:s + n]),
                  "cli serve: a response differs from the offline predict")
            gens.add(gen)
    t_req = time.perf_counter() - t0
    run["child"].send_signal(signal.SIGTERM)
    rc, out, secs = cli_done(run, timeout=120)
    check(rc == 0, "cli serve: SIGTERM exit %s: %s" % (rc, out[-2000:]))
    stats = json.loads(out.split("serve: final stats: ")[1].splitlines()[0])
    check(stats["batches_host"] == 0 and stats["completed"]
          == CLI_SERVE_REQUESTS, "cli serve: final stats host %s, "
          "completed %s" % (stats["batches_host"], stats["completed"]))
    return ("task=serve child: %d JSON-lines requests in %.3f s, "
            "generations %s, each the offline predict byte for byte; "
            "SIGTERM drained it to exit 0 (%.1f s of child), final stats "
            "%d completed, %d host batches"
            % (CLI_SERVE_REQUESTS, t_req, sorted(gens), secs,
               stats["completed"], stats["batches_host"]))


def cli_online_done(run: dict, gens: dict) -> tuple:
    """The task=train_online child's end: exit 0, generation 2's model
    text the online line's generation 2 byte for byte; B1's and B2's
    launches from its trace."""
    rc, out, secs = cli_done(run, timeout=900)
    check(rc == 0, "cli online: exit %s: %s" % (rc, out[-2000:]))
    mine = published(run["out"] + ".pub")
    check(sorted(mine) == [1, 2], "cli online: generations %s"
          % sorted(mine))
    check(mine[2][0] == gens[2][0], "cli online: generation 2 differs from "
          "the online line's at %s" % first_difference(mine[2][0],
                                                       gens[2][0]))
    traces = [os.path.join(dp, f) for dp, _, fs in os.walk(run["profile"])
              for f in fs if f.endswith(".json")]
    check(len(traces) == 1, "cli online: traces %s" % traces)
    kernels = profiled_kernels(traces[0])
    found = {b: sum(n for k, n in kernels.items() if name in k)
             for b, name in PROFILE_KERNELS.items()}
    check(all(found.values()), "cli online: the trace lacks %s" % found)
    counts = {"segment_histogram": found["B1"],
              "partition_segment": found["B2"]}
    return ("task=train_online child: 2 cycles of %d rounds in %.1f s of "
            "child, generation 2 the online line's byte for byte (sha256 "
            "%s); its %d iterations' trace: B1 %d, B2 %d launches"
            % (ONLINE_ROUNDS, secs, sha(mine[2][0]), 2 * ONLINE_ROUNDS,
               found["B1"], found["B2"])), counts


def serving_online_phases(tsv_run: dict, main_text: str, data, seed: int,
                          smi: str) -> dict:
    """The lines `online`, `serve`, `wire`, `loadgen`, `die_at_ring`,
    `serve fault`, `cli serve` / `cli online` and `fleet`, in that order:
    the in-process trainer alone on the card, then the serving runtime
    alone (its JSON stream, then its binary planes, the load generator
    and the dying ring client), then the fault runtime while the two CLI
    children and the fleet's replicas start.  Returns the launch counts
    by path (the serving lines launch none of B1-B8: the device
    predictor needs none)."""
    import tempfile
    t_phase = time.perf_counter()
    work = os.path.dirname(tsv_run["path"])
    tsv, t_tsv = tsv_done(tsv_run)
    line, launches, pub_dir, gens = online_phase(
        tsv, t_tsv, work, main_text, data[1], data[2], smi)
    say(line)
    line, text4, pool, want, rt, json_figs = serve_phase(pub_dir, gens, seed,
                                                         smi)
    say(line)
    served = {}

    def counted(path, fn, *args):
        c0 = read_counts()
        out = fn(*args)
        c1 = read_counts()
        served[path] = {k: c1[k] - c0[k] for k in COUNTED}
        check(not any(served[path].values()), "%s: kernels launched %s"
              % (path, served[path]))
        return out

    t_new = time.perf_counter()
    line, servers, ring = counted("wire", wire_phase, rt, pool, want[4],
                                  seed, work, json_figs, smi)
    say(line)
    say(counted("loadgen", loadgen_phase, rt, text4, pool, seed, smi))
    say(counted("die_at_ring", die_at_ring_done, rt, ring, pool, want[4],
                smi))
    for sv in servers:
        sv.shutdown()
        sv.server_close()
    rt.stop()
    t_new = time.perf_counter() - t_new
    t_children = time.perf_counter()
    cli_on = start_cli_online(tsv, work, tempfile.mkdtemp(dir=work))
    cli_sv = start_cli_serve(pub_dir)
    fleet = start_fleet(pub_dir)
    say(serve_fault_phase(pub_dir, text4, pool, smi))
    serve_line = cli_serve_done(cli_sv, pool, want, seed)
    online_line, cli_counts = cli_online_done(cli_on, gens)
    say("cli serve / cli online (%s): %s; %s (both children %.1f s)"
        % (smi, serve_line, online_line, time.perf_counter() - t_children))
    t_fleet = time.perf_counter()
    say(counted("fleet", fleet_done, fleet, pool, want[4], seed, smi))
    t_fleet = time.perf_counter() - t_fleet
    say("serving and online lines: %.1f s (wire, loadgen and die_at_ring "
        "%.1f s; fleet after the children %.1f s)"
        % (time.perf_counter() - t_phase, t_new, t_fleet))
    cli = {k: 0 for k in COUNTED}
    cli.update(cli_counts)
    out = {"online": launches, "cli online": cli}
    out.update(served)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--bounds-child", choices=sorted(BOUNDS_CALLS),
                    help=argparse.SUPPRESS)
    ap.add_argument("--dist-child", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dist-spec", help=argparse.SUPPRESS)
    ap.add_argument("--tsv-child", help=argparse.SUPPRESS)
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
    if args.bounds_child:
        return bounds_child(args.bounds_child)
    if args.dist_child is not None:
        return dist_child(args.dist_child, args.dist_spec)
    if args.tsv_child:
        return tsv_child(args.tsv_child, args.rows, args.seed)
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    capi_build = start_capi_build()
    build_s, build_logs = build.build_all()
    capi_s = capi_build_done(capi_build)
    # the online line's TSV, written by a child while the kernel phases
    # run (its directory goes at the end)
    import shutil
    import tempfile
    online_work = tempfile.mkdtemp(prefix="lgbm_online_")
    tsv_run = start_tsv_child(online_work, args.seed)
    say("device: %s | %s | torch %s CUDA %s | kernel build %.2f s | C "
        "libraries (g++, beside it) %.2f s"
        % (torch.cuda.get_device_name(0), smi, torch.__version__,
           torch.version.cuda, build_s, capi_s))
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
    year_b1 = year_b1_phase(args.seed, dev)
    kernels["segment_histogram"]["year_f90"] = year_b1
    say("kernels at the year path's width: B1 checked against its plain "
        "version at n=%d, F=%d, P=%d, B=256 (five feature groups) and timed "
        "on the root (%s): %s" % (YEAR_ROWS, YEAR_F, YEAR_F + 10, smi,
                                  json.dumps(year_b1)))
    merged = merged_kernel_phase(1_015_808, args.seed, dev)
    kernels["partition_segment_hist"] = merged
    say("merged kernel: B6 checked against its plain version on every "
        "predicate kind at n=1015808, F=28, B=256 and n=200000, F=137, "
        "B=64; timed on the root and on %d rows beside B2 + B1 on the "
        "smaller child: %s" % (WIDE_SEGMENT_ROWS, json.dumps(merged)))
    say("census sizes: the kernel's work split held to "
        "cuda_segment.hist_work_split, and B1, B4 and B6 held to their "
        "plain versions at the census sizes and at each row layout's: %s"
        % json.dumps(census_check_phase(1_015_808, args.seed, dev)))
    sizes = sizes_phase(1_015_808, args.seed, dev)
    say("sizes: B1, B6 and B1's index_add_ yardstick, device us per call "
        "at %s rows and the root (%s): %s"
        % (CENSUS_SIZES, smi, json.dumps(sizes)))
    for key, fields in (("segment_histogram", ("b1_us", "b1_call_us",
                                               "library_us", "b1_bound_us")),
                        ("partition_segment_hist", ("b6_us", "b6_bound_us"))):
        kernels[key]["by_size_us"] = {rows: {k: rec[k] for k in fields}
                                      for rows, rec in sizes.items()}
    wide = wide_kernels_phase(args.seed, dev)
    say("wide kernels: B7, B3, B8 (and B1, B2, stage + commit, B4, B5) "
        "checked against the plain versions on %d rows, timed with B1 and "
        "B2 on the root segment and on %d rows (Bosch F=968 P=978, Epsilon "
        "F=2000 P=2010, B=256): %s"
        % (WIDE_CMP_ROWS, WIDE_SEGMENT_ROWS, json.dumps(wide)))
    say("sweep: whole partitions over payload widths %s, f32 histograms "
        "over %s features, ms on %d and %d rows (%s): %s"
        % (SWEEP_WIDTHS, SWEEP_FEATURES, SWEEP_ROWS, WIDE_SEGMENT_ROWS, smi,
           json.dumps(sweep_phase(args.seed, dev))))
    say("count-0 segments: every kernel on 0 rows at n=%d, F=28, 968 and "
        "2000: %s" % (EMPTY_ROWS, json.dumps(empty_segment_phase(args.seed,
                                                                 dev))))
    say(parity_phase(args.seed))
    say(wide_parity_phase(args.seed, dev))
    line, main_run, data = main_path_phase(args.rows, args.iters, args.seed)
    say(line)
    # B2 whole runs its count, scan, move and smaller-side copy, never the
    # stage's scatter or the full-segment copy-back
    say(profile_phase(main_run["bst"], "main path",
                      launched=("part_move", "part_copy_side"),
                      retired=("part_stage_move", "part_commit"),
                      crosscheck=True))
    line, census_bounds = census_line(main_run["bst"]._model.trees)
    say(line)
    dev_us, host_us = inactive_step_cost(main_run["bst"])
    main_run["step_kernels"] = step_kernels(main_run["bst"])
    say("no-op step (main path): the captured split step on a finished "
        "tree, %.2f us on the device and %.2f us on the host per replay, "
        "%d device kernels (%s)" % (dev_us, host_us,
                                    main_run["step_kernels"], smi))
    say(replay_check(main_run["bst"]))
    say(predict_main_phase(main_run["bst"], data[1], data[2]))
    # the eager run's reference: the main path's model cut to its first
    # JIT_OFF_ITERS iterations (a run of that many writes it byte for byte)
    main_cut = main_run["bst"].model_to_string(num_iteration=JIT_OFF_ITERS)
    del main_run["bst"]
    ds = data[0]
    say(jit_off_check("main path", lambda: lt.train(
        train_params(255), ds, JIT_OFF_ITERS, verbose_eval=False),
        main_cut))
    say(checked_partition_phase(data, args.rows, 1))
    say("deterministic mode: the capture's probe (torch.histc on the card) "
        "warned %s" % json.dumps(deterministic_probe()))
    say(repeat_check("main path", lambda: lt.train(
        train_params(255), ds, args.iters, verbose_eval=False),
        main_run["model_text"]))
    seam_paths = seam_phases(data, main_run, args.rows, args.iters,
                             args.seed, smi)
    early_stop_phase(data, args.rows)
    runs = histogram_mode_phases(data, main_run, args.rows, args.iters)
    say(repeat_cut("merged", lambda n: merged_train(ds, n),
                   runs["merged"]["model_text"]))
    say(merged_pays_line(census_bounds))
    for key, path, group in (
            ("segment_histogram", "main path", "histogram f32"),
            ("partition_segment_hist", "merged", "partition + histogram")):
        kernels[key].update(
            census_bound_ms_per_iter=census_bounds[key],
            profile_ms_per_iter=PROFILED[path][group][1])
    runs.update(quantized_phases(data, main_run, args.rows, args.iters))
    say(repeat_cut("frontier 8", lambda n: lt.train(
        train_params(255, **QUANT_PATHS["frontier 8"]), ds, n,
        verbose_eval=False), runs["frontier 8"]["model_text"]))
    bagged = bagging_phase(data, main_run, args.iters)
    api = api_phases(data, main_run, args.iters, smi)
    api.update(variant_phases(data, main_run, args.iters, args.seed, smi))
    api["wide index (forced)"] = wide_index_forced_phase(data, main_run,
                                                         args.iters)
    dist = {}

    def run_distributed(cache):
        line, launches = distributed_phase(cache, data, main_cut, runs,
                                           args.seed, dev, smi)
        dist.update(launches)
        dist["line"] = line

    api.update(files_phase(data, args.seed, smi, on_cache=run_distributed))
    say(dist.pop("line"))
    api["goss fobj"] = goss_fobj_phase(data, smi)
    api["sklearn"] = sklearn_phase(args.rows, args.seed, main_run,
                                   args.iters, smi)
    online_paths = serving_online_phases(tsv_run, main_run["model_text"],
                                         data, args.seed, smi)
    shutil.rmtree(online_work, ignore_errors=True)
    del data, ds
    # each kernel's launches are read from the path it serves; every
    # path's counts stand beside them
    paths = {"main path": main_run["launches"]}
    paths.update(seam_paths)
    paths.update({k: v["launches"] for k, v in runs.items()})
    for f, rows in WIDE:
        line, r = wide_path_phase(f, rows, args.iters, args.seed, dev)
        say(line)
        # B3 and B8 move in place and copy the smaller side back; B3's old
        # scatter, full copy-back and value pass are retired
        say(profile_phase(r["bst"], "wide %d" % f, **(
            dict(launched=("hist_colblock", "block_move", "wide_copy_side"),
                 retired=("rmw_",) + RETIRED_WIDE)
            if f == 2000 else
            dict(launched=("hist_colblock", "rmw_count", "rmw_move",
                           "rmw_copy_side"),
                 retired=("route_", "block_move") + RETIRED_WIDE))))
        paths["wide %d" % f] = r["launches"]
        if f == 968:
            # three iterations keep the repeat inside the time limit
            say(repeat_check("wide 968 (3 iters)", lambda: lt.train(
                train_params(255, metric="auc"), r["ds"], 3,
                valid_sets=[r["dv"]], verbose_eval=False)))
        del r
        torch.cuda.empty_cache()
    say(serving_phase(args.seed, dev, smi))
    paths["categorical"] = categorical_phase(args.seed, args.iters,
                                             main_run)
    paths.update(bagged)
    paths.update(api)
    paths.update(dist)
    paths.update(online_paths)
    year_data, paths["year"] = year_phase(args.seed, args.iters, main_run,
                                          smi)
    paths["renewal"] = renewal_phase(year_data)
    paths["goss l1"] = goss_l1_phase(year_data, smi)
    del year_data
    runs, kernels["segment_histogram"]["covtype_k7"] = multiclass_phase(
        args.seed, args.iters, main_run, smi)
    paths.update(runs)
    paths["rank"], kernels["segment_histogram"]["mslr_f136"], rank_data = \
        rank_phase(args.seed, args.iters, main_run, smi)
    paths.update(rank_variant_phases(rank_data, smi))
    del rank_data
    say(objectives_parity_phase(args.seed))
    paths.update(efb_expo_phase(args.seed, smi))
    paths.update(efb_covtype_phase(args.seed, smi))
    paths["wide index"] = wide_index_phase(args.seed, smi)
    say(elements_phase(args.seed, dev))
    say(bounds_phase())
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
        if key == "partition_segment_stage_commit":
            # the stage's launches, the commit's beside them
            rec = dict(rec, path="frontier 8", launches=paths["frontier 8"][
                "partition_segment_stage"])
            for half in ("stage", "commit"):
                name = "partition_segment_" + half
                rec[half + "_launches"] = paths["frontier 8"][name]
                rec[half + "_launches_by_path"] = {
                    p: c[name] for p, c in paths.items()}
            record.append(rec)
            continue
        rec = dict(rec, launches=paths[serves[key]][key], path=serves[key],
                   launches_by_path={p: c[key] for p, c in paths.items()})
        if key in wide:
            # its checks at both wide shapes (B1 and B2 timed there too)
            rec["wide_by_shape"] = wide[key]
        record.append(rec)
    print(json.dumps({"kernels": record}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
