"""Rank workers of the distributed-learner tests (tests/test_torch_
{parallel,tree_learner,launch,find_bin_distributed}.py).

The pytest process has imported JAX, so ranks start with the `spawn`
context, and this module imports no JAX: a spawned rank imports it to
find its target.  Each rank joins a gloo group through a FileStore in the
test's tmp_path (no TCP port, so test files run side by side), runs one
task and pickles its result for the parent; `run_ranks` joins every rank
under a timeout and kills the ones left.
"""
import os
import pickle
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rank_main(rank, world, store_path, task, args, out_dir, group=True):
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        from lightgbm_tpu_torch.parallel import launch
        if group:
            store = dist.FileStore(store_path, world)
            launch.init_group(store=store, world_size=world, rank=rank,
                              timeout_s=120, attempts=1)
        try:
            result = TASKS[task](rank, world, *args)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        out = ("ok", result)
    except BaseException:   # the parent reports the rank's traceback
        out = ("error", traceback.format_exc())
    with open(os.path.join(out_dir, "rank%d.pkl" % rank), "wb") as fh:
        pickle.dump(out, fh)


def run_ranks(tmp_path, task, args=(), world=2, timeout=240, group=True):
    """Run `task` on `world` spawned ranks (joined in a FileStore group
    unless `group` is False: the task brings its own up); returns their
    results in rank order, or raises with a failing rank's traceback."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    out_dir = str(tmp_path)
    store = os.path.join(out_dir, "store_%s_%d" % (task, time.time_ns()))
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, task, args, out_dir, group))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout
    for p in procs:
        p.join(max(deadline - time.time(), 1))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    results = []
    for r in range(world):
        path = os.path.join(out_dir, "rank%d.pkl" % r)
        if not os.path.exists(path):
            raise RuntimeError("rank %d left no result (%s)" % (
                r, "killed at the timeout" if hung else "exit code %s"
                % procs[r].exitcode))
        with open(path, "rb") as fh:
            status, val = pickle.load(fh)
        os.remove(path)
        if status != "ok":
            raise RuntimeError("rank %d failed:\n%s" % (r, val))
        results.append(val)
    return results


# -- tasks ---------------------------------------------------------------

def _train(rank, world, params, data, rounds, extra=None):
    """Train the port on data (a dict of numpy arrays: X, y and optional
    weight / group / Xv / yv); returns the model text, the engine's
    learner, and what `extra` names."""
    import numpy as np
    import lightgbm_tpu_torch as lt
    ds = lt.Dataset(data["X"], label=data["y"], weight=data.get("weight"),
                    group=data.get("group"))
    kw = {}
    if "Xv" in data:
        kw["valid_sets"] = [lt.Dataset(data["Xv"], label=data["yv"],
                                       reference=ds)]
        kw["valid_names"] = ["valid"]
    evals = {}
    bst = lt.train(dict(params, device_type="cpu"), ds, rounds,
                   callbacks=[lt.record_evaluation(evals)], **kw)
    eng = bst._engine
    out = {"model": bst.model_to_string(), "mode": eng.parallel_mode,
           "world": eng.world, "evals": evals,
           "host_syncs": list(eng.host_syncs),
           "n_pad": int(eng.train_set.num_data_padded)}
    if eng._fast is not None:
        out["payload_rows"] = int(eng._fast.payload.shape[0])
    if "Xt" in data:
        out["pred"] = bst.predict(data["Xt"])
    return out


def _jobs(rank, world, jobs):
    """Several trainings in one spawn: jobs = [(params, data, rounds)]."""
    return [_train(rank, world, *job) for job in jobs]


def card_route(num_features):
    """The f32 histogram route with the card's fixed-point arithmetic
    (B1 / B7's plain versions), raw cells included."""
    from lightgbm_tpu_torch.ops import segment as tseg

    def segment_histogram(payload, start, count, *, scale=None,
                          workspace=None, raw=False, **kw):
        if raw:
            return tseg.fixed_cells(payload, start, count, scale=scale, **kw)
        return tseg.segment_histogram_fixed(payload, start, count,
                                            scale=scale, **kw)
    return segment_histogram


def _card_jobs(rank, world, jobs):
    """`_jobs` under the card's arithmetic: the fixed-point histograms,
    whose raw int64 cells cross (`grower2.exact_exchange`)."""
    from lightgbm_tpu_torch.boosting import grower2
    from lightgbm_tpu_torch.ops import cuda_segment
    cuda_segment.histogram_route = card_route
    grower2.exact_exchange = lambda dev: True
    return _jobs(rank, world, jobs)


def _echo(rank, world):
    """Collectives of parallel/comm.py on CPU tensors."""
    import torch
    from lightgbm_tpu_torch.parallel import comm
    t = torch.arange(5, dtype=torch.int64) + 10 * rank
    return {
        "world": comm.world_size(), "rank": comm.rank(),
        "sum": comm.all_reduce(t).tolist(),
        "max": comm.all_reduce(t.float(), "max").tolist(),
        "scatter": comm.reduce_scatter(t).tolist(),
        "gather": comm.all_gather(t[:2]).tolist(),
        "objects": comm.all_gather_object({"r": rank}),
    }


def _launch(rank, world, ports, data_path, out_dir):
    """The entry layers bringing two ranks up from one machine list of
    localhost ports (the reference's same-host layout, ranked by the
    local_listen_port tie-break): init_distributed and an object gather
    and the telemetry gather over it; LGBM_NetworkInit / Free through
    the C ABI; the CLI training tree_learner=data over its own group.
    Each bring-up has its own store port."""
    import torch.distributed as dist
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import application, capi
    from lightgbm_tpu_torch.parallel import comm, launch
    from lightgbm_tpu_torch.runtime import telemetry
    out = {}
    ml = ",".join("127.0.0.1:%d" % p for p in ports[0])
    got = lt.init_distributed(machines=ml, local_listen_port=ports[0][rank],
                              timeout_s=120, attempts=1)
    out["rank"] = got
    out["again"] = lt.init_distributed(machines=ml,
                                       local_listen_port=ports[0][rank])
    out["world"] = comm.world_size()
    out["gathered"] = comm.all_gather_object(("rank", got))
    snaps = telemetry.gather_host_snapshots()
    out["hosts"] = sorted(snaps)
    launch.shutdown_distributed()
    out["down"] = not dist.is_initialized()

    ml = ",".join("127.0.0.1:%d" % p for p in ports[1])
    capi.network_init(ml, local_listen_port=ports[1][rank],
                      listen_time_out=2, num_machines=2)
    out["capi_world"] = comm.world_size()
    out["capi_rank"] = comm.rank()
    capi.network_free()
    capi.network_free()
    out["capi_down"] = not dist.is_initialized()

    ml = ",".join("127.0.0.1:%d" % p for p in ports[2])
    model = os.path.join(out_dir, "cli_rank%d.txt" % rank)
    application.Application([
        "task=train", "data=" + data_path, "objective=binary",
        "num_leaves=7", "num_trees=3", "tree_learner=data",
        "device_type=cpu", "verbose=-1", "machines=" + ml,
        "local_listen_port=%d" % ports[2][rank],
        "output_model=" + model]).run()
    out["cli_down"] = not dist.is_initialized()
    with open(model) as fh:
        out["cli_model"] = fh.read()
    return out


def _find_bin(rank, world, cases):
    """parallel/find_bin.py on each rank's block: cases = [(sample,
    max_bin)]; returns each case's bounds."""
    import torch
    from lightgbm_tpu_torch.parallel.find_bin import (
        make_distributed_find_bin, shard_sample)
    out = []
    for sample, max_bin in cases:
        find = make_distributed_find_bin(max_bin)
        out.append(find(shard_sample(torch.from_numpy(sample))).numpy())
    return out


def _steps(rank, world, X, y, cfg_kw, max_bin):
    """The standalone parallel train steps (parallel/*_parallel.py) on a
    dataset binned here from X, y: each mode's (new score, tree) of one
    step from zero scores, this rank's block of the scores."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.boosting.gbdt import feature_meta
    from lightgbm_tpu_torch.boosting.grower2 import GrowerConfig
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import BinnedDataset
    from lightgbm_tpu_torch.ops.split import pad_feature_meta
    from lightgbm_tpu_torch.parallel import (data_parallel as dp,
                                             feature_parallel as fp,
                                             voting_parallel as vp)
    ds = BinnedDataset.from_matrix(X, Config({"objective": "binary",
                                              "max_bin": max_bin}))
    meta = feature_meta(ds, torch.device("cpu"))
    cfg = GrowerConfig(**cfg_kw)
    n_pad = ds.num_data_padded
    label, score = ds.padded(y), np.zeros(n_pad, np.float32)
    weight, mask = np.ones(n_pad, np.float32), ds.valid_row_mask()
    fmask = np.ones(ds.num_features, bool)
    out = {}
    for name, step in (
            ("data", dp.make_data_parallel_train_step(
                meta, cfg, ds.max_num_bin, 0.1)),
            ("voting", vp.make_voting_parallel_train_step(
                meta, cfg, ds.max_num_bin, 0.1, top_k=ds.num_features))):
        s, tree = step(*dp.shard_rows(ds.bins, score, label, weight, mask),
                       fmask)
        out[name] = (s.numpy(), {k: v.numpy() for k, v in tree.items()})
    bins_p, fmask_p, f_padded = fp.pad_features(ds.bins, fmask, world)
    step = fp.make_feature_parallel_train_step(
        pad_feature_meta(meta, f_padded), cfg, ds.max_num_bin, 0.1)
    b, fm, sc, lb, wt, mk = fp.shard_features(bins_p, fmask_p, score, label,
                                              weight, mask)
    s, tree = step(b, sc, lb, wt, mk, fm)
    out["feature"] = (s.numpy(), {k: v.numpy() for k, v in tree.items()})
    return out


TASKS = {"train": _train, "jobs": _jobs, "card_jobs": _card_jobs,
         "echo": _echo, "launch": _launch,
         "find_bin": _find_bin, "steps": _steps}
