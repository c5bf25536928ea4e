"""The dispatch pipeline's lines alone on one GPU, without the rest of
chip_smoke.py:

    python3 chip_pipeline_probe.py

Builds the kernels, trains the main path (1M x 28, 255 leaves, 10
iterations, at the default pipeline_depth=1), profiles one more
iteration, replays a captured split step, runs the repeat check and
chip_smoke.py's `pipeline` line, then the main path with the 100k
held-out rows as a validation set at pipeline_depth 0, 1 and 2 and at
boost_window=4 (the model sha256, the validation AUC of every iteration
and the final validation scores held to depth 0's, s/iter of each),
the early-stop path and one iteration with every B2 call held to the
plain partition.  Each line starts with the seconds since start.

    python3 chip_pipeline_probe.py --gil

reads only where depth 1 loses time to depth 0 on the main path: 10
iterations at depth 0, at depth 1 as it is, at depth 1 with the
interpreter's switch interval cut from CPython's 5 ms to 0.1 ms, and at
depth 1 with the grower's stop-flag wait yielding the GIL at each poll,
after one
unrecorded warm-up run (the process's first training captures the
graphs), in a palindromic order repeated twice (each variant four
times); per run the s/iter, the seconds the dispatch thread waited in the
assembler's `submit` and the drain units' summed wall seconds.
"""
import collections
import json
import sys
import time

import numpy as np

import chip_smoke as c
import lightgbm_tpu_torch as lt


def yielding_drive(step, n, flag, device):
    """grower2._drive with a GIL release at each poll of its stop-flag
    wait (time.sleep(0))."""
    import torch
    pending = collections.deque()
    for _ in range(n):
        while pending and (len(pending) >= c.grower2.STEPS_AHEAD
                           or pending[0].query()):
            done = pending.popleft()
            while not done.query():
                time.sleep(0)
            if not flag[0]:
                return
        step()
        done = torch.cuda.Event()
        done.record()
        pending.append(done)


def gil_readings(smi: str) -> None:
    from lightgbm_tpu_torch.boosting import pipeline
    params = c.train_params(255)
    ds, Xv, yv, t_bin = c.make_main_data(1_000_000, 7, params)
    c.say("binned in %.3f s" % t_bin)
    waits = {"submit": 0.0, "units": 0.0}
    submit = pipeline.TreeAssembler.submit

    def timed_submit(self, fn, trees=1):
        def unit():
            t = time.perf_counter()
            try:
                fn()
            finally:
                waits["units"] += time.perf_counter() - t
        t = time.perf_counter()
        submit(self, unit, trees=trees)
        waits["submit"] += time.perf_counter() - t

    pipeline.TreeAssembler.submit = timed_submit
    drive = c.grower2._drive
    swi = sys.getswitchinterval()
    variants = ("depth 0", "depth 1", "depth 1 switch interval 0.1 ms",
                "depth 1 yielding wait")
    order = 2 * (list(range(len(variants))) + list(reversed(range(
        len(variants)))))
    c.train_path("warm-up", ds, Xv, yv, params, 10)
    out = collections.defaultdict(list)
    ref = None
    for v in order:
        name = variants[v]
        waits.update(submit=0.0, units=0.0)
        if "switch" in name:
            sys.setswitchinterval(1e-4)
        if "yielding" in name:
            c.grower2._drive = yielding_drive
        try:
            r = c.train_path(name, ds, Xv, yv, c.train_params(
                255, pipeline_depth=int(name != "depth 0")), 10)
        finally:
            sys.setswitchinterval(swi)
            c.grower2._drive = drive
        del r["bst"]
        ref = ref or c.sha(r["model_text"])
        c.check(c.sha(r["model_text"]) == ref, "%s: model differs" % name)
        out[name].append((r["s_per_iter"], waits["submit"], waits["units"]))
        c.say("%s: %.4f s/iter, submit waits %.4f s, drain units %.4f s "
              "(%s)" % (name, r["s_per_iter"], waits["submit"],
                        waits["units"], smi))
    pipeline.TreeAssembler.submit = submit
    c.say("gil readings (s/iter, submit wait s, unit s), sha256 %s: %s (%s)"
          % (ref[:12], json.dumps(out), smi))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_pipeline_probe.py runs on the GPU only",
              file=sys.stderr)
        return 2
    t0 = time.time()
    if "--gil" in sys.argv[1:]:
        smi = c.nvidia_smi()
        s, _ = c.build.build_all()
        c.say("build %.1f s | %s" % (s, smi))
        gil_readings(smi)
        c.say("probe done in %.1f s" % (time.time() - t0))
        return 0
    smi = c.nvidia_smi()
    s, _ = c.build.build_all()
    c.say("build %.1f s | %s" % (s, smi))
    line, main_run, data = c.main_path_phase(1_000_000, 10, 7)
    c.say(line)
    c.say("main sha256 %s" % c.sha(main_run["model_text"]))
    c.say(c.profile_phase(main_run["bst"], "main path",
                          launched=("part_move", "part_copy_side"),
                          retired=("part_stage_move", "part_commit"),
                          crosscheck=True))
    c.say(c.replay_check(main_run["bst"]))
    del main_run["bst"]
    ds, Xv, yv = data
    c.say(c.repeat_check("main path", lambda: lt.train(
        c.train_params(255), ds, 10, verbose_eval=False),
        main_run["model_text"]))
    c.pipeline_phase(data, main_run, 1_000_000, 10, smi)
    dv = lt.Dataset(Xv, label=yv, reference=ds)
    res = {}
    for knobs in (dict(pipeline_depth=0), dict(), dict(pipeline_depth=2),
                  dict(boost_window=4)):
        ev = {}
        r = c.train_path("valid %s" % knobs, ds, Xv, yv,
                         c.train_params(255, metric="auc", **knobs), 10,
                         valid_sets=[dv], evals_result=ev)
        res[json.dumps(knobs)] = (c.sha(r["model_text"]),
                                  ev["valid_0"]["auc"],
                                  r["bst"]._engine.raw_valid_score(0),
                                  r["s_per_iter"])
        del r["bst"]
    ref = res[json.dumps(dict(pipeline_depth=0))]
    for k, v in res.items():
        c.check(v[0] == ref[0] and v[1] == ref[1]
                and np.array_equal(v[2], ref[2]),
                "valid %s: the model, AUC or scores differ from depth 0's"
                % k)
        c.say("valid %s: sha %s, s/iter %.4f, auc[-1] %.6f, evals and "
              "valid scores bit for bit to depth 0's (%s)"
              % (k, v[0][:12], v[3], v[1][-1], smi))
    c.early_stop_phase(data, 1_000_000)
    c.say(c.checked_partition_phase(data, 1_000_000, 1))
    c.say("probe done in %.1f s" % (time.time() - t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
