"""chip_smoke.py's serving data-plane lines alone, on one GPU.

    python3 chip_probe.py [--seed N]

Publishes three synthetic serving-shape generations (100 trees x 255
leaves x 28 features) into a fresh publish directory, runs chip_smoke's
`serve` line over it (which publishes generation 4, the 500 x 255 x 28
serving model, mid-stream), then its `wire`, `loadgen` and `die_at_ring`
lines on the same runtime and its `fleet` line alone (the full script
overlaps the fleet's start-up with its CLI children).  Every check of
those lines holds here as in chip_smoke.py; it prints each line and the
seconds each took, for a prediction of the full script's.  Builds no
kernel (the serving path launches none).  Needs one CUDA device; imports
nothing of JAX or lightgbm_tpu.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_probe.py runs on the GPU only",
              file=sys.stderr)
        return 2
    from lightgbm_tpu_torch.runtime import publish
    t_all = time.perf_counter()
    smi = cs.nvidia_smi()
    work = tempfile.mkdtemp(prefix="lgbm_probe_")
    try:
        pub = os.path.join(work, "online.txt.pub")
        publisher = publish.ModelPublisher(pub, keep_last=0)
        for g in (1, 2, 3):
            publisher.publish(cs.synth_serving_model(
                100, 255, cs.F, args.seed + g).save_model_to_string(),
                generation=g)
        line, text4, pool, want, rt, figs = cs.serve_phase(
            pub, cs.published(pub), args.seed, smi)
        cs.say(line)
        secs = {}
        t0 = time.perf_counter()
        line, servers, ring = cs.wire_phase(rt, pool, want[4], args.seed,
                                            work, figs, smi)
        secs["wire"] = time.perf_counter() - t0
        cs.say(line)
        t0 = time.perf_counter()
        cs.say(cs.loadgen_phase(rt, text4, pool, args.seed, smi))
        secs["loadgen"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cs.say(cs.die_at_ring_done(rt, ring, pool, want[4], smi))
        secs["die_at_ring"] = time.perf_counter() - t0
        for sv in servers:
            sv.shutdown()
            sv.server_close()
        rt.stop()
        t0 = time.perf_counter()
        cs.say(cs.fleet_done(cs.start_fleet(pub), pool, want[4], args.seed,
                             smi))
        secs["fleet, start to stop, alone"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("probe seconds (%s): %s; whole %.1f s"
          % (smi, {k: round(v, 2) for k, v in secs.items()},
             time.perf_counter() - t_all), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
