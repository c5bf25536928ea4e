"""A parent tree's kernels timed beside this tree's, in one call on one GPU.

    python3 chip_compare.py PARENT_DIR [--log FILE] [--rows N] [--iters N]
                            [--seed N]

PARENT_DIR holds the parent commit's files, unpacked beforehand into a
directory that .gitignore lists, e.g.

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent

The script copies this tree's chip_smoke.py into PARENT_DIR and runs
chip_smoke.compare_phase in the parent, this tree, this tree and the
parent, in that order, each in its own process in its own tree (each
builds its own kernels under its build/kernels/), so a drift of the card's
clocks over the call shows in both.  compare_phase drives only the port's
public wrappers and entry points: the B1 / B6 / index_add_ readings at the
census sizes, B5 (f32 and int32, with B1 on the same rows), the stage +
commit and B7's two wide roots, then every training path of
chip_smoke.py (main, merged, pooled, quantized int8 and int16, frontier
8, int8 + frontier 8, wide 968 and wide 2000) trained and profiled, each
with its s/iter, blocking syncs per tree, host enqueue calls (kernel and
graph launches), device kernels, idle share and peak memory.  Every line is printed prefixed with its run, and with --log
also written to FILE.  Exits non-zero if a run fails.
Needs one CUDA device; imports nothing of JAX or lightgbm_tpu.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", help="the parent tree, unpacked")
    ap.add_argument("--log", help="also write every line to this file")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    parent = os.path.abspath(args.parent)
    if not os.path.isdir(os.path.join(parent, "lightgbm_tpu_torch")):
        ap.error("%s holds no lightgbm_tpu_torch package" % parent)
    shutil.copy(os.path.join(HERE, "chip_smoke.py"), parent)
    code = ("import chip_smoke as c; c.compare_phase(%d, %d, %d)"
            % (args.rows, args.iters, args.seed))
    if args.log:
        os.makedirs(os.path.dirname(os.path.abspath(args.log)),
                    exist_ok=True)
    rc = 0
    with open(args.log or os.devnull, "w") as log:
        for k, (name, tree) in enumerate((("parent", parent),
                                          ("change", HERE),
                                          ("change", HERE),
                                          ("parent", parent))):
            tag = "[%d %s] " % (k + 1, name)
            proc = subprocess.Popen([sys.executable, "-c", code], cwd=tree,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            for line in proc.stdout:
                print(tag + line, end="", flush=True)
                log.write(tag + line)
            if proc.wait() != 0:
                print("%sexit code %d" % (tag, proc.returncode), flush=True)
                rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
