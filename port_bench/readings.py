"""Readings for a cell's limits, on the card, in one process: for each
seed, the window's calls (`--calls`, after the set-up's warm-up) at the
cell's own sizes, then the numbers the comparison reads, for the program
and for the control (the reference in lower precision in the program's
place), or with `--fault` for the program with that fault planted. Prints
one JSON line a seed.

    python3 port_bench/readings.py --workload <name> --seeds 1,2,3 [--calls 1] [--control 1]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench.faults import planted  # noqa: E402
from port_bench.run import _env, load_cell  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--calls", type=int, default=1)
    p.add_argument("--control", type=int, default=1)
    p.add_argument("--fault", default="", help="plant this fault (port_bench/faults.py) under the program's run")
    args = p.parse_args(argv)
    _env()
    import torch

    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl, cfg, Driver = load_cell(args.workload)
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with planted(wl["driver"], args.fault) if args.fault else contextlib.nullcontext():
            drv = Driver(cfg, wl["traffic"], seed, dev, tempfile.gettempdir())
            drv.limits = wl["limits"]
            drv.warmup()
            for k in range(args.calls):
                drv.call(k)
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            drv.release()
        torch.cuda.empty_cache()
        out = {"seed": seed, "fault": args.fault, "program": {n: v for n, v, _ in drv.check()}, "run_s": t1 - t0}
        out["check_s"] = time.perf_counter() - t1
        if args.control:
            out["control"] = {n: v for n, v, _ in drv.check(control=True)}
        print(json.dumps(out), flush=True)
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
