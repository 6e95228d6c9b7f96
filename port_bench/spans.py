"""The program's spans in a render cell, on the card: where the device's
idle time goes by span, how well the program's ring lines up with the
profiler's clock, and what the spans cost while the profiler runs.

    python3 port_bench/spans.py --workload <render cell> --seed <n> --seconds 20 --plan S,A10

One process, one driver, the cell's set-up, then each window of `--plan`:
- `S`: a traced window as `run.py --trace 1` runs it. Prints the cell's
  per-layer metrics, the offsets' spread (`harness/program.py`), device-idle
  ms a pass and host self ms a pass by span name, the counters, and from
  the exported Chrome trace: the program's annotations and whether each
  lies inside a `render_call`, and for each call the harness's delay from
  `render_call` to the profiler's `render` annotation and the gap between
  that annotation and the ring's `time.time_ns()` start of the same span.
- `A<n>`: one traced session of n calls, the program's spans on in even
  calls and off in odd ones; prints each side's seconds a call.
Then the comparison with the reference, as `run.py` makes it. One JSON line
a window.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench.run import ROOT, _env, load_cell, power_limit, read_metrics  # noqa: E402

PROGRAM = ("render", "bounce", "sampler")  # the first dotted part of the program's render spans


def chrome_view(path: str, call: str, snap) -> dict:
    """The exported trace against the ring: nesting, and the clocks."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc["baseTimeNanoseconds"])
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    ann = sorted((e for e in events if e.get("cat") == "user_annotation"), key=lambda e: e["ts"])
    calls = [e for e in ann if e["name"] == call]
    prog = [e for e in ann if e["name"] != call and e["name"].split(".")[0] in PROGRAM]
    bounds = [(e["ts"], e["ts"] + e["dur"]) for e in calls]
    inside = sum(any(a <= e["ts"] and e["ts"] + e["dur"] <= b for a, b in bounds) for e in prog)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names: dict = {}
    for e in prog:
        names[e["name"]] = names.get(e["name"], 0) + 1
    renders = [e for e in prog if e["name"] == "render"]
    roots = [s for s in snap.spans if s.name == "render" and s.parent < 0]
    return {"annotations": names, "inside_calls": inside, "outside_calls": len(prog) - inside,
            "kernels": len(kernels), "kernels_inside_calls": sum(any(a <= e["ts"] <= b for a, b in bounds)
                                                                 for e in kernels),
            "threads": sorted({f"{e.get('cat')}:{e.get('tid')}" for e in renders[:1] + kernels[:1]}),
            "harness_delay_us": [r["ts"] - c["ts"] for c, r in zip(calls, renders)],
            "ring_vs_profiler_us": [(r["ts"] * 1e3 + base - s.start_ns) * 1e-3 for r, s in zip(renders, roots)]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--plan", default="S,A10")
    args = p.parse_args(argv)
    _env()
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from bsdf_diffusion_sampling_tpu_torch.core import trace
    from port_bench.harness import program
    from port_bench.harness.trace import read_chrome_trace

    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl, cfg, Driver = load_cell(args.workload)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    dev, tmp = torch.device("cuda", 0), tempfile.gettempdir()
    print(json.dumps({"card": power_limit(), "workload": args.workload, "seed": args.seed}), flush=True)
    drv = Driver(cfg, wl["traffic"], args.seed, dev, tmp)
    drv.limits = wl["limits"]
    drv.warmup()
    torch.cuda.synchronize(dev)
    names = [m["name"] for m in bench["per_layer"] if args.workload in m.get("workloads", [args.workload])]
    enabled, done = trace.enabled, 0
    for kind in args.plan.split(","):
        trace.clear()
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
        if kind.startswith("A"):
            sides = {"on": [], "off": []}
            for k in range(int(kind[1:])):
                side = "on" if k % 2 == 0 else "off"
                trace.enabled = enabled if side == "on" else (lambda: False)
                t0 = time.perf_counter()
                with record_function(drv.span):
                    drv.call(done + k)
                torch.cuda.synchronize(dev)
                sides[side].append(time.perf_counter() - t0)
            trace.enabled = enabled
            prof.__exit__(None, None, None)
            done += int(kind[1:])
            print(json.dumps({"window": kind, "seconds_a_call": sides}), flush=True)
            continue
        calls, t0 = 0, time.perf_counter()
        while True:
            with record_function(drv.span):
                drv.call(done + calls)
            calls += 1
            if time.perf_counter() - t0 >= args.seconds:
                break
        torch.cuda.synchronize(dev)
        prof.__exit__(None, None, None)
        done += calls
        path = os.path.join(tmp, f"port_bench_spans_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        try:
            snap = trace.snapshot()
            out = {"window": kind, "calls": calls, "chrome": chrome_view(path, drv.span, snap)}
            tr = read_chrome_trace(path, {drv.span, "pairgen", "update"})
        finally:
            os.remove(path)
        tr.work = {k: {a: b * calls for a, b in v.items()} if isinstance(v, dict) else v * calls
                   for k, v in drv.work().items()}
        out["metrics"] = read_metrics(names, tr)
        passes = calls * drv.passes
        split = program.idle_split(tr)
        if split is not None:
            out["spread_us"] = split["spread_us"]
            out["idle_ms_a_pass"] = {k: 1e3 * v / passes for k, v in split["by_name"].items()}
        out["busy_s"], out["window_s"] = tr.busy_s, tr.window_s
        table = trace.summary()
        out["host_self_ms_a_pass"] = {k: v["self_ms"] / passes for k, v in table["spans"].items()}
        out["counters"] = table["counters"]
        print(json.dumps(out), flush=True)
    drv.release()
    torch.cuda.empty_cache()
    compared = drv.check()
    print(json.dumps({"correct": all(v <= lim for _, v, lim in compared),
                      "compared": {n: {"value": v, "limit": lim} for n, v, lim in compared}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
