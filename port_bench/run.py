"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name: `port_bench/workloads/<name>.json` names its
configuration (`port_bench/configs/<config>.json`), its driver
(`port_bench/drivers/<driver>.py`) and its traffic. Set-up builds the
program's libraries into fixed directories inside `port_bench/` (.cache),
makes the weights from the seed, writes the scene under TMPDIR and warms
up the cell's shapes; the window then runs whole calls back to back until
`--seconds` have passed. With `--trace 1` the window runs under the
profiler and the line carries the cell's per-layer metrics; with
`--trace 0`, its end-to-end ones. After the window the program's state is
freed and the reference judges what the window produced.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and with --trace 1 a breakdown), and last the
compared numbers with their limits, which also end standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(BENCH, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "bsdf_diffusion_sampling_tpu")


def _env():
    """Build and kernel caches at fixed paths inside the checkout."""
    os.environ["BSDF_TORCH_BUILD_DIR"] = os.path.join(CACHE, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str) -> tuple:
    """(workload, configuration, driver class) by the workload's name."""
    with open(os.path.join(BENCH, "workloads", workload + ".json")) as f:
        wl = json.load(f)
    with open(os.path.join(BENCH, "configs", wl["config"] + ".json")) as f:
        cfg = json.load(f)
    drv = load_file(os.path.join(BENCH, "drivers", wl["driver"] + ".py"), f"port_bench_driver_{wl['driver']}")
    return wl, cfg, drv.Driver


def read_metrics(names, tr) -> dict:
    out = {}
    for name in names:
        mod = load_file(os.path.join(BENCH, "metrics", name + ".py"), f"port_bench_metric_{name}")
        v = mod.read(tr)
        if v is not None:
            out[name] = v
    return out


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _env()
    wl, cfg, Driver = load_cell(args.workload)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"no card: cuda available {torch.cuda.is_available()}, {torch.cuda.device_count()} devices, "
              f"{wl['chips']} needed", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"refused: loaded {found}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    print(f"card: {power_limit()}", file=sys.stderr)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    drv = Driver(cfg, wl["traffic"], args.seed, device, tempfile.gettempdir())
    drv.limits = wl["limits"]
    drv.warmup()
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T_START

    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
    from torch.profiler import record_function

    units, calls = 0.0, 0
    t0 = time.perf_counter()
    while True:
        with record_function(drv.span):
            units += drv.call(calls)
        calls += 1
        t1 = time.perf_counter()
        if t1 - t0 >= args.seconds:
            break
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = max(torch.cuda.max_memory_allocated(device), getattr(drv, "peak_bytes", lambda: 0)())

    cell = args.workload
    metrics, breakdown, dev = {}, None, {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                                          "count": wl["chips"], "memory_peak_bytes": int(peak)}
    if args.trace:
        from port_bench.harness.trace import export_and_read

        tr = export_and_read(prof, {drv.span, "pairgen", "update"}, tempfile.gettempdir())
        tr.work = {k: {a: b * calls for a, b in v.items()} if isinstance(v, dict) else v * calls
                   for k, v in drv.work().items()}
        names = [m["name"] for m in bench["per_layer"] if cell in m.get("workloads", [cell])]
        values = read_metrics(names, tr)
        units_of = {m["name"]: m["unit"] for m in bench["per_layer"]}
        metrics = {k: {"value": v, "unit": units_of[k]} for k, v in values.items()}
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        breakdown = tr.breakdown()
        del prof, tr
    else:
        e2e = {m["name"]: m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
        rate = units / (t1 - t0) / 1e6
        for name, m in e2e.items():
            value = setup_s if name == "setup_s" else rate if name == drv.unit else None
            if value is not None:
                metrics[name] = {"value": value, "unit": m["unit"]}

    drv.release()
    torch.cuda.empty_cache()
    compared = drv.check()
    correct = all(v <= lim for _, v, lim in compared)
    found = forbidden_modules()
    if found:
        print(f"refused: loaded {found}", file=sys.stderr)
        return 3
    for name, v, lim in compared:
        print(f"{name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    line = {"correct": correct, "attempted": calls, "failed": 0, "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in compared}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
