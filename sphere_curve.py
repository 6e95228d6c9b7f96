#!/usr/bin/env python3
"""How the gates of `chip_smoke.py`'s phase 15 (the trained full-sphere
sampler) move with the training iterations, on one CUDA card.

Run from the root of a checkout:

    python3 sphere_curve.py
    python3 sphere_curve.py --plan 1000,2000,0 1000,2000,60

It writes the table scene, renders its gt and trains phase 10's 30 / 30 / 2
full-sphere checkpoint as `chip_smoke.py` does, then trains one directory
through `cli/train.py` to each (pretrain, diffusion, rectify) step of
`--plan` in turn, every stage resuming where the step before left it, and
after each step reads phase 15's checks, grid KLs, renders and gates
(`sphere_read`), with each stage's ms an iteration and, where rectify ran,
the teacher's first pairs against the plain transport. Phase 10's pretrain
and flow-matching stage files start the directory; a step that trains the
flow further drops the rectify stage file first, so rectify restarts from
the student just trained, as in one uninterrupted run. One JSON line a
step; all of them in `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

PLAN = ("1000,2500,0", "1000,3000,0", "1000,3000,50", "1000,3000,100", "1000,3000,150", "1000,3500,0",
        "1000,3500,100")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plan", nargs="+", default=PLAN, help="pretrain,diffusion,rectify iterations of each step")
    ap.add_argument("--out", default=os.path.join("out", "sphere_curve.json"), help="the JSON file of every step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sphere_curve: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.time()
    device = torch.device("cuda", 0)
    cs.cuda_build.build(sorted(set(cs.SOURCES.values())))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    res = {"card": smi, "plan": args.plan, "steps": []}
    with tempfile.TemporaryDirectory() as d:
        scenes = {"table": cs.write_scene(d, width=cs.RENDER_RES, height=cs.RENDER_RES, spp=cs.TABLE_SPP,
                                          max_depth=cs.RENDER_DEPTH, table=cs.TABLE)}

        def gt(spp, depth):
            return cs.render_cli.main(["--scene", scenes["table"], "--mode", "gt", "--spp", str(spp), "--spp-chunk",
                                       str(cs.RENDER_CHUNK), "--max-depth", str(depth), "--width", str(cs.RENDER_RES),
                                       "--height", str(cs.RENDER_RES), "--device", str(device),
                                       "--out", os.path.join(d, "table_gt")])

        gt(cs.RENDER_CHUNK, 2)  # warm-up
        images = {"table gt": gt(cs.TABLE_SPP, cs.RENDER_DEPTH)}
        run = cs.train_run(cs.train_argv(d, os.path.join(d, "train_sphere"), "sphere_full", f"table:{cs.TABLE[0]}",
                                         cs.TRAIN_SPHERE_RECTIFY))
        res["phase 10 pairs"] = cs.check_run(run, "sphere_full", cs.TRAIN_SPHERE_RECTIFY, resumed=False)["pairs"]
        out_dir = os.path.join(d, "quality_sphere")
        os.makedirs(out_dir)
        for f in cs.SPHERE_STAGES:
            shutil.copy(os.path.join(d, "train_sphere", f), out_dir)
        done_dif, done_rect = cs.TRAIN_ITERS["diffusion"], 0
        for step in args.plan:
            pre, dif, rect = (int(v) for v in step.split(","))
            rectify_file = os.path.join(out_dir, "rectify.npz")
            if dif > done_dif and os.path.exists(rectify_file):
                os.remove(rectify_file)
                done_rect = 0
            t0 = time.time()
            run = cs.train_run(cs.sphere_argv(d, {"pretrain": pre, "diffusion": dif, "rectify": rect}))
            point = {"step": [pre, dif, rect], "train_seconds": time.time() - t0,
                     "mcmc_seconds": run["stats"]["mcmc"]["seconds"],
                     "stages": {k: [v["iters"], v["ms_median"]] for k, v in run["stats"].items() if k != "mcmc"}}
            if rect > done_rect:
                point["pairs"] = cs.check_run(run, "sphere_full", rect - done_rect, resumed=True,
                                              gate_pairs=False)["pairs"]
            done_dif, done_rect = dif, rect
            t0 = time.time()
            point.update(cs.sphere_read(d, scenes, images, device))
            point["failed"] = [g for g, (_, ok) in point["gates"].items() if not ok]
            point["read_seconds"] = time.time() - t0
            res["steps"].append(point)
            with open(args.out, "w") as f:
                json.dump(res, f)
            print(json.dumps({k: point[k] for k in ("step", "kl", "theta_gaps", "gaps", "failed")}), flush=True)
    res["seconds"] = time.time() - t_start
    with open(args.out, "w") as f:
        json.dump(res, f)
    print(f"sphere_curve: {len(res['steps'])} steps in {res['seconds']:.1f} s on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
