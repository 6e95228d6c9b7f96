"""Render CLI, counterpart of the JAX package's `cli/render.py`.

Loads a matpreview-style scene, installs the matball material, renders spp
samples in accumulation passes on the card (or the CPU with
`--device cpu`), writes EXR + PNG and prints the wall-clock time. The
matball is a measured BRDF (`scene_measured.xml`: `--mode gt` samples the
measured BRDF itself, `neural-disk` and `neural-spherical` a trained
sampler) or a material-table entry with an albedo tint (`scene_bsdf.xml`:
`gt` samples a two-sided cosine lobe, `neural-sphere` the trained
full-sphere sampler). A neural sampler's weights come from one `.npz`
(`--weights checkpoint`, the default: `--checkpoint`) or from the reference
implementation's `.pth` checkpoint directory of each matball's material
(`--weights reference`: `--reference-ckpts`; a measured ball reads
`<filename>_<domain>/`, a material-table ball `bsdf_<idx>_spherical/`). A
measured matball whose `.bsdf` file is missing is an error, unless
`--allow-substitute` renders `chm_mint_rgb.bsdf` in its place and records
it in `<out>.meta.json`.

  python -m bsdf_diffusion_sampling_tpu_torch.cli.render \\
      --scene scene_measured.xml --bsdf-dir bsdfs --material chm_mint_rgb --mode gt --out out/gt
  python -m bsdf_diffusion_sampling_tpu_torch.cli.render \\
      --scene scene_measured.xml --bsdf-dir bsdfs --material chm_mint_rgb --mode neural-disk \\
      --checkpoint checkpoints/chm_mint_disk/final.npz --out out/nn
  python -m bsdf_diffusion_sampling_tpu_torch.cli.render \\
      --scene scene_bsdf.xml --mode neural-sphere --checkpoint bsdf_20_sphere.npz --out out/sphere
  python -m bsdf_diffusion_sampling_tpu_torch.cli.render \\
      --scene scene_measured.xml --bsdf-dir bsdfs --material chm_mint_rgb --mode neural-disk \\
      --weights reference --reference-ckpts checkpoints_new --out out/nn_ref
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import time
import zlib

import numpy as np


MODES = {"gt": None, "neural-disk": "disk", "neural-spherical": "spherical", "neural-sphere": "sphere_full"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", required=True, help="a matpreview-style scene XML")
    p.add_argument("--material", default="chm_mint_rgb", help="the matball's <material>.bsdf file")
    p.add_argument("--bsdf-dir", default="", help="the directory of the .bsdf files (measured matballs)")
    p.add_argument("--mode", choices=list(MODES), default="gt",
                   help="gt: the material samples itself; neural-*: the trained sampler of that domain")
    p.add_argument("--checkpoint", default="", help="an .npz checkpoint (neural modes with --weights checkpoint)")
    p.add_argument("--weights", choices=["checkpoint", "reference"], default="checkpoint",
                   help="neural modes: 'checkpoint' loads --checkpoint; 'reference' imports each matball's "
                        "reference .pth checkpoint directory from --reference-ckpts")
    p.add_argument("--reference-ckpts", default="",
                   help="the directory of the reference's <material>_<domain>/ checkpoint directories")
    p.add_argument("--allow-substitute", action="store_true",
                   help="render chm_mint_rgb (from --bsdf-dir) for a measured matball whose .bsdf file is "
                        "missing, recorded in <out>.meta.json; without the flag a missing file is an error")
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--spp-chunk", type=int, default=4)
    p.add_argument("--max-depth", type=int, default=12)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="out/render")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p


def tonemap_srgb(img: np.ndarray) -> np.ndarray:
    lo = img <= 0.0031308
    srgb = np.where(lo, img * 12.92, 1.055 * np.power(np.clip(img, 1e-8, None), 1 / 2.4) - 0.055)
    return np.clip(srgb, 0.0, 1.0)


def write_png(path: str, rgb8: np.ndarray) -> None:
    """An 8-bit RGB PNG with zlib and struct alone."""
    h, w, _ = rgb8.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), np.ascontiguousarray(rgb8, np.uint8).reshape(h, 3 * w)], 1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


def model_cfg(domain: str):
    """The rendered net's config: disk 3 x 32, spherical 4 x 32 (the 6 x 64
    spherical teacher is used in training only)."""
    from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig

    if domain == "disk":
        return ModelConfig(domain="disk")
    return ModelConfig(domain=domain, velocity_hidden=32, velocity_layers=4)


def load_neural_params(ball: dict, domain: str, args, device) -> dict:
    """A matball's neural weights: the one `--checkpoint` file, or the
    reference checkpoint directory of the ball's material (its filename when
    idx < 0, else its table index)."""
    if args.weights == "reference":
        from bsdf_diffusion_sampling_tpu_torch.interop import import_reference_material

        if not args.reference_ckpts:
            raise ValueError("--weights reference needs --reference-ckpts")
        material = ball["filename"] if ball["idx"] < 0 else str(ball["idx"])
        return import_reference_material(args.reference_ckpts, material, domain, device=device)
    from bsdf_diffusion_sampling_tpu_torch.train.checkpoint import load_pytree

    if not args.checkpoint:
        raise ValueError(f"--mode {args.mode} needs --checkpoint")
    return load_pytree(args.checkpoint)[0]


def build_matball(ball: dict, args, device, substitutions: list | None = None):
    """One MatballFns for one mybsdf hook: a measured BRDF (idx < 0) or a
    material-table entry with its albedo. A missing `.bsdf` file raises
    unless `args.allow_substitute`; each substitution is appended to
    `substitutions`."""
    from bsdf_diffusion_sampling_tpu_torch.render import integrator

    domain = MODES[args.mode]
    table = ball["idx"] >= 0
    if domain is not None and table != (domain == "sphere_full"):
        raise ValueError(f"--mode {args.mode} renders a {'measured' if table else 'material-table'} matball; "
                         f"this scene's is a {'material-table' if table else 'measured'} one")
    if table:
        from bsdf_diffusion_sampling_tpu_torch.bsdf.materials import BSDF_MATERIALS

        mat, albedo, brdf = BSDF_MATERIALS[ball["idx"]], ball["albedo"], None
    else:
        from bsdf_diffusion_sampling_tpu_torch.bsdf.measured import load_measured

        path = os.path.join(args.bsdf_dir, ball["filename"] + ".bsdf")
        if not os.path.exists(path):
            if not args.allow_substitute:
                raise FileNotFoundError(f"{path} does not exist; rerun with --allow-substitute to render "
                                        "chm_mint_rgb in its place (recorded in <out>.meta.json)")
            print(f"warning: {path} does not exist; substituting chm_mint_rgb for ball {ball['filename']!r}")
            if substitutions is not None:
                substitutions.append({"ball": ball["filename"], "substituted": "chm_mint_rgb"})
            path = os.path.join(args.bsdf_dir, "chm_mint_rgb.bsdf")
        brdf = load_measured(path, device=device)
    if domain is None:
        return integrator.principled_matball(mat, albedo, device=device) if table else integrator.measured_matball(brdf)

    from bsdf_diffusion_sampling_tpu_torch.render.neural import make_neural_bsdf

    params = load_neural_params(ball, domain, args, device)
    nb = make_neural_bsdf(domain, model_cfg(domain), params["rectified"], params["base"], brdf, device=device)
    return integrator.neural_matball_sphere(nb, mat, albedo) if table else integrator.neural_matball(nb)


def main(argv=None):
    """Render and write `<out>.exr` and `<out>.png`. Returns (image, the
    render's wall-clock seconds)."""
    args = build_parser().parse_args(argv)
    from bsdf_diffusion_sampling_tpu_torch.core.device import resolve_device
    from bsdf_diffusion_sampling_tpu_torch.native.exr import write_exr
    from bsdf_diffusion_sampling_tpu_torch.render.integrator import render
    from bsdf_diffusion_sampling_tpu_torch.render.scene import load_scene

    device = resolve_device(args.device)
    scene = load_scene(args.scene, device=device, width=args.width, height=args.height)
    balls = [dict(b) for b in scene.desc.matballs]
    if len(balls) == 1 and balls[0]["idx"] < 0:
        # single-measured-ball scenes render whatever --material says
        balls[0]["filename"] = args.material
    substitutions: list = []
    mb = tuple(build_matball(b, args, device, substitutions) for b in balls)

    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    img = render(scene, mb, seed=args.seed, spp=args.spp, spp_chunk=args.spp_chunk, max_depth=args.max_depth,
                 device=device)
    dt = time.perf_counter() - t0
    n_rays = args.width * args.height * args.spp
    print(f"rendering time: {dt:.2f} s  ({n_rays / dt / 1e6:.3f} Mray-samples/s)")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_exr(args.out + ".exr", img)
    write_png(args.out + ".png", (tonemap_srgb(img) * 255).astype(np.uint8))
    if substitutions:
        with open(args.out + ".meta.json", "w") as f:
            json.dump({"material_substitutions": substitutions, "mode": args.mode, "material": args.material}, f,
                      indent=1)
        print(f"wrote {args.out}.meta.json (material substitutions)")
    print(f"wrote {args.out}.exr / .png")
    return img, dt


if __name__ == "__main__":
    main()
