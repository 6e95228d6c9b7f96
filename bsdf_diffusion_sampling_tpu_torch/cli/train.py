"""Training CLI, counterpart of the JAX package's `cli/train.py`.

MCMC dataset (cached to `<out>/mcmc_<domain>_<material>.npy`) -> pretrain
-> flow matching -> rectify, on the card (or the CPU with `--device cpu`);
stage files `<out>/{pretrain,diffusion_simpler,diffusion_complex,rectify}.npz`
are saved every `--save-every` iterations and resumed from, and
`<out>/final.npz` holds {base, diffusion, teacher, rectified} for
`cli/render.py`. The disk domain self-distils its 3 x 32 net; the
spherical domains train a 4 x 32 student and a 6 x 64 teacher.

  python -m bsdf_diffusion_sampling_tpu_torch.cli.train \\
      --domain disk --material chm_mint_rgb --bsdf-dir bsdfs --out checkpoints/chm_mint_disk
  python -m bsdf_diffusion_sampling_tpu_torch.cli.train --domain disk --material ggx:0.5 --device cpu \\
      --mcmc-bands 2 --mcmc-steps 200 --mcmc-burnin 100 --batch-pretrain 1024 --iters-pretrain 10 \\
      --batch-diffusion 1024 --iters-diffusion 10 --iters-rectify 3 --timestep-rectify 8 \\
      --num-samples-rectify 64 --batch-wi-rectify 4 --out out/ggx_disk

Materials: an RGL .bsdf basename (measured, in `--bsdf-dir`),
"ggx:<roughness>" (analytic) or "table:<idx>" (the material table). Integer
arguments accept expressions such as "2**16" or "4900000*2".

Data-parallel over several processes under torchrun (one card a process;
`TrainConfig.mesh_axes` names the mesh, -1 the whole group): rank 0 makes
the MCMC dataset and its cache, every rank loads it after a barrier, every
stage runs data-parallel, and only rank 0 logs and writes files:

  torchrun --nproc-per-node 4 -m bsdf_diffusion_sampling_tpu_torch.cli.train \
      --domain disk --material chm_mint_rgb --bsdf-dir bsdfs --out checkpoints/chm_mint_disk
"""

from __future__ import annotations

import argparse
import os
import time


def _int_expr(v: str) -> int:
    from bsdf_diffusion_sampling_tpu_torch.core.config import safe_int_expr

    return safe_int_expr(v)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--domain", choices=["disk", "spherical", "sphere_full"], default="disk")
    p.add_argument("--material", default="chm_mint_rgb")
    p.add_argument("--bsdf-dir", default="", help="the directory of the .bsdf files (measured materials)")
    p.add_argument("--out", default="checkpoints/run")
    p.add_argument("--seed", type=int, default=0)
    # the reference's defaults (`disk_domain_sampling.py:144-153`)
    p.add_argument("--batch-pretrain", type=_int_expr, default=9_800_000)
    p.add_argument("--iters-pretrain", type=_int_expr, default=10_000)
    p.add_argument("--batch-diffusion", type=_int_expr, default=4_900_000)
    p.add_argument("--iters-diffusion", type=_int_expr, default=40_000)
    p.add_argument("--iters-rectify", type=_int_expr, default=40_000)
    p.add_argument("--timestep-rectify", type=_int_expr, default=256)
    p.add_argument("--num-samples-rectify", type=_int_expr, default=2**16)
    p.add_argument("--batch-wi-rectify", type=_int_expr, default=2**6)
    p.add_argument("--mcmc-steps", type=_int_expr, default=40_000)
    p.add_argument("--mcmc-walkers", type=_int_expr, default=50)
    p.add_argument("--mcmc-burnin", type=_int_expr, default=10_000)
    p.add_argument("--mcmc-bands", type=_int_expr, default=10)
    p.add_argument("--save-every", type=_int_expr, default=1000)
    p.add_argument("--log-every", type=_int_expr, default=100)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p


def make_target_pdf(args, device):
    """Batched (omega_i, omega_o) -> unnormalized density over the chosen
    domain, the domain's Jacobian included (sin theta_o on the spherical
    domains; the disk's 1 / cos theta_o for measured BRDFs, whose eval
    carries cos theta_o)."""
    import torch

    from bsdf_diffusion_sampling_tpu_torch.geometry.coords import disk_to_cart, spher_to_cart

    name = args.material
    if name.startswith("ggx:"):
        from bsdf_diffusion_sampling_tpu_torch.bsdf.analytic import ggx_shading_disk, ggx_shading_spherical

        rough = float(name.split(":", 1)[1])
        if args.domain == "disk":
            return lambda wi, wo: ggx_shading_disk(wi, wo, roughness=rough)
        return lambda wi, wo: ggx_shading_spherical(wi, wo, roughness=rough) * torch.sin(wo[:, 0])
    if name.startswith("table:"):
        from bsdf_diffusion_sampling_tpu_torch.bsdf.materials import BSDF_MATERIALS, eval_material
        from bsdf_diffusion_sampling_tpu_torch.bsdf.measured import rgb_to_luminance

        mat = BSDF_MATERIALS[int(name.split(":", 1)[1])]

        def pdf_table(wi, wo):
            wi_c = spher_to_cart(wi[:, 0], wi[:, 1])
            wo_c = spher_to_cart(wo[:, 0], wo[:, 1])
            f = eval_material(mat, wi_c, wo_c)
            if f.ndim == wi_c.ndim:  # rgb
                f = rgb_to_luminance(f)
            return f * torch.sin(wo[:, 0])

        return pdf_table

    from bsdf_diffusion_sampling_tpu_torch.bsdf.measured import eval_lum, load_measured

    brdf = load_measured(os.path.join(args.bsdf_dir, name + ".bsdf"), device=device)
    def pdf_disk(wi, wo):
        wo_c = disk_to_cart(wo)
        return eval_lum(brdf, disk_to_cart(wi), wo_c) / torch.clamp(wo_c[:, 2], min=1e-3)

    def pdf_sph(wi, wo):
        wo_c = spher_to_cart(wo[:, 0], wo[:, 1])
        f = eval_lum(brdf, spher_to_cart(wi[:, 0], wi[:, 1]), wo_c)
        return f / torch.clamp(wo_c[:, 2], min=1e-3) * torch.sin(wo[:, 0])

    return pdf_disk if args.domain == "disk" else pdf_sph


def main(argv=None):
    """Train and write `<out>/final.npz`. Returns (params, stats): the
    trained trees, and each stage's iteration times and peak memory plus
    the MCMC's seconds. Under torchrun (or in a process whose default group
    is already formed) every stage runs data-parallel over the group."""
    args = build_parser().parse_args(argv)
    import torch.distributed as dist

    from bsdf_diffusion_sampling_tpu_torch.core.config import TrainConfig
    from bsdf_diffusion_sampling_tpu_torch.core.device import resolve_device
    from bsdf_diffusion_sampling_tpu_torch.parallel import init_distributed, make_mesh

    device = resolve_device(args.device)
    train_cfg = TrainConfig(
        batch_pretrain=args.batch_pretrain, iters_pretrain=args.iters_pretrain,
        batch_diffusion=args.batch_diffusion, iters_diffusion=args.iters_diffusion,
        iters_rectify=args.iters_rectify, timestep_rectify=args.timestep_rectify,
        num_samples_rectify=args.num_samples_rectify, batch_wi_rectify=args.batch_wi_rectify,
        save_every=args.save_every, log_every=args.log_every, seed=args.seed, checkpoint_dir=args.out)
    formed_here = not dist.is_initialized()
    init_distributed(device_type=device.type)
    mesh = None
    if dist.is_initialized():
        (axis, n_dev), = train_cfg.mesh_axes
        mesh = make_mesh(n_dev, axis_name=axis, device_type=device.type)
        device = mesh.device
    try:
        return _train(args, train_cfg, device, mesh)
    finally:
        if formed_here and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, train_cfg, device, mesh):
    import torch

    from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig
    from bsdf_diffusion_sampling_tpu_torch.data.datasets import generate_brdf_dataset
    from bsdf_diffusion_sampling_tpu_torch.parallel.mesh import barrier
    from bsdf_diffusion_sampling_tpu_torch.train.checkpoint import save_pytree
    from bsdf_diffusion_sampling_tpu_torch.train.stages import train_material

    lead = mesh is None or mesh.rank == 0
    say = (lambda s: print(s, flush=True)) if lead else (lambda s: None)
    os.makedirs(args.out, exist_ok=True)
    pdf_fn = make_target_pdf(args, device)
    cache = os.path.join(args.out, f"mcmc_{args.domain}_{args.material.replace(':', '_')}.npy")
    say(f"[data] MCMC dataset ({args.mcmc_bands} bands x {args.mcmc_steps} steps x {args.mcmc_walkers} walkers) "
        f"-> {cache}")
    t0 = time.perf_counter()

    def dataset_or_cache():
        return generate_brdf_dataset(args.seed, pdf_fn, domain=args.domain, nsteps=args.mcmc_steps,
                                     nwalkers=args.mcmc_walkers, piecewise=args.mcmc_bands,
                                     burn_in=args.mcmc_burnin, cache_path=cache, device=device)

    # rank 0 makes the dataset and writes the cache; the others read it
    dataset = dataset_or_cache() if lead else None
    if mesh is not None:
        barrier(mesh)
        if not lead:
            dataset = dataset_or_cache()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stats = {"mcmc": {"seconds": time.perf_counter() - t0}}
    say(f"[data] dataset {tuple(dataset.shape)} ({stats['mcmc']['seconds']:.2f} s)")

    if args.domain == "disk":
        model_cfg, teacher_cfg = ModelConfig(domain="disk"), None  # disk self-distils
    else:
        model_cfg = ModelConfig(domain=args.domain, velocity_hidden=32, velocity_layers=4)
        teacher_cfg = ModelConfig(domain=args.domain, velocity_hidden=64, velocity_layers=6)
    params = train_material(dataset, model_cfg, train_cfg, teacher_cfg=teacher_cfg, log_fn=say, device=device,
                            stats=stats, mesh=mesh)
    if lead:  # step records the final rectify iteration, as the JAX CLI's does
        save_pytree(os.path.join(args.out, "final.npz"), params, step=train_cfg.iters_rectify)
    say(f"[done] wrote {args.out}/final.npz")
    return params, stats


if __name__ == "__main__":
    main()
