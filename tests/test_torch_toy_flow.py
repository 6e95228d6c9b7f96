"""The toy 2-D flow (BASELINE config 1), the port's counterpart of the JAX
package's `tests/test_utils.py::test_toy_2d_flow_pipeline`: train the
conditional flow on an analytic 2-D density from the port's 1-D
distribution library (300 pretrain and 800 flow-matching steps at batch
4096, Adam 3e-3, on the CPU), then hold it to JAX's thresholds:
KL(sample histogram || analytic pdf) < 0.15 for the draws of the T = 8
ODE, and KL(analytic grid || learned pdf grid) < 0.2 for its reverse-Euler
pdf, both on 24 x 24 cells over [-0.6, 1] x [0, 1]."""

import numpy as np
import torch

from bsdf_diffusion_sampling_tpu_torch.core import prng
from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig
from bsdf_diffusion_sampling_tpu_torch.models import encode_condition, get_base, velocity_init
from bsdf_diffusion_sampling_tpu_torch.ode import ode_pdf, ode_sample
from bsdf_diffusion_sampling_tpu_torch.train import init_state, make_diffusion_step, make_pretrain_step
from bsdf_diffusion_sampling_tpu_torch.train.stages import detached
from bsdf_diffusion_sampling_tpu_torch.utils import kl_divergence_grid, pdf_grid_2d, sampler_vs_pdf_kl
from bsdf_diffusion_sampling_tpu_torch.utils.distributions1d import Beta, Gaussian, TwoDCombination

SEED, N_DATA, BATCH = 0, 60_000, 4096
GRID = dict(lo=(-0.6, 0.0), hi=(1.0, 1.0), bins=24, device="cpu")


def test_toy_2d_flow_pipeline():
    target = TwoDCombination(Gaussian(0.2, 0.25), Beta(2.0, 4.0))
    rng = np.random.default_rng(SEED)
    u = torch.from_numpy(rng.uniform(1e-7, 1.0 - 1e-7, (2, N_DATA)).astype(np.float32))
    xy = target.sample_from(u[0], u[1])
    dataset = torch.cat([torch.zeros(N_DATA, 2), xy], dim=1)  # omega_i = 0: an unconditional density

    cfg = ModelConfig(domain="disk")
    base = get_base("disk")
    b_state = init_state(base.init(prng.stage_generator(SEED, "init/base", "cpu")), 3e-3)
    pre = make_pretrain_step("disk")
    for i in range(300):
        pre.update(b_state, pre.draw(dataset, prng.iter_generator(SEED, i, "cpu"), BATCH))
    b_params = detached(b_state.params)

    d_state = init_state(velocity_init(prng.stage_generator(SEED, "init/simpler", "cpu"), cfg), 3e-3)
    dif = make_diffusion_step("disk", cfg)
    for i in range(800):
        dif.update(d_state, dif.draw(b_params, dataset, prng.iter_generator(SEED + 1, i, "cpu"), BATCH))
    v_params = detached(d_state.params)

    with torch.no_grad():
        n = 60_000
        wi = torch.zeros(n, 2)
        x, pdf = ode_sample("disk", v_params, b_params, wi, encode_condition(wi, cfg), 8,
                            eps=prng.root_generator(SEED + 5, "cpu"))
        assert torch.isfinite(x).all() and torch.isfinite(pdf).all()
        kl = sampler_vs_pdf_kl(x.numpy(), target.pdf, **GRID)
        assert kl < 0.15, kl

        grid_pdf = pdf_grid_2d(lambda p: ode_pdf("disk", v_params, b_params, p, torch.zeros_like(p),
                                                 encode_condition(torch.zeros_like(p), cfg), 8), **GRID)
        target_pdf = pdf_grid_2d(target.pdf, **GRID)
        kl_pdf = kl_divergence_grid(target_pdf, grid_pdf)
        assert kl_pdf < 0.2, kl_pdf
