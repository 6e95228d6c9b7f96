"""Trained-sampler quality on the CPU, the port's counterparts of the JAX
package's slow trained tests: `tests/test_train.py:50-128` (disk, an
analytic GGX target; five tests) and `tests/test_train_spherical.py`
(hemisphere with a 5 x 64 teacher, and the full sphere; eight tests).
The fixtures train at JAX's sizes (MCMC 4 bands x 600 sweeps x 50 walkers;
400 pretrain, 800 or 700 flow-matching, 60 or 50 rectify iterations at the
same batches and learning rates) with `device="cpu"` in one process where
JAX uses an 8-device mesh, and every threshold is JAX's. Minutes of CPU
work: marked slow, as JAX marks its own."""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import math

import numpy as np
import pytest
import torch

from bsdf_diffusion_sampling_tpu_torch.bsdf import ggx_shading_disk, ggx_shading_spherical
from bsdf_diffusion_sampling_tpu_torch.core import prng
from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig, TrainConfig
from bsdf_diffusion_sampling_tpu_torch.core.tree import tree_leaves
from bsdf_diffusion_sampling_tpu_torch.data import generate_brdf_dataset
from bsdf_diffusion_sampling_tpu_torch.models import encode_condition, get_base
from bsdf_diffusion_sampling_tpu_torch.ode import ode_pdf, ode_sample
from bsdf_diffusion_sampling_tpu_torch.train import checkpoint as ckpt
from bsdf_diffusion_sampling_tpu_torch.train import train_material

pytestmark = pytest.mark.slow  # training fixtures: minutes on the CPU

CPU = "cpu"


def _gen(seed):
    return prng.root_generator(seed, CPU)


def _wi(value, n):
    return torch.tensor(value, dtype=torch.float32).expand(n, 2).contiguous()


def _wrap_phi(phi):
    return np.mod(phi + np.pi, 2 * np.pi) - np.pi


def _train_cfg(iters_diffusion, iters_rectify, seed):
    return TrainConfig(batch_pretrain=4096, iters_pretrain=400, lr_pretrain=3e-3, batch_diffusion=4096,
                       iters_diffusion=iters_diffusion, lr_diffusion=3e-3, iters_rectify=iters_rectify,
                       timestep_rectify=32, num_samples_rectify=256, batch_wi_rectify=16, checkpoint_dir="",
                       log_every=0, seed=seed)


def _sample(domain, params, net, wi, cfg, seed, T):
    return ode_sample(domain, params[net], params["base"], wi, encode_condition(wi, cfg), T, eps=_gen(seed))


def _pdf_gap(domain, params, cfg, wi, seed, T):
    """Median |reverse pdf / forward pdf - 1| of the diffusion net at T."""
    x, pdf_fwd = _sample(domain, params, "diffusion", wi, cfg, seed, T)
    pdf_rev = ode_pdf(domain, params["diffusion"], params["base"], x, wi, encode_condition(wi, cfg), T)
    return float(torch.median(torch.abs(pdf_rev / pdf_fwd - 1.0)))


# ------------------------------------------------------------------ disk ----


@pytest.fixture(scope="module")
def trained():
    dataset = generate_brdf_dataset(7, lambda wi, wo: ggx_shading_disk(wi, wo, roughness=0.5), domain="disk",
                                    nsteps=600, nwalkers=50, piecewise=4, burn_in=300, device=CPU)
    model_cfg = ModelConfig(domain="disk")
    params = train_material(dataset, model_cfg, _train_cfg(800, 60, 3), log_fn=lambda s: None, device=CPU)
    return params, model_cfg, dataset


@torch.no_grad()
def test_pretrain_learns_coarse_density(trained):
    """JAX `test_train.py::test_pretrain_learns_coarse_density`: > 0.8 of
    the base density's draws inside the disk."""
    params, _, dataset = trained
    x = get_base("disk").sample(params["base"], dataset[:2048, 0:2], _gen(1))
    assert float((x.pow(2).sum(-1) < 1.0).float().mean()) > 0.8


@torch.no_grad()
def test_trained_sampler_matches_target_moments(trained):
    """JAX `test_trained_sampler_matches_target_moments`: > 0.95 of the T = 8
    draws in |x|^2 < 1.2, the mirrored lobe's mean x < -0.15, pdf finite
    and positive."""
    params, cfg, _ = trained
    x, pdf = _sample("disk", params, "diffusion", _wi([0.45, 0.0], 4096), cfg, 2, 8)
    x = x.numpy()
    assert (np.sum(x ** 2, axis=-1) < 1.2).mean() > 0.95
    assert x[:, 0].mean() < -0.15
    assert torch.isfinite(pdf).all() and (pdf > 0).all()


@torch.no_grad()
def test_trained_sample_pdf_consistency(trained):
    """JAX `test_trained_sample_pdf_consistency`: the forward / reverse pdf
    gap shrinks from T = 16 to 64 and is < 0.1 at 64."""
    params, cfg, _ = trained
    wi = _wi([0.3, 0.2], 512)
    g16, g64 = (_pdf_gap("disk", params, cfg, wi, 4, T) for T in (16, 64))
    assert g64 < g16, (g16, g64)
    assert g64 < 0.1, g64


@torch.no_grad()
def test_rectified_sampler_close_at_one_step(trained):
    """JAX `test_rectified_sampler_close_at_one_step`: the T = 1 rectified
    map's mean within 0.15 of the T = 8 teacher's, same base draws."""
    params, cfg, _ = trained
    wi = _wi([0.45, 0.0], 8192)
    x_t, _ = _sample("disk", params, "diffusion", wi, cfg, 5, 8)
    x_r, _ = _sample("disk", params, "rectified", wi, cfg, 5, 1)
    np.testing.assert_allclose(x_r.numpy().mean(0), x_t.numpy().mean(0), atol=0.15)


def test_checkpoint_roundtrip(tmp_path, trained):
    """JAX `test_checkpoint_roundtrip`: the trained net and its step back
    bit-equal."""
    params, _, _ = trained
    path = str(tmp_path / "ck.npz")
    ckpt.save_pytree(path, params["diffusion"], step=123)
    restored, step = ckpt.load_pytree(path)
    assert step == 123 and ckpt.latest_step(path) == 123
    for a, b in zip(tree_leaves(restored), tree_leaves(params["diffusion"])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ------------------------------------------------------------- hemisphere ----


def _hemisphere_pdf(wi, wo):
    return ggx_shading_spherical(wi, wo, roughness=0.5, diffuse_prob=0.3) * torch.sin(wo[..., 0])


@pytest.fixture(scope="module")
def trained_spherical():
    """JAX `test_train_spherical.py::trained_spherical`: a 4 x 32 student and
    a 5 x 64 teacher on the hemisphere."""
    dataset = generate_brdf_dataset(11, _hemisphere_pdf, domain="spherical", nsteps=600, nwalkers=50,
                                    piecewise=4, burn_in=300, device=CPU)
    student = ModelConfig(domain="spherical", velocity_hidden=32, velocity_layers=4)
    teacher = ModelConfig(domain="spherical", velocity_hidden=64, velocity_layers=5)
    params = train_material(dataset, student, _train_cfg(700, 60, 5), teacher_cfg=teacher,
                            log_fn=lambda s: None, device=CPU)
    return params, student, dataset


@torch.no_grad()
def test_spherical_base_learns_support(trained_spherical):
    """JAX `test_spherical_base_learns_support`: > 0.9 of theta in
    (-0.3, pi/2 + 0.3), every draw finite."""
    params, _, dataset = trained_spherical
    x = get_base("spherical").sample(params["base"], dataset[:2048, 0:2], _gen(1))
    theta = x[:, 0].numpy()
    assert ((theta > -0.3) & (theta < np.pi / 2 + 0.3)).mean() > 0.9
    assert torch.isfinite(x).all()


@torch.no_grad()
def test_spherical_sampler_places_lobe(trained_spherical):
    """JAX `test_spherical_sampler_places_lobe`: the teacher's mass within 90
    degrees of phi = pi within 0.15 of the oracle's own share there."""
    params, _, _ = trained_spherical
    teacher_cfg = ModelConfig(domain="spherical", velocity_hidden=64, velocity_layers=5)
    x, pdf = _sample("spherical", params, "teacher", _wi([0.8, 0.0], 4096), teacher_cfg, 2, 8)
    got = (np.abs(_wrap_phi(x[:, 1].numpy() - np.pi)) < np.pi / 2).mean()

    theta = torch.linspace(0.01, math.pi / 2 - 0.01, 64)
    phi = torch.linspace(-math.pi, math.pi, 129)[:-1]
    grid = torch.stack(torch.meshgrid(theta, phi, indexing="ij"), -1).reshape(-1, 2)
    w = _hemisphere_pdf(_wi([0.8, 0.0], grid.shape[0]), grid).double().numpy()
    in_win = np.abs(_wrap_phi(grid[:, 1].numpy() - np.pi)) < np.pi / 2
    want = float(w[in_win].sum() / w.sum())
    assert abs(got - want) < 0.15, (got, want)
    assert torch.isfinite(pdf).all() and (pdf > 0).all()


@torch.no_grad()
def test_spherical_sample_pdf_consistency(trained_spherical):
    """JAX `test_spherical_sample_pdf_consistency`: the gap shrinks from
    T = 16 to 64 and is < 0.1 at 64."""
    params, cfg, _ = trained_spherical
    wi = _wi([0.6, 0.4], 512)
    g16, g64 = (_pdf_gap("spherical", params, cfg, wi, 4, T) for T in (16, 64))
    assert g64 < g16, (g16, g64)
    assert g64 < 0.1, g64


@torch.no_grad()
def test_spherical_kl_vs_oracle(trained_spherical):
    """JAX `test_spherical_kl_vs_oracle`: grid KL(target || learned T = 32
    pdf) < 0.35 on 48 x 96 (theta, phi) points for omega_i = (0.8, 0)."""
    params, cfg, _ = trained_spherical
    theta = torch.linspace(0.02, math.pi / 2 - 0.02, 48)
    phi = torch.linspace(-math.pi + 0.01, math.pi - 0.01, 96)
    grid = torch.stack(torch.meshgrid(theta, phi, indexing="ij"), -1).reshape(-1, 2)
    wi = _wi([0.8, 0.0], grid.shape[0])
    p = _hemisphere_pdf(wi, grid).double().numpy()
    q = ode_pdf("spherical", params["diffusion"], params["base"], grid, wi, encode_condition(wi, cfg), 32)
    q = np.maximum(q.double().numpy(), 1e-12)
    p, q = p / p.sum(), q / q.sum()
    kl = float(np.sum(p * np.log(p / q + 1e-30)))
    assert kl < 0.35, kl


@torch.no_grad()
def test_spherical_rectified_student_close_to_teacher(trained_spherical):
    """JAX `test_spherical_rectified_student_close_to_teacher`: theta means
    within 0.15 and circular phi means within 0.25 of the T = 8 teacher."""
    params, cfg, _ = trained_spherical
    teacher_cfg = ModelConfig(domain="spherical", velocity_hidden=64, velocity_layers=5)
    wi = _wi([0.8, 0.0], 8192)
    x_t, _ = _sample("spherical", params, "teacher", wi, teacher_cfg, 5, 8)
    x_r, _ = _sample("spherical", params, "rectified", wi, cfg, 5, 1)
    x_t, x_r = x_t.numpy(), x_r.numpy()
    assert abs(x_t[:, 0].mean() - x_r[:, 0].mean()) < 0.15
    ct, st = np.cos(x_t[:, 1]).mean(), np.sin(x_t[:, 1]).mean()
    cr, sr = np.cos(x_r[:, 1]).mean(), np.sin(x_r[:, 1]).mean()
    assert np.hypot(ct - cr, st - sr) < 0.25


# ------------------------------------------------------------ full sphere ----


def _sphere_full_pdf(wi, wo):
    refl = ggx_shading_spherical(wi, wo, roughness=0.5, diffuse_prob=0.4)
    wo_flip = torch.stack([math.pi - wo[..., 0], wo[..., 1]], dim=-1)
    trans = ggx_shading_spherical(wi, wo_flip, roughness=0.5, diffuse_prob=0.4)
    return (refl + 0.7 * trans) * torch.sin(wo[..., 0])


@pytest.fixture(scope="module")
def trained_sphere_full():
    """JAX `trained_sphere_full`: a reflection lobe and a flipped
    transmission lobe over the whole sphere, a 4 x 32 net."""
    dataset = generate_brdf_dataset(23, _sphere_full_pdf, domain="sphere_full", nsteps=600, nwalkers=50,
                                    piecewise=4, burn_in=300, device=CPU)
    cfg = ModelConfig(domain="sphere_full", velocity_hidden=32, velocity_layers=4)
    params = train_material(dataset, cfg, _train_cfg(700, 50, 9), log_fn=lambda s: None, device=CPU)
    return params, cfg


@torch.no_grad()
def test_sphere_full_mass_in_both_hemispheres(trained_sphere_full):
    """JAX `test_sphere_full_mass_in_both_hemispheres`: transmitted share
    in (0.2, 0.6), > 0.95 of theta in (-0.3, pi + 0.3), pdf finite."""
    params, cfg = trained_sphere_full
    x, pdf = _sample("sphere_full", params, "diffusion", _wi([0.7, 0.0], 8192), cfg, 3, 8)
    theta = x[:, 0].numpy()
    frac_trans = (theta > np.pi / 2).mean()
    assert 0.2 < frac_trans < 0.6, frac_trans
    assert ((theta > -0.3) & (theta < np.pi + 0.3)).mean() > 0.95
    assert torch.isfinite(pdf).all()


@torch.no_grad()
def test_sphere_full_sample_pdf_consistency(trained_sphere_full):
    """JAX `test_sphere_full_sample_pdf_consistency`: the gap shrinks from
    T = 16 to 64 and is < 0.12 at 64."""
    params, cfg = trained_sphere_full
    wi = _wi([0.5, -0.3], 512)
    g16, g64 = (_pdf_gap("sphere_full", params, cfg, wi, 6, T) for T in (16, 64))
    assert g64 < g16, (g16, g64)
    assert g64 < 0.12, g64


@torch.no_grad()
def test_sphere_full_rectified_one_step(trained_sphere_full):
    """JAX `test_sphere_full_rectified_one_step`: theta means of the T = 1
    rectified net and the T = 8 diffusion net within 0.2."""
    params, cfg = trained_sphere_full
    wi = _wi([0.7, 0.0], 8192)
    x_t, _ = _sample("sphere_full", params, "diffusion", wi, cfg, 8, 8)
    x_r, _ = _sample("sphere_full", params, "rectified", wi, cfg, 8, 1)
    assert abs(x_t[:, 0].numpy().mean() - x_r[:, 0].numpy().mean()) < 0.2
