"""Shared set-up of the PyTorch port's parity tests.

One set of full-width disk weights, made with the JAX package's own
initialisers from a fixed key (velocity weights scaled by 0.5 so that the
Euler map stays invertible, as tests/test_fused_sample_pdf.py does), and
inputs drawn with numpy. Both go to both packages: to JAX as arrays, to
the port through `params_from_jax` as float32 CPU tensors.
"""

from types import SimpleNamespace

import jax
import numpy as np
import torch

from bsdf_diffusion_sampling_tpu.core.config import ModelConfig
from bsdf_diffusion_sampling_tpu.models import get_base, velocity_init
from bsdf_diffusion_sampling_tpu.models.velocity import encode_condition
from bsdf_diffusion_sampling_tpu_torch.interop.jax_params import params_from_jax
from bsdf_diffusion_sampling_tpu_torch.models.velocity import encode_condition as t_encode_condition

T = 4


def tt(a) -> torch.Tensor:
    """A float32 CPU tensor holding a copy of `a` (numpy or JAX)."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


def disk_setup(n: int = 256, seed: int = 0) -> SimpleNamespace:
    cfg = ModelConfig(domain="disk")
    k1, k2 = jax.random.split(jax.random.key(seed))
    v = jax.tree.map(lambda w: w * 0.5, velocity_init(k1, cfg))
    b = get_base("disk").init(k2)
    rng = np.random.default_rng(seed)
    omega = rng.uniform(-0.6, 0.6, (n, 2)).astype(np.float32)
    return SimpleNamespace(
        cfg=cfg, v=v, b=b, tv=params_from_jax(v, "cpu"), tb=params_from_jax(b, "cpu"),
        omega=omega, cond=encode_condition(omega, cfg), t_omega=tt(omega),
        t_cond=t_encode_condition(tt(omega), cfg), rng=rng, n=n)


def sph_setup(n: int = 256, seed: int = 0, domain: str = "spherical") -> SimpleNamespace:
    """The 4 x 32 spherical velocity net (x 0.5) and the spherical base, as
    tests/test_fused_sample_pdf.py:210-216 makes them, and omega_i = (theta
    in [0.1, 1.4], phi in [-3, 3])."""
    cfg = ModelConfig(domain=domain, velocity_hidden=32, velocity_layers=4)
    k1, k2 = jax.random.split(jax.random.key(seed))
    v = jax.tree.map(lambda w: w * 0.5, velocity_init(k1, cfg))
    b = get_base(domain).init(k2)
    rng = np.random.default_rng(seed)
    omega = np.stack([rng.uniform(0.1, 1.4, n), rng.uniform(-3.0, 3.0, n)], -1).astype(np.float32)
    return SimpleNamespace(
        cfg=cfg, v=v, b=b, tv=params_from_jax(v, "cpu"), tb=params_from_jax(b, "cpu"),
        omega=omega, cond=encode_condition(omega, cfg), t_omega=tt(omega),
        t_cond=t_encode_condition(tt(omega), cfg), rng=rng, n=n)


def jax_spherical_draw(key, heads, n: int):
    """What the JAX spherical base draws from `key` (`base_density.py:92-98`),
    as (eps_g, u_von, phi): the port takes (eps_g, u_von), or (eps_g, phi)."""
    from bsdf_diffusion_sampling_tpu.models.von_mises import von_mises_sample

    k_gauss, k_von = jax.random.split(key)
    eps_g = jax.random.normal(k_gauss, (n,))
    u_von = jax.random.uniform(k_von, (16, 3, n), minval=1e-7, maxval=1.0 - 1e-7)
    return tt(eps_g), tt(u_von), tt(von_mises_sample(k_von, heads[2], heads[3]))


def soups(meshes, mids):
    """The same meshes as a JAX soup and as a port soup."""
    from bsdf_diffusion_sampling_tpu.render import mesh as jmesh
    from bsdf_diffusion_sampling_tpu_torch.render import mesh as tmesh

    jm = [jmesh.Mesh(m.positions, m.normals, m.uvs, m.faces) for m in meshes]
    return jmesh.build_soup(jm, mids), tmesh.build_soup(meshes, mids)


def sphere_on_plane():
    """A small matball scene: a UV sphere (material 2) resting on a grid
    plane (material 0), as meshes."""
    from bsdf_diffusion_sampling_tpu_torch.render.mesh import transform_mesh
    from bsdf_diffusion_sampling_tpu_torch.render.procedural import plane_grid, uv_sphere

    lift = np.eye(4)
    lift[1, 3] = 1.0
    return [plane_grid(4, 3.0), transform_mesh(uv_sphere(10, 14), lift)], [0, 2]


def random_meshes(rng: np.random.Generator, n_tris: int = 300):
    """A soup of small random triangles in a unit box, no normals or uvs."""
    from bsdf_diffusion_sampling_tpu_torch.render.mesh import Mesh

    v0 = rng.uniform(-1, 1, (n_tris, 3))
    pos = np.concatenate([v0, v0 + rng.normal(0, 0.15, (n_tris, 3)), v0 + rng.normal(0, 0.15, (n_tris, 3))])
    faces = np.stack([np.arange(n_tris), np.arange(n_tris) + n_tris, np.arange(n_tris) + 2 * n_tris], -1)
    return [Mesh(pos.astype(np.float32), None, None, faces.astype(np.int32))], [0]


def write_synthetic_bsdf(path: str, seed: int = 0, **kw) -> dict:
    """Write a synthesized isotropic RGL tensor file with the port's writer;
    returns the tensors."""
    from bsdf_diffusion_sampling_tpu_torch.bsdf.tensorfile import write_tensor_file
    from bsdf_diffusion_sampling_tpu_torch.render.procedural import synthetic_measured_tensors

    tf = synthetic_measured_tensors(seed, **kw)
    write_tensor_file(path, tf)
    return tf


def hemisphere(rng: np.random.Generator, n: int) -> np.ndarray:
    """Local directions with cos(theta) in [0.1, 0.95]."""
    u = rng.random((n, 2), dtype=np.float32)
    ct = 0.1 + 0.85 * u[:, 0]
    st = np.sqrt(1.0 - ct * ct)
    phi = 2.0 * np.pi * u[:, 1]
    return np.stack([st * np.cos(phi), st * np.sin(phi), ct], axis=-1).astype(np.float32)


def assert_mostly_close(a, b, rtol=1e-4, atol=1e-6, min_share=0.995, all_atol=2e-2):
    """|a - b| <= atol + rtol |b| on at least `min_share` of the rows, and
    every element within `all_atol` (None: no bound on every row). The share
    allows for a 1-ulp difference that moves a bisection or an inverse-CDF
    step across a cell boundary."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    close = np.abs(a - b) <= atol + rtol * np.abs(b)
    rows = close.reshape(len(a), -1).all(-1)
    assert rows.mean() >= min_share, rows.mean()
    if all_atol is not None:
        assert np.abs(a - b).max() <= all_atol, np.abs(a - b).max()
