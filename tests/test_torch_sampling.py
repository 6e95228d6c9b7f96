"""The port's stratified samplers and angle maps against the JAX
package's (`geometry/sampling.py`, `geometry/coords.py`).

The concentric map is the same float32 arithmetic on both sides, with sin
and cos from other libraries: 1e-6 absolute. The lattices draw from other
streams (torch's generator, `jax.random`), so they are held to their
contract instead: one point in each of n distinct cells.
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdf_diffusion_sampling_tpu.geometry import coords as jc
from bsdf_diffusion_sampling_tpu.geometry import sampling as js
from bsdf_diffusion_sampling_tpu_torch.core.prng import root_generator
from bsdf_diffusion_sampling_tpu_torch.geometry import coords as tc
from bsdf_diffusion_sampling_tpu_torch.geometry import sampling as ts

from _torch_port import tt


def _square_points() -> np.ndarray:
    """The origin, both diagonals, the axes, the corners and random points."""
    t = np.linspace(-1.0, 1.0, 9)
    special = np.concatenate([np.zeros((1, 2)), np.stack([t, t], -1), np.stack([t, -t], -1),
                              np.stack([t, np.zeros_like(t)], -1), np.stack([np.zeros_like(t), t], -1)])
    rand = np.random.default_rng(0).uniform(-1, 1, (512, 2))
    return np.concatenate([special, rand]).astype(np.float32)


def test_concentric_map_matches_jax():
    uv = _square_points()
    got = ts.concentric_square_to_disk(tt(uv)).numpy()
    np.testing.assert_allclose(got, np.asarray(js.concentric_square_to_disk(jnp.asarray(uv))), atol=1e-6)
    assert np.array_equal(got[0], [0.0, 0.0])
    assert (np.sum(got**2, -1) <= 1.0 + 1e-6).all()


@pytest.mark.parametrize("n", [64, 50, 1])
def test_lattice_puts_one_point_in_each_of_n_cells(n):
    side = math.isqrt(n) + (math.isqrt(n) ** 2 < n)
    uv = ts.stratified_sampling_2d(root_generator(3, "cpu"), n)
    assert uv.shape == (n, 2) and uv.dtype == torch.float32
    assert bool(((uv >= 0) & (uv < 1)).all())
    cells = (uv * side).floor().to(torch.int64)
    ids = cells[:, 0] * side + cells[:, 1]
    assert torch.unique(ids).numel() == n
    if side * side == n:
        assert sorted(ids.tolist()) == list(range(n))


def test_stratified_disk_and_hemisphere_ranges():
    g = root_generator(4, "cpu")
    d = ts.stratified_disk(g, 100)
    assert d.shape == (100, 2) and bool(((d**2).sum(-1) <= 1.0 + 1e-6).all())
    for theta_max in (math.pi / 2, math.pi):
        a = ts.stratified_hemisphere_angles(g, 100, theta_max)
        assert bool(((a[:, 0] >= 0) & (a[:, 0] < theta_max)).all())
        assert bool(((a[:, 1] >= -math.pi) & (a[:, 1] < math.pi)).all())
    # the same generator state gives the same points
    assert torch.equal(ts.stratified_disk(root_generator(5, "cpu"), 64), ts.stratified_disk(root_generator(5, "cpu"), 64))


def test_shortest_arc_delta_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(-math.pi, math.pi, 256).astype(np.float32)
    b = rng.uniform(-math.pi, math.pi, 256).astype(np.float32)
    a[:4] = [3.1, -3.1, math.pi - 1e-3, 0.0]
    b[:4] = [-3.1, 3.1, -math.pi + 1e-3, 0.0]
    got = tc.shortest_arc_delta(tt(a), tt(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jc.shortest_arc_delta(jnp.asarray(a), jnp.asarray(b))), atol=1e-6)
    assert (np.abs(got) <= math.pi).all()
    np.testing.assert_allclose(got[:2], [6.2 - 2 * math.pi, 2 * math.pi - 6.2], atol=1e-5)
