"""The port's public names against the JAX package's: every subpackage's
re-exports, and the functions that only those re-exports and the JAX tests
name (`latest_step`, `flatten_mlp`, `accumulate_film`, `linspace_alpha`'s
device). Same numpy inputs to both packages."""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import ast
import importlib
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsdf_diffusion_sampling_tpu.models.mlp as jmlp
import bsdf_diffusion_sampling_tpu.render.camera as jcam
import bsdf_diffusion_sampling_tpu.train.checkpoint as jckpt
import bsdf_diffusion_sampling_tpu_torch.models.mlp as tmlp
import bsdf_diffusion_sampling_tpu_torch.render.camera as tcam
import bsdf_diffusion_sampling_tpu_torch.train.checkpoint as tckpt
import bsdf_diffusion_sampling_tpu_torch.train.losses as tlosses

# left out by design: the TPU lane packing of the velocity weights
LEFT_OUT = {"pack_weights"}
SUBPACKAGES = ["", "bsdf", "core", "data", "geometry", "interop", "models", "ode", "ops", "parallel", "render",
               "train", "utils"]


def exported(mod) -> set:
    """The names an `__init__.py` imports from elsewhere (its re-exports)."""
    tree = ast.parse(Path(mod.__file__).read_text())
    return {a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom) for a in node.names}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_the_jax_package_names(sub):
    """Each port `__init__.py` re-exports what its JAX counterpart does
    (less `pack_weights`); every name resolves on the port package, and is
    a module, a callable or a value where JAX's is."""
    jmod = importlib.import_module("bsdf_diffusion_sampling_tpu" + (f".{sub}" if sub else ""))
    tmod = importlib.import_module("bsdf_diffusion_sampling_tpu_torch" + (f".{sub}" if sub else ""))
    names = exported(jmod) - LEFT_OUT
    assert names and exported(tmod) == names
    for n in names:
        jobj, tobj = getattr(jmod, n), getattr(tmod, n)
        assert (inspect.ismodule(tobj), callable(tobj)) == (inspect.ismodule(jobj), callable(jobj)), n


def test_load_measured_imports_from_the_subpackage():
    from bsdf_diffusion_sampling_tpu_torch.bsdf import load_measured
    from bsdf_diffusion_sampling_tpu_torch.bsdf.measured import load_measured as direct

    assert load_measured is direct


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_latest_step_matches_jax(tmp_path, writer):
    """JAX `train/checkpoint.py::latest_step`: the stored `__step__` of a
    file either package wrote, exactly; -1 for an absent path."""
    tree = {"base": {"net": [{"w": np.arange(6, dtype=np.float32).reshape(2, 3)}]}}
    path = str(tmp_path / "stage.npz")
    (jckpt if writer == "jax" else tckpt).save_pytree(path, tree, step=1234)
    assert tckpt.latest_step(path) == jckpt.latest_step(path) == 1234
    absent = str(tmp_path / "absent.npz")
    assert tckpt.latest_step(absent) == jckpt.latest_step(absent) == -1


@pytest.mark.parametrize("bias", [False, True])
def test_flatten_mlp_matches_jax(bias):
    """JAX `models/mlp.py::flatten_mlp`: bit-equal on the same weights."""
    params = jmlp.init_mlp(jax.random.key(3), [5, 7, 3], bias=bias)
    got = tmlp.flatten_mlp([{k: torch.from_numpy(np.asarray(v)) for k, v in layer.items()} for layer in params])
    want = np.asarray(jmlp.flatten_mlp(params))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_accumulate_film_matches_jax():
    """JAX `render/camera.py::accumulate_film` (`segment_sum`), to 1e-6,
    with repeated pixel indices."""
    rng = np.random.default_rng(0)
    w, h, n = 7, 5, 300
    px = rng.integers(0, w * h, n).astype(np.int32)
    rad = rng.uniform(0, 4, (n, 3)).astype(np.float32)
    img, cnt = tcam.accumulate_film(torch.from_numpy(px), torch.from_numpy(rad), w, h)
    jimg, jcnt = jcam.accumulate_film(jnp.asarray(px), jnp.asarray(rad), w, h)
    assert img.shape == (h, w, 3) and cnt.shape == (h, w)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    assert cnt.sum() == n and cnt.max() > 1


def test_linspace_alpha_defaults_to_the_card():
    """Like every entry point of the port: CUDA unless asked for the CPU."""
    assert inspect.signature(tlosses.linspace_alpha).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tlosses.linspace_alpha(4)
