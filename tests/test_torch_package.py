"""The PyTorch port as a package: it stands alone (no JAX, nothing of the
JAX package), keeps its own copy of the pure-Python config, runs on the
card unless asked for the CPU, and builds no kernel at import."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import bsdf_diffusion_sampling_tpu.core.config as jcfg
import bsdf_diffusion_sampling_tpu_torch as port
import bsdf_diffusion_sampling_tpu_torch.core.config as tcfg
from bsdf_diffusion_sampling_tpu_torch.core import prng
from bsdf_diffusion_sampling_tpu_torch.ops import cuda_build

PORT_DIR = Path(port.__file__).resolve().parent
REPO = PORT_DIR.parent


def test_import_pulls_in_no_jax():
    code = ("import sys, importlib, pkgutil, bsdf_diffusion_sampling_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m.split('.')[0] == 'bsdf_diffusion_sampling_tpu']\n"
            "print(sorted(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_no_source_names_the_jax_package():
    names_pkg = re.compile(r"bsdf_diffusion_sampling_tpu(?!_torch)")
    imports_jax = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
    sources = [p for p in PORT_DIR.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    assert len(sources) >= 12
    for p in sources:
        text = p.read_text()
        assert not names_pkg.search(text), p
        assert not imports_jax.search(text), p


@pytest.mark.parametrize("name", ["ModelConfig", "SamplerConfig"])
def test_config_copy_matches_jax(name):
    jf = {f.name: f.default for f in dataclasses.fields(getattr(jcfg, name))}
    tf = {f.name: f.default for f in dataclasses.fields(getattr(tcfg, name))}
    assert tf == jf
    for dom in ("disk", "spherical"):
        j, t = jcfg.ModelConfig(domain=dom), tcfg.ModelConfig(domain=dom)
        assert (t.x_enc_dim, t.cond_enc_dim, t.velocity_in_dim) == (j.x_enc_dim, j.cond_enc_dim,
                                                                    j.velocity_in_dim)


@pytest.mark.parametrize("expr", ["2**16", "4900000 * 2", "128", "-3 + 7 // 2"])
def test_safe_int_expr_matches_jax(expr):
    assert tcfg.safe_int_expr(expr) == jcfg.safe_int_expr(expr)


def test_safe_int_expr_refuses_calls():
    with pytest.raises(ValueError):
        tcfg.safe_int_expr("__import__('os')")


def test_generators_are_derived_deterministically():
    assert prng.fold_in(0, "pretrain") == prng.fold_in(0, "pretrain")
    assert len({prng.fold_in(0, "pretrain"), prng.fold_in(0, "rectify"), prng.fold_in(1, "pretrain"),
                prng.fold_in(0, 1), prng.fold_in(0, "1")}) == 5
    a = torch.rand(4, generator=prng.stage_generator(0, "rectify", "cpu"))
    b = torch.rand(4, generator=prng.stage_generator(0, "rectify", "cpu"))
    c = torch.rand(4, generator=prng.iter_generator(0, 3, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    s = prng.draw_seed(prng.root_generator(5, "cpu"))
    assert s.dtype == torch.int64 and s.shape == (1,) and int(s) >= 0


def test_make_neural_bsdf_defaults_to_the_card():
    """No CPU fallback: the default device is CUDA, which raises here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from bsdf_diffusion_sampling_tpu_torch.render.neural import make_neural_bsdf

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_neural_bsdf("disk", tcfg.ModelConfig(), [], {})


def test_kernel_library_is_keyed_by_source_and_not_built_at_import():
    p = cuda_build.library_path("fused_ode.cu")
    assert p == cuda_build.library_path("fused_ode.cu")
    assert p.parent == PORT_DIR / "_build" and p.name.startswith("fused_ode-")
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    assert "--use_fast_math" not in cuda_build.NVCC_FLAGS
    assert not cuda_build._libs  # importing the port loaded no library
