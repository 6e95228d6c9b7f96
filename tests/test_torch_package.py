"""The PyTorch port as a package: it stands alone (no JAX, nothing of the
JAX package), keeps its own copy of the pure-Python config, runs on the
card unless asked for the CPU, and builds no kernel at import."""

import dataclasses
import importlib.util
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


RENDER_SLICE = ["native.bvhlib", "native.exr", "render.mesh", "render.bvh8", "render.traverse8",
                "bsdf.tensorfile", "bsdf.marginal2d", "bsdf.measured", "render.lambert", "render.camera",
                "render.envmap", "render.scene", "render.integrator", "render.procedural", "cli.render"]
SPHERICAL_SLICE = ["models.von_mises", "models.base_density", "bsdf.microfacet", "bsdf.principled", "bsdf.rough",
                   "bsdf.materials", "render.neural", "ops.fused_ode"]
TRAIN_SLICE = ["core.config", "geometry.coords", "geometry.sampling", "models.mlp", "models.velocity",
               "models.base_density", "bsdf.analytic", "data.mcmc", "data.datasets", "utils.validation",
               "train.losses", "train.checkpoint", "train.stages", "cli.train", "cli.assemble_checkpoint"]
DIFF_REFERENCE_ZOO_SLICE = ["ops.fused_ode", "ode.flow", "interop.jax_params", "interop.torch_checkpoints",
                            "cli.import_reference", "cli.render", "models.zoo"]


def test_import_pulls_in_no_jax():
    code = ("import sys, importlib, pkgutil, bsdf_diffusion_sampling_tpu_torch as p\n"
            "seen = []\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "    seen.append(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m.split('.')[0] == 'bsdf_diffusion_sampling_tpu']\n"
            "print(sorted(bad))\n"
            "print(' '.join(seen))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    bad, seen = out.stdout.strip().splitlines()
    assert bad == "[]", bad
    # the render, spherical, training and differentiable/reference/zoo slices' modules are among those imported
    assert {f"bsdf_diffusion_sampling_tpu_torch.{m}"
            for m in RENDER_SLICE + SPHERICAL_SLICE + TRAIN_SLICE + DIFF_REFERENCE_ZOO_SLICE} <= set(seen.split())


def test_no_source_names_the_jax_package():
    names_pkg = re.compile(r"bsdf_diffusion_sampling_tpu(?!_torch)")
    imports_jax = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
    sources = [p for p in PORT_DIR.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    assert len(sources) >= 35
    for p in sources:
        text = p.read_text()
        assert not names_pkg.search(text), p
        assert not imports_jax.search(text), p


@pytest.mark.parametrize("name", ["ModelConfig", "SamplerConfig", "TrainConfig"])
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


@pytest.mark.parametrize("entry", ["load_measured", "measured_from_tensors", "load_scene", "build_scene",
                                   "render", "generate_brdf_dataset", "train_material", "cli.train",
                                   "import_reference_material", "cli.import_reference"])
def test_loaders_and_render_default_to_the_card(entry):
    """The BRDF and scene loaders, `render()`, the dataset generator, the
    trainer, the training CLI and the reference importer and its CLI run on
    the card unless asked for the CPU,
    so what they return fits together; the default raises here, before any
    file is read."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from bsdf_diffusion_sampling_tpu_torch.bsdf import measured
    from bsdf_diffusion_sampling_tpu_torch.cli import import_reference
    from bsdf_diffusion_sampling_tpu_torch.cli import train as train_cli
    from bsdf_diffusion_sampling_tpu_torch.data import datasets
    from bsdf_diffusion_sampling_tpu_torch.interop import import_reference_material
    from bsdf_diffusion_sampling_tpu_torch.render import integrator, scene
    from bsdf_diffusion_sampling_tpu_torch.train import stages

    call = {"load_measured": lambda: measured.load_measured("absent.bsdf"),
            "measured_from_tensors": lambda: measured.measured_from_tensors({"phi_i": [0.0], "theta_i": [0.0]}),
            "load_scene": lambda: scene.load_scene("absent.xml"),
            "build_scene": lambda: scene.build_scene(None),
            "render": lambda: integrator.render(None, None),
            "generate_brdf_dataset": lambda: datasets.generate_brdf_dataset(0, None, cache_path="absent.npy"),
            "train_material": lambda: stages.train_material(None, tcfg.ModelConfig(), tcfg.TrainConfig()),
            "cli.train": lambda: train_cli.main(["--material", "ggx:0.5", "--out", "absent"]),
            "import_reference_material": lambda: import_reference_material("absent", "m", "disk"),
            "cli.import_reference": lambda: import_reference.main(["--checkpoints-root", "absent", "--material", "m",
                                                                   "--domain", "disk", "--out", "absent.npz"])}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_kernel_library_is_keyed_by_source_and_not_built_at_import():
    p = cuda_build.library_path("fused_ode.cu")
    assert p == cuda_build.library_path("fused_ode.cu")
    assert p.parent == PORT_DIR / "_build" and p.name.startswith("fused_ode-")
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    assert "--use_fast_math" not in cuda_build.NVCC_FLAGS
    # importing every module of the port loads no library; asked of a fresh
    # process, since tests run before this one in the same worker may have
    # built the BVH builder
    code = ("import importlib, pkgutil, bsdf_diffusion_sampling_tpu_torch as p\n"
            "from bsdf_diffusion_sampling_tpu_torch.ops import cuda_build\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "print(sorted(cuda_build._libs))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout
    assert cuda_build.library_path("traverse8.cu").name.startswith("traverse8-")
    for src in ("fused_sph.cu", "fused_transport.cu"):  # K4, K3
        assert cuda_build.library_path(src).name.startswith(src.split(".")[0] + "-")
    assert len({cuda_build.library_path(s) for s in ("fused_ode.cu", "fused_sph.cu", "fused_transport.cu")}) == 3


def test_cuda_library_key_covers_the_shared_headers(tmp_path, monkeypatch):
    """An edit of `csrc/*.cuh` rebuilds the CUDA libraries that include it."""
    for name in ("fused_sph.cu", "ode_mlp.cuh", "bvh_build.cpp"):
        (tmp_path / name).write_bytes((cuda_build.CSRC / name).read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    cu, cpp = cuda_build.library_path("fused_sph.cu"), cuda_build.library_path("bvh_build.cpp")
    with open(tmp_path / "ode_mlp.cuh", "a") as f:
        f.write("// edited\n")
    assert cuda_build.library_path("fused_sph.cu") != cu
    assert cuda_build.library_path("bvh_build.cpp") == cpp
    # host C++ goes through the same build path, with g++'s flags
    assert cuda_build.library_path("bvh_build.cpp").name.startswith("bvh_build-")
    assert cuda_build._flags("bvh_build.cpp") == cuda_build.HOST_FLAGS


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_build_log_and_sass_parsers():
    """The parsers behind chip_smoke.py's spill and tensor-core checks."""
    smoke = _chip_smoke()
    log = """ptxas info    : Compiling entry function '_Z2k1v' for 'sm_90a'
ptxas info    : Function properties for _Z2k1v
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 32 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z2k2v' for 'sm_90a'
ptxas info    : Function properties for _Z2k2v
    72 bytes stack frame, 68 bytes spill stores, 208 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 72 bytes cumulative stack size
"""
    assert smoke.ptxas_spills(log) == {"_Z2k1v": (32, 0, 0), "_Z2k2v": (72, 68, 208)}
    sass = """
        Function : _Z2k1v
        /*0a30*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*0a40*/                   HMMA.1688.F32.TF32 R16, R8, R20, R16 ;
        /*0a50*/                   FFMA R1, R2, R3, R1 ;
        Function : _Z2k2v
        /*0010*/                   HGMMA.64x32x8.F32.TF32 gdesc[UR4], RZ, !UPT ;
"""
    assert smoke.count_opcodes(sass) == {"_Z2k1v": {"HMMA": 2, "HGMMA": 0}, "_Z2k2v": {"HMMA": 0, "HGMMA": 1}}
    # a K1/K4 instantiation's count: whole hidden layers of 3 passes x 3 streams x 4 x 4 tiles
    assert smoke.HMMA_A_LAYER == 144


_K3 = "_ZN51_GLOBAL__N__91546b8d_18_fused_transport_cu_def1201916transport_kernelI{}EEEvPKfS2_S2_PfS3_iii"
_FUSED_ODE = "_ZN45_GLOBAL__N__1f34553d_12_fused_ode_cu_adcbb23b"
_K1 = _FUSED_ODE + "22sample_pdf_disk_kernelILi32ELi3ELb{}EEEvPKfS2_PKxS2_PfS5_S5_ii"
_K2 = _FUSED_ODE + "15pdf_disk_kernelILi32ELi3ELb{}EEEvPKfS2_S2_PfS3_iii"


@pytest.mark.parametrize("fn, want", [
    (_K3.format("Li32ELi4ELi3ELb1ELi4"), 144),  # spherical 4 x 32 with the det: 3 passes x 3 streams x 4 x 4
    (_K3.format("Li32ELi3ELi2ELb0ELi4"), 48),  # disk 3 x 32 primal: 3 passes x 1 stream x 4 x 4
    (_K3.format("Li64ELi6ELi3ELb0ELi8"), 192),  # spherical 6 x 64 primal: 3 passes x 1 stream x 8 x 8
    ("_ZN45_GLOBAL__N__1f34553d_12_fused_ode_cu_adcbb23b22sample_pdf_disk_kernelILi32ELi3ELb1EEEvPKfS2_PKxS2_PfS5_S5_"
     "ii", 144),  # K1
    (_K1.format(0), 144),  # K1 with eps
    (_K2.format(1), 192),  # exact K2: a primal evaluation (48) and one with the tangents (144)
    (_K2.format(0), 144),  # reverse K2: K1's transport, reversed
])
def test_hmma_count_of_one_hidden_layer(fn, want):
    """What chip_smoke.py requires each K1, K2, K4 and K3 instantiation's
    HMMA count to be a whole multiple of, read from its mangled name."""
    assert _chip_smoke().hmma_a_layer(fn) == want


def test_phase_1_marker_counts_k1_and_k2_once_each():
    """fused_ode.cu's marker matches K1's two instantiations and K2's two,
    each once, and nothing else of the library; a dropped pass of 3xTF32
    leaves a count that is no whole multiple of its kernel's layer."""
    smoke = _chip_smoke()
    kernels = [_K1.format(0), _K1.format(1), _K2.format(1), _K2.format(0)]
    names = kernels + [_FUSED_ODE + "6helperEv", "_Z13other_kernelPf"]
    assert smoke.tc_functions("fused_ode.cu", names) == kernels
    assert len(kernels) == smoke.TC_KERNELS["fused_ode.cu"][1]
    exact, reverse = smoke.hmma_a_layer(_K2.format(1)), smoke.hmma_a_layer(_K2.format(0))
    assert all(dropped % exact for dropped in (48 + 96, 32 + 144, 32 + 96))
    assert 96 % reverse
