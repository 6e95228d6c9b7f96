"""The port's reference-checkpoint importer (`interop/torch_checkpoints.py`,
`cli/import_reference.py`) and `cli/render.py`'s `--weights reference` and
`--allow-substitute`, held against the JAX package's `interop/torch_checkpoints.py`
and `train/checkpoint.py::load_pytree`.

No reference `.pth` file is in the repository: the state dicts are made
here with numpy in the reference's layout (`linear1..linearN`, `output`;
(out, in) weights) and written with `torch.save`. Trees are compared bit
for bit; the imported velocity net against an independent linear + SiLU
chain over the state dict at rtol 1e-5, atol 1e-6; renders bit for bit.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from bsdf_diffusion_sampling_tpu.interop import torch_checkpoints as jck
from bsdf_diffusion_sampling_tpu.train import checkpoint as jcheckpoint
from bsdf_diffusion_sampling_tpu_torch.cli import import_reference, render as render_cli
from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig
from bsdf_diffusion_sampling_tpu_torch.interop import torch_checkpoints as tck
from bsdf_diffusion_sampling_tpu_torch.models.velocity import encode_condition, velocity_apply
from bsdf_diffusion_sampling_tpu_torch.ops.fused_ode import prepack_velocity
from bsdf_diffusion_sampling_tpu_torch.render import procedural
from bsdf_diffusion_sampling_tpu_torch.train.checkpoint import load_pytree

MATERIAL = "synthetic_rgb"
LEGACY = "neusample_pos_diffusion_brdf_mcmc_pytorch_emcee_onemode"
BASE, DISK = [14, 16, 4], [25, 32, 32, 32, 2]
SPH, TEACHER = [26, 32, 32, 32, 32, 2], [26, 64, 64, 64, 64, 64, 64, 2]


def state_dict(rng, dims, bias: bool, scale: float = 1.0) -> dict:
    """linear1..linearN then output, (out, in) weights. More than 9 layers
    would test the numeric sort; the teacher's 7 sort the same either way,
    so the names are written in a shuffled order instead."""
    names = [f"linear{i + 1}" for i in range(len(dims) - 2)] + ["output"]
    sd = {}
    for name, d_in, d_out in zip(names, dims[:-1], dims[1:]):
        bound = 1.0 / np.sqrt(d_in)
        sd[f"{name}.weight"] = torch.from_numpy((scale * rng.uniform(-bound, bound, (d_out, d_in))).astype(np.float32))
        if bias:
            sd[f"{name}.bias"] = torch.from_numpy(rng.uniform(-bound, bound, d_out).astype(np.float32))
    keys = list(sd)
    rng.shuffle(keys)
    return {k: sd[k] for k in keys}


def write_reference(root, seed: int = 0, velocity_bias: bool = False) -> None:
    """The three directory shapes: `<m>_disk/`; `<m>_spherical/` without a
    pretrain file (read from `<m>_disk/`); `bsdf_20_spherical/` with its own
    pretrain file and the diffusion nets under the legacy names."""
    rng = np.random.default_rng(seed)
    m = MATERIAL
    files = {f"{m}_disk/brdf_pretrain_network{m}.pth": (BASE, True),
             f"{m}_disk/brdf_diffusion_network{m}.pth": (DISK, velocity_bias),
             f"{m}_disk/brdf_rectify_network{m}.pth": (DISK, velocity_bias),
             f"{m}_spherical/brdf_diffusion_network_simpler{m}.pth": (SPH, velocity_bias),
             f"{m}_spherical/brdf_diffusion_network_complex{m}.pth": (TEACHER, velocity_bias),
             f"{m}_spherical/brdf_rectify_network{m}.pth": (SPH, velocity_bias),
             "bsdf_20_spherical/brdf_pretrain_network20.pth": (BASE, True),
             f"bsdf_20_spherical/{LEGACY}32.pth": (SPH, velocity_bias),
             f"bsdf_20_spherical/{LEGACY}64.pth": (TEACHER, velocity_bias),
             "bsdf_20_spherical/brdf_rectify_network20.pth": (SPH, velocity_bias)}
    for rel, (dims, bias) in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(state_dict(rng, dims, bias, 1.0 if dims is BASE else 0.5), path)


DOMAINS = {"disk": MATERIAL, "spherical": MATERIAL, "sphere_full": "20"}


def _leaves(tree):
    if isinstance(tree, dict):
        return {k: _leaves(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_leaves(v) for v in tree]
    if hasattr(tree, "value") and not hasattr(tree, "dtype"):
        return int(tree.value)
    if isinstance(tree, int):
        return tree
    return np.asarray(tree.cpu() if torch.is_tensor(tree) else tree)


def _assert_trees_equal(a, b, path=""):
    assert type(a) is type(b) or isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, int):
        assert a == b, path
    else:
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), path


@pytest.mark.parametrize("velocity_bias", [False, True], ids=["bias_free", "biased"])
@pytest.mark.parametrize("domain", list(DOMAINS))
def test_import_matches_jax(tmp_path, domain, velocity_bias):
    """The port's tree equals the JAX importer's on the same files, bit for
    bit: `disk`, `spherical` (the `_disk` pretrain fallback) and
    `sphere_full` (the legacy diffusion names); biases kept where present."""
    write_reference(tmp_path, velocity_bias=velocity_bias)
    want = jck.import_reference_material(str(tmp_path), DOMAINS[domain], domain)
    got = tck.import_reference_material(str(tmp_path), DOMAINS[domain], domain, device="cpu")
    _assert_trees_equal(_leaves(got), _leaves(want))
    assert ("b" in got["rectified"][0]) == velocity_bias
    assert got["base"]["pe_bands"] == 3 and isinstance(got["base"]["pe_bands"], int)
    if domain == "spherical":  # the fallback read the disk directory's pretrain net
        disk = tck.import_reference_material(str(tmp_path), MATERIAL, "disk", device="cpu")
        _assert_trees_equal(_leaves(got["base"]), _leaves(disk["base"]))


def _chain(sd: dict, x: np.ndarray) -> np.ndarray:
    """An independent evaluation of a state dict: linear1..linearN with SiLU,
    then output (tests/test_torch_import.py:31-50)."""
    names = sorted({k.split(".")[0] for k in sd if k.startswith("linear")},
                   key=lambda n: int(re.search(r"\d+", n).group())) + ["output"]
    h = torch.from_numpy(x)
    for i, name in enumerate(names):
        h = h @ sd[f"{name}.weight"].T
        if f"{name}.bias" in sd:
            h = h + sd[f"{name}.bias"]
        if i + 1 < len(names):
            h = torch.nn.functional.silu(h)
    return h.numpy()


@pytest.mark.parametrize("velocity_bias", [False, True], ids=["bias_free", "biased"])
@pytest.mark.parametrize("domain", ["disk", "spherical"])
def test_velocity_layout(tmp_path, domain, velocity_bias):
    write_reference(tmp_path, velocity_bias=velocity_bias)
    params = tck.import_reference_material(str(tmp_path), MATERIAL, domain, device="cpu")
    rng = np.random.default_rng(1)
    n = 257
    x = rng.uniform(-0.8, 0.8, (n, 2)).astype(np.float32)
    x_enc = x if domain == "disk" else np.stack([x[:, 0], np.sin(x[:, 1]), np.cos(x[:, 1])], -1)
    alpha = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    cond = encode_condition(torch.from_numpy(rng.uniform(-0.7, 0.7, (n, 2)).astype(np.float32)), ModelConfig())
    got = velocity_apply(params["rectified"], torch.from_numpy(x_enc), torch.from_numpy(alpha), cond).numpy()
    sd = torch.load(tmp_path / f"{MATERIAL}_{domain}" / f"brdf_rectify_network{MATERIAL}.pth", weights_only=True)
    want = _chain(sd, np.concatenate([x_enc, alpha, cond.numpy()], -1).astype(np.float32))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_importer_rejects_malformed_state_dicts():
    rng = np.random.default_rng(2)
    with pytest.raises(ValueError, match="base net input"):
        tck.base_from_state_dict(state_dict(rng, [12, 16, 4], True))
    sd = state_dict(rng, DISK, False)
    del sd["output.weight"]
    with pytest.raises(ValueError, match="no 'output' layer"):
        tck.mlp_from_state_dict(sd)


def test_importer_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    write_reference(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tck.import_reference_material(str(tmp_path), MATERIAL, "disk")


@pytest.mark.parametrize("domain", list(DOMAINS))
def test_import_cli_output_loads_in_jax(tmp_path, domain):
    """`cli/import_reference.py` writes final.npz at step 0; the JAX
    `load_pytree` reads it into the JAX importer's tree, equal to it."""
    write_reference(tmp_path / "ckpts")
    out = tmp_path / f"{domain}.npz"
    import_reference.main(["--checkpoints-root", str(tmp_path / "ckpts"), "--material", DOMAINS[domain],
                           "--domain", domain, "--out", str(out), "--device", "cpu"])
    template = jck.import_reference_material(str(tmp_path / "ckpts"), DOMAINS[domain], domain)
    tree, step = jcheckpoint.load_pytree(str(out), template)
    assert step == 0
    _assert_trees_equal(_leaves(tree), _leaves(template))
    back, step = load_pytree(str(out))
    assert step == 0
    for k in ("diffusion", "teacher", "rectified"):
        _assert_trees_equal(_leaves(back[k]), _leaves(template[k]))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_world")
    kw = dict(n_lat=8, n_lon=12, plane_g=2, env_res=(8, 16), width=32, height=32, spp=1, max_depth=2)
    scenes = {"measured": procedural.write_scene(str(d), **kw),
              "table": procedural.write_scene(str(d), table=procedural.TABLE, **kw)}
    write_reference(d / "ckpts")
    return {"dir": str(d), "scenes": scenes}


def _render(world, scene, mode, *args, out="img"):
    img, _ = render_cli.main(["--scene", world["scenes"][scene], "--bsdf-dir", world["dir"], "--material", MATERIAL,
                              "--mode", mode, "--spp", "1", "--spp-chunk", "1", "--max-depth", "2", "--width", "32",
                              "--height", "32", "--device", "cpu", "--out", os.path.join(world["dir"], out), *args])
    return img


@pytest.mark.parametrize("scene, mode, domain", [("measured", "neural-disk", "disk"),
                                                 ("table", "neural-sphere", "sphere_full")])
def test_render_reference_equals_imported_checkpoint(world, scene, mode, domain):
    """`--weights reference` renders the same image as `--checkpoint` of
    the imported final.npz; a table ball reads `bsdf_<idx>_spherical/`."""
    ckpts = os.path.join(world["dir"], "ckpts")
    ref = _render(world, scene, mode, "--weights", "reference", "--reference-ckpts", ckpts, out=f"ref_{mode}")
    npz = os.path.join(world["dir"], f"{domain}.npz")
    import_reference.main(["--checkpoints-root", ckpts, "--material", DOMAINS[domain], "--domain", domain,
                           "--out", npz, "--device", "cpu"])
    imported = _render(world, scene, mode, "--checkpoint", npz, out=f"imp_{mode}")
    assert np.isfinite(ref).all() and ref.max() > 0
    np.testing.assert_array_equal(ref, imported)


def test_reference_weights_need_their_directory(world):
    with pytest.raises(ValueError, match="--reference-ckpts"):
        _render(world, "measured", "neural-disk", "--weights", "reference")


def test_allow_substitute(world):
    """A missing .bsdf raises without the flag; with it chm_mint_rgb stands
    in, and the substitution is written to <out>.meta.json in the JAX
    package's keys."""
    import shutil

    shutil.copy(os.path.join(world["dir"], f"{MATERIAL}.bsdf"), os.path.join(world["dir"], "chm_mint_rgb.bsdf"))
    args = ["--scene", world["scenes"]["measured"], "--bsdf-dir", world["dir"], "--material", "aniso_missing",
            "--mode", "gt", "--spp", "1", "--spp-chunk", "1", "--max-depth", "2", "--width", "16", "--height", "16",
            "--device", "cpu", "--out", os.path.join(world["dir"], "sub")]
    with pytest.raises(FileNotFoundError, match="--allow-substitute"):
        render_cli.main(args)
    assert not os.path.exists(os.path.join(world["dir"], "sub.meta.json"))
    img, _ = render_cli.main(args + ["--allow-substitute"])
    assert np.isfinite(img).all()
    with open(os.path.join(world["dir"], "sub.meta.json")) as f:
        meta = json.load(f)
    assert meta == {"material_substitutions": [{"ball": "aniso_missing", "substituted": "chm_mint_rgb"}],
                    "mode": "gt", "material": "aniso_missing"}


def test_kernels_refuse_a_biased_velocity_net(tmp_path):
    """The kernels' velocity MLP has no bias term, where the plain version
    adds one: packing a biased net raises instead of dropping its biases
    (the JAX kernels drop them silently)."""
    write_reference(tmp_path, velocity_bias=True)
    params = tck.import_reference_material(str(tmp_path), MATERIAL, "disk", device="cpu")
    with pytest.raises(ValueError, match="bias-free"):
        prepack_velocity(params["rectified"])
    prepack_velocity([{"w": layer["w"]} for layer in params["rectified"]])  # the same net without them packs

