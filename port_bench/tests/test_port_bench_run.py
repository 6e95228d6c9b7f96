"""run.py without a card, and the import guard."""

import ast
import os
import subprocess
import sys

import pytest

from port_bench.run import BENCH, FORBIDDEN, ROOT


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))


def test_exits_nonzero_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "disk_measured.render", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_harness_and_program_load_no_jax():
    """Every module of the harness and the drivers' imports of the program
    leave no module of top-level name jax, jaxlib, flax or the JAX package."""
    code = (
        "import sys, glob, os\n"
        "from port_bench import run\n"
        "run._env()\n"
        "for name in ('render', 'rectify'):\n"
        "    run.load_file(f'port_bench/drivers/{name}.py', 'd_' + name)\n"
        "for p in glob.glob('port_bench/metrics/*.py'):\n"
        "    run.load_file(p, 'm_' + os.path.basename(p)[:-3].replace('.', '_'))\n"
        "import bsdf_diffusion_sampling_tpu_torch.render.integrator, bsdf_diffusion_sampling_tpu_torch.train.stages\n"
        "import bsdf_diffusion_sampling_tpu_torch.render.scene, bsdf_diffusion_sampling_tpu_torch.render.procedural\n"
        "import bsdf_diffusion_sampling_tpu_torch.render.neural, bsdf_diffusion_sampling_tpu_torch.bsdf.materials\n"
        "print(run.forbidden_modules())\n")
    p = _run(code)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_reference_uses_no_program():
    """The reference imports nothing of the program: by its sources, and by
    what importing it loads."""
    ref = os.path.join(BENCH, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tree = ast.parse(open(os.path.join(ref, name)).read())
            for node in ast.walk(tree):
                mods = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                    [node.module or ""] if isinstance(node, ast.ImportFrom) else []
                for m in mods:
                    assert m.split(".")[0] not in FORBIDDEN + ("bsdf_diffusion_sampling_tpu_torch",), (name, m)
    p = _run("import sys\nimport port_bench.reference.render, port_bench.reference.train\n"
             "print(sorted({m.split('.')[0] for m in sys.modules} & {'bsdf_diffusion_sampling_tpu_torch', 'jax'}))")
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_forbidden_names_compare_whole():
    from port_bench.run import forbidden_modules

    sys.modules.setdefault("jaxlike_module_for_test", sys)
    try:
        assert "jaxlike_module_for_test" not in forbidden_modules()
    finally:
        del sys.modules["jaxlike_module_for_test"]
