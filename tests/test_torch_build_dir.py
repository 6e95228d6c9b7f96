"""Where the port's native libraries are built (`ops/cuda_build.py`'s
BUILD_DIR, read from BSDF_TORCH_BUILD_DIR at import): unset, the package's
`_build/`; a path, that directory; empty, a fresh temporary directory for
the process, removed at its exit. Each case builds `csrc/samplewi.cpp` with
g++ in a fresh process and draws from it."""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
CODE = ("import numpy as np\n"
        "from bsdf_diffusion_sampling_tpu_torch.ops import cuda_build\n"
        "from bsdf_diffusion_sampling_tpu_torch.native.samplewilib import samplewi_native\n"
        "x = samplewi_native(np.ones((2, 16, 16), np.float32), 8, seed=1)\n"
        "assert x.shape == (2, 8, 2)\n"
        "lib = cuda_build.library_path('samplewi.cpp')\n"
        "assert lib.exists() and lib.with_suffix('.log').exists()\n"
        "print(cuda_build.BUILD_DIR)\n")


def _run(value):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "BSDF_TORCH_BUILD_DIR")}
    if value is not None:
        env["BSDF_TORCH_BUILD_DIR"] = value
    out = subprocess.run([sys.executable, "-c", CODE], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    return Path(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", ["unset", "path", "empty"])
def test_build_dir_redirect(case, tmp_path):
    if case == "unset":
        assert _run(None) == REPO / "bsdf_diffusion_sampling_tpu_torch" / "_build"
    elif case == "path":
        where = tmp_path / "libs"
        assert _run(str(where)) == where
        assert [p.name for p in where.glob("samplewi-*.so")]
    else:
        where = _run("")
        assert where.name.startswith("bsdf_torch_build-") and where != REPO / "bsdf_diffusion_sampling_tpu_torch" / "_build"
        assert not where.exists()  # removed when the process ended
