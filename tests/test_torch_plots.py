"""The port's figure exports (`utils/plots.py`) against the JAX package's:
each writes its file, and the KL and MSE numbers equal JAX's (rel 1e-12:
the same numpy arithmetic on the same inputs). Importing the port's
`utils` package, and `utils.plots` itself, does not import matplotlib."""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import os
import subprocess
import sys

import numpy as np

from bsdf_diffusion_sampling_tpu.utils import plots as jplots
from bsdf_diffusion_sampling_tpu_torch.utils import plots

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_figures_are_written(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.normal(0.0, 0.3, 20000)
    p = plots.export_hist_vs_pdf_1d(x, lambda t: np.exp(-t ** 2 / 0.18) / np.sqrt(0.18 * np.pi),
                                    str(tmp_path / "h1.png"), lo=-1.5, hi=1.5, title="gauss")
    assert p == str(tmp_path / "h1.png") and os.path.getsize(p) > 0
    p = plots.export_2d(rng.normal(0, 0.3, (10000, 2)), str(tmp_path / "sub" / "h2.png"), title="2d")
    assert os.path.getsize(p) > 0
    c = (np.arange(40) + 0.5) / 40 * 2 - 1
    g = np.exp(-(c[:, None] ** 2 + c[None] ** 2) / 0.1)
    p = plots.export_pdf_comparison(g * 1.05, g, str(tmp_path / "cmp"))
    assert p.endswith("cmp_pdf_comparison.png") and os.path.getsize(p) > 0


def test_kl_and_mse_equal_jax(tmp_path):
    rng = np.random.RandomState(2)
    c = (np.arange(40) + 0.5) / 40 * 2 - 1
    gx, gy = np.meshgrid(c, c, indexing="ij")
    p = np.exp(-(gx ** 2 + gy ** 2) / 0.1)
    for mu in (0.0, 0.5):
        x = rng.normal(mu, np.sqrt(0.05), (1 << 16, 2))  # the JAX test's size
        path, kl = plots.export_samples_vs_pdf(x, p, str(tmp_path / f"svp{mu}"))
        _, jkl = jplots.export_samples_vs_pdf(x, p, str(tmp_path / f"j_svp{mu}"))
        assert os.path.getsize(path) > 0 and np.isclose(kl, jkl, rtol=1e-12, atol=0)
        assert (kl < 0.05) if mu == 0.0 else (kl > 0.5)
    a = rng.rand(32, 32, 3).astype(np.float32)
    path, mse = plots.export_render_diff(a, a + 0.01, str(tmp_path / "rd"))
    _, jmse = jplots.export_render_diff(a, a + 0.01, str(tmp_path / "j_rd"))
    assert os.path.getsize(path) > 0 and mse == jmse and np.isclose(mse, 1e-4, rtol=1e-3)


def test_importing_utils_does_not_need_matplotlib():
    code = ("import sys\n"
            "import bsdf_diffusion_sampling_tpu_torch.utils\n"
            "import bsdf_diffusion_sampling_tpu_torch.utils.plots\n"
            "import bsdf_diffusion_sampling_tpu_torch.utils.distributions1d\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'matplotlib'))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"
