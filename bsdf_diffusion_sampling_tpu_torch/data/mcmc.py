"""Affine-invariant ensemble MCMC (Goodman-Weare 2010) on the device
(counterpart of the JAX package's `data/mcmc.py`).

The red-black ("parallel stretch move") scheme: the walkers split into two
halves; each half proposes stretch moves through partners drawn from the
other half, the first half updated before the second moves (Foreman-Mackey
et al. 2013, the algorithm emcee implements). Stretch scale a = 2: z ~ g(z)
prop. to 1/sqrt(z) on [1/a, a], accept when ln u < (d - 1) ln z + lnp(y) -
lnp(x).

The JAX package runs one ensemble in one `lax.scan` and loops over the
dataset's bands in Python. Here B independent ensembles (the bands) advance
together, shaped (B, W, D), partners drawn within each ensemble's other
half, and a band's bounds are per-row tensors of `log_prob`. A sweep is two
half-steps of tens of small kernels on a few hundred walkers, so eager
PyTorch is bound by launches: the random numbers of a chunk of sweeps are
drawn up front into fixed buffers, and on the card the chunk's sweeps are
captured once in a CUDA graph (which then holds no RNG op) and replayed,
the chain kept in a preallocated buffer.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

CHUNK = 100  # sweeps a graph replay
A = 2.0  # the stretch scale (emcee's default)


class _Ensemble:
    """The state, random buffers and chunk output of B ensembles of W
    walkers in D dimensions; `sweeps(c)` runs c sweeps from the buffers."""

    def __init__(self, log_prob_fn, x0: torch.Tensor, log_prob_args: tuple):
        self.B, self.W, self.D = x0.shape
        self.H = self.W // 2
        self.fn = log_prob_fn
        dev = x0.device
        # each ensemble's value of an argument, repeated over the rows of a half
        vals = [torch.as_tensor(v, dtype=x0.dtype, device=dev).reshape(-1).expand(self.B) for v in log_prob_args]
        self.args = tuple(v[:, None].expand(self.B, self.H).reshape(-1).clone() for v in vals)
        self.x = x0.clone()
        rows = tuple(v[:, None].expand(self.B, self.W).reshape(-1) for v in vals)
        self.logp = log_prob_fn(x0.reshape(-1, self.D), *rows).reshape(self.B, self.W)
        shape = (CHUNK, 2, self.B, self.H)
        self.pick = torch.empty(shape, dtype=torch.int64, device=dev)
        self.u_z = torch.empty(shape, dtype=x0.dtype, device=dev)
        self.u_acc = torch.empty(shape, dtype=x0.dtype, device=dev)
        self.out = torch.empty((CHUNK, self.B, self.W, self.D), dtype=x0.dtype, device=dev)
        self.accepts = torch.zeros(CHUNK, dtype=torch.int64, device=dev)

    def draw(self, gen: torch.Generator) -> None:
        """Fill the random buffers for one chunk, outside any graph."""
        torch.randint(0, self.H, self.pick.shape, generator=gen, out=self.pick)
        torch.rand(self.u_z.shape, generator=gen, out=self.u_z)
        torch.rand(self.u_acc.shape, generator=gen, out=self.u_acc)
        self.u_acc.clamp_(min=1e-38)

    def _half_step(self, s: int, h: int) -> torch.Tensor:
        act = slice(h * self.H, (h + 1) * self.H)
        oth = slice((1 - h) * self.H, (2 - h) * self.H)
        active, lp_active = self.x[:, act], self.logp[:, act]
        partner = torch.gather(self.x[:, oth], 1, self.pick[s, h][..., None].expand(-1, -1, self.D))
        z = ((A - 1.0) * self.u_z[s, h] + 1.0) ** 2 / A
        proposal = partner + z[..., None] * (active - partner)
        lp_prop = self.fn(proposal.reshape(-1, self.D), *self.args).reshape(self.B, self.H)
        accept = torch.log(self.u_acc[s, h]) < (self.D - 1) * torch.log(z) + lp_prop - lp_active
        self.x[:, act] = torch.where(accept[..., None], proposal, active)
        self.logp[:, act] = torch.where(accept, lp_prop, lp_active)
        return accept.sum()

    def sweeps(self, c: int) -> None:
        for s in range(c):
            self.accepts[s] = self._half_step(s, 0) + self._half_step(s, 1)
            self.out[s] = self.x


def ensemble_mcmc(
    gen: torch.Generator,
    log_prob_fn: Callable[..., torch.Tensor],
    x0: torch.Tensor,
    nsteps: int,
    burn_in: int = 0,
    log_prob_args: tuple = (),
    graph: bool | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run burn_in + nsteps sweeps and keep the last nsteps.

    x0: (W, D), or (B, W, D) for B independent ensembles; W even.
    log_prob_fn(points (n, D), *args) -> (n,) log density, -inf outside the
    support; each of `log_prob_args` holds one value an ensemble (a scalar,
    or a (B,) tensor) and reaches log_prob_fn as one value a row.
    `graph` (default: on for CUDA tensors) replays each chunk of sweeps as a
    CUDA graph; the chain is the same either way.
    Returns (chain (nsteps, [B,] W, D), acceptance rate over the kept
    sweeps as a 0-d tensor).
    """
    single = x0.ndim == 2
    if single:
        x0 = x0[None]
    if x0.shape[1] % 2:
        raise ValueError(f"the red-black scheme needs an even walker count, got {x0.shape[1]}")
    if graph is None:
        graph = x0.device.type == "cuda"
    if graph and x0.device.type != "cuda":
        raise ValueError("CUDA graphs need CUDA tensors")
    ens = _Ensemble(log_prob_fn, x0, log_prob_args)
    chain = torch.empty((nsteps,) + tuple(x0.shape), dtype=x0.dtype, device=x0.device)
    accepted = torch.zeros((), dtype=torch.int64, device=x0.device)
    cuda_graph = None
    total, k = burn_in + nsteps, 0
    while k < total:
        c = min(CHUNK, total - k)
        ens.draw(gen)
        if cuda_graph is not None and c == CHUNK:
            cuda_graph.replay()
        elif graph and c == CHUNK:
            # the first full chunk runs eagerly on a side stream (module
            # loading, allocator warm-up), then is captured for the rest
            side = torch.cuda.Stream(x0.device)
            side.wait_stream(torch.cuda.current_stream(x0.device))
            with torch.cuda.stream(side):
                ens.sweeps(c)
            torch.cuda.current_stream(x0.device).wait_stream(side)
            cuda_graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(cuda_graph):  # records the sweeps without running them
                ens.sweeps(c)
        else:
            ens.sweeps(c)
        lo = max(burn_in - k, 0)
        if lo < c:
            chain[k + lo - burn_in:k + c - burn_in] = ens.out[lo:c]
            accepted += ens.accepts[lo:c].sum()
        k += c
    rate = accepted.to(x0.dtype) / max(nsteps * x0.shape[0] * x0.shape[1], 1)
    return (chain[:, 0] if single else chain), rate


def make_domain_log_prob(
    pdf_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    domain: str,
) -> Callable[..., torch.Tensor]:
    """Wrap a batched target density f(omega_i, omega_o) -> (n,) with each
    domain's support mask:

    - disk: omega_i's radius in (r_min, r_max], omega_o inside the unit disk;
    - spherical hemisphere: theta_i in (r_min, r_max), theta_o in (0, pi/2),
      both phis in (-pi, pi);
    - full sphere: the same with theta_o in (0, pi).

    The band bounds are call-time arguments (tensors, one value a row or
    one for all), so all bands share one program.
    """

    def log_prob(p: torch.Tensor, r_min, r_max) -> torch.Tensor:
        wi, wo = p[:, 0:2], p[:, 2:4]
        if domain == "disk":
            ri2 = (wi**2).sum(-1)
            valid = (ri2 <= r_max**2) & (ri2 > r_min**2)
            valid &= (wo**2).sum(-1) <= 1.0
        else:
            theta_max = math.pi / 2 if domain == "spherical" else math.pi
            valid = (wi[:, 0] > r_min) & (wi[:, 0] < r_max)
            valid &= (wo[:, 0] > 0) & (wo[:, 0] < theta_max)
            valid &= (wi[:, 1].abs() < math.pi) & (wo[:, 1].abs() < math.pi)
        f = pdf_fn(wi, wo)
        f = torch.where(valid & (f > 0), f, 0.0)
        return torch.where(f > 0, torch.log(torch.clamp(f, min=1e-38)), -math.inf)

    return log_prob
