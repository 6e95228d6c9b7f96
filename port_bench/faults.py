"""Faults planted in the program underneath a driver, to see `correct`
come out false: each replaces one module-level function of the program
for as long as its context lasts. Used by the tests on the CPU and by
`readings.py --fault` on the card."""

from __future__ import annotations

import contextlib

import torch


def _render():
    from bsdf_diffusion_sampling_tpu_torch.render import integrator, neural

    def state_unchanged(orig):
        def body(accel, env, lights, state, rnd, depth, *, matball, mark=None):
            return state, orig(accel, env, lights, state, rnd, depth, matball=matball, mark=mark)[1]
        return body

    def half_batch(orig):
        def finish(L, r0, mesh, **kw):  # the film of half the rays, each counted twice
            n = L.shape[0] // 2
            return orig(torch.cat([L[:n], L[:n]]), r0, mesh, **kw)
        return finish

    def answer_altered(orig):  # the sampler's pdf, where the kernel produces it
        def kernel(*a, **kw):
            x, pdf, x0 = orig(*a, **kw)
            return x, pdf * 1.001, x0
        return kernel

    return {"state_unchanged": [(integrator, "_bounce_body", state_unchanged)],
            "half_batch": [(integrator, "_finish_pass", half_batch)],
            "answer_altered": [(neural, "fused_sample_pdf_disk", answer_altered),
                               (neural, "fused_sample_pdf_spherical", answer_altered)]}


def _rectify():
    from bsdf_diffusion_sampling_tpu_torch.train import stages

    def half_batch(orig):
        def loss(domain, v, x0, x1, alpha, cond):
            n = x0.shape[0] // 2
            return orig(domain, v, x0[:n], x1[:n], alpha[:n], cond[:n])
        return loss

    def answer_altered(orig):
        def transport(*a, **kw):
            x, det = orig(*a, **kw)
            return x + 1e-3, det
        return transport

    return {"half_batch": [(stages, "flow_matching_mse", half_batch)],
            "answer_altered": [(stages, "fused_transport_packed", answer_altered)]}


FAULTS = {"render": ("state_unchanged", "half_batch", "answer_altered"), "rectify": ("half_batch", "answer_altered")}


@contextlib.contextmanager
def planted(driver: str, fault: str):
    """The program with `fault` planted, for a cell of kind `driver`."""
    sites = (_render() if driver == "render" else _rectify())[fault]
    origs = [getattr(module, name) for module, name, _ in sites]
    for (module, name, make), orig in zip(sites, origs):
        setattr(module, name, make(orig))
    try:
        yield
    finally:
        for (module, name, _), orig in zip(sites, origs):
            setattr(module, name, orig)
