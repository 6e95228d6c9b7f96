"""Faults planted in the program underneath `drivers/render_scene.py`'s
cells, to see `correct` come out false, as `faults.py` plants them under
`render.py`'s: the bounce leaves the state as it was; the film of half the
rays; the sampler's pdf off by 1e-3 where a kernel (routed or not) or the
measured BRDF's own sampling produces it; and, for the array, each routed
tile given the next ball's weights. `COMMON` are those every scene cell
can have."""

from __future__ import annotations

import contextlib

from port_bench import faults


@contextlib.contextmanager
def _replaced(sites):
    """Each (module, name, make) of `sites` replaced by make(original)."""
    sites = [s for s in sites if hasattr(s[0], s[1])]
    origs = [getattr(m, n) for m, n, _ in sites]
    for (m, n, make), o in zip(sites, origs):
        setattr(m, n, make(o))
    try:
        yield
    finally:
        for (m, n, _), o in zip(sites, origs):
            setattr(m, n, o)


def altered_draws():
    """The sampler's pdf x 1.001 where a kernel, or the measured BRDF's own
    sampling, produces it."""
    from bsdf_diffusion_sampling_tpu_torch.bsdf import measured
    from bsdf_diffusion_sampling_tpu_torch.render import neural

    def kernel(orig):
        def f(*a, **kw):
            x, pdf, x0 = orig(*a, **kw)
            return x, pdf * 1.001, x0
        return f

    def brdf(orig):
        def f(*a, **kw):
            wo, pdf = orig(*a, **kw)
            return wo, pdf * 1.001
        return f

    return _replaced([(neural, "fused_sample_pdf_spherical", kernel),
                      (neural, "fused_sample_pdf_spherical_routed", kernel), (measured, "sample_brdf", brdf)])


def next_balls_weights():
    """Each routed tile drawn and queried with the next ball's weights."""
    import torch

    from bsdf_diffusion_sampling_tpu_torch.render import integrator

    def make(orig):
        def route(group, n_groups, counter=None):
            rt = orig(group, n_groups, counter)
            tb = torch.where(rt.tile_ball >= 0, (rt.tile_ball + 1) % n_groups, rt.tile_ball)
            return rt._replace(tile_ball=tb.to(torch.int32))
        return route

    return _replaced([(integrator, "route_rows", make)])


FAULTS = {"state_unchanged": lambda: faults.planted("render", "state_unchanged"),
          "half_batch": lambda: faults.planted("render", "half_batch"),
          "answer_altered": altered_draws, "next_balls_weights": next_balls_weights}
COMMON = ("state_unchanged", "half_batch", "answer_altered")


def planted(fault: str):
    """The program with `fault` planted, for a cell of `render_scene.py`."""
    return FAULTS[fault]()
