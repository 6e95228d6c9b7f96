"""Device milliseconds a render pass spends in operations that none of
the program's own libraries launched: the plain PyTorch layers
(materials, envmap, the plain exact pdf, the integrator's glue)."""

# the kernels of the program's libraries (csrc/*.cu), by name fragment
PORT_KERNELS = ("sample_pdf_disk_kernel", "pdf_disk_kernel", "sample_pdf_sph_kernel", "transport_kernel",
                "traverse8_kernel")


def read(tr):
    passes = tr.work.get("passes")
    if not passes:
        return None
    plain = tr.device_s(lambda name: not any(f in name for f in PORT_KERNELS))
    return 1e3 * plain / passes
