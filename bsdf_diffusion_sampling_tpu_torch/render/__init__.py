"""The neural BSDF adapter of the renderer."""
