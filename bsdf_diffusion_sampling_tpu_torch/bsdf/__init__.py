"""Measured BSDFs: the RGL tensor-file container, the 2D warp and the
isotropic measured-BRDF evaluator."""
