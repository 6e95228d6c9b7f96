"""Host-side native code: the SAH BVH builder, the tabulated sampler's C++
twin, and EXR image IO."""
