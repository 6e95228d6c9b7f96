"""Host-side native code: the SAH BVH builder and EXR image IO."""
