"""The renderer: scene loading, the 8-wide BVH and its traversal kernel, the
binary BVH, materials, the wavefront path tracer and the neural BSDF
adapter."""
