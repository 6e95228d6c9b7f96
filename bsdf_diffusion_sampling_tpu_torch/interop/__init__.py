"""Weight carry-over from the JAX package's parameter trees."""
