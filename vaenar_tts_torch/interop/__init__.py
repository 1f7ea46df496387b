"""Weight mapping from the JAX package's parameter trees."""
