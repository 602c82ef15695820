"""KV-cache bookkeeping shared by the port's paged server (the jax-free
parts of the JAX package's ``kvstore/``, copied)."""
