"""Model families of the port (Llama-3 architecture) and the weight
bridge from the JAX package's parameter trees."""
