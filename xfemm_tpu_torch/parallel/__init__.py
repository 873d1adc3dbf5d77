"""Domain decomposition over N parts (the JAX package's ``parallel/``)."""
