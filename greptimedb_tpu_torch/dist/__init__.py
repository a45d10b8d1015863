"""The fleet's view of this process (the JAX package's dist/, its
standalone part; the distributed roles wait for ROADMAP A10)."""
