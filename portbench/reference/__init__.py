"""The plain reference of the benchmark: numpy only.

It imports nothing of the port, of the JAX package or of the repository's
tests, and takes nothing the port made but the outputs it judges: the
result rows and the objects in the store.
"""
