"""Plain references the output check holds the port to.

Plain PyTorch only: nothing here imports ``repro_torch``, ``repro`` or
``jax``, and nothing takes what the program made (weights, caches, tables):
the benchmark makes the inputs and hands the same to both sides.
"""
