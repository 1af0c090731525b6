"""The plain reference the benchmark's outputs are judged against.

Plain PyTorch, NumPy and SciPy only: nothing here imports the program
(``pydem_tpu_torch``), ``jax`` or the JAX package, and nothing here takes
anything the program made.  It works out every plane again from the
elevation and spacings the harness handed to both sides.
"""
