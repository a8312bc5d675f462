"""PyTorch / CUDA port of mvldm_tpu for NVIDIA Hopper.

Same module names as the JAX package; the CUDA kernels live in ``csrc/`` and
are built at first use (``ops/_build.py``). CPU tensors run the plain
PyTorch versions of the kernels.
"""
