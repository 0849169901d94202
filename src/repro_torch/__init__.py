"""repro_torch — i2MapReduce on PyTorch with hand-written CUDA kernels.

The PyTorch/CUDA port of the JAX package ``repro``, module for module
(``kernels``, ``core``, ``apps``, ``api``).  It imports neither JAX nor
``repro``.  Entry points run on the GPU unless the caller asks for the CPU
(``RunConfig(device="cpu")``), where the kernels' plain versions run.
"""
