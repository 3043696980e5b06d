"""Hand-written CUDA kernels for the hot spots of the query path.

Layout per kernel ``<name>``:
- ``csrc/<name>.cu`` — the kernel, with a plain C interface
- ``<name>.py``      — its wrapper (checks, output allocation, launch
                       on the current stream, launch counter)
- ``ops.py``         — public wrappers: the kernel for CUDA tensors,
                       the plain version for CPU tensors
- ``ref.py``         — plain PyTorch versions
- ``_build.py``      — nvcc build at first use, ctypes loading
"""
