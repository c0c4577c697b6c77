"""gsgen_torch: the PyTorch + CUDA port of the JAX package.

The package mirrors the JAX package's layout module by module.  Plain tensor
code is PyTorch; the TPU kernels of the render path and of the UNet's flash
self-attention (forward and backward) are hand-written CUDA C++ for Hopper
(``csrc/*.cu``), built on first use into ``_build/`` and called through
``ctypes``.  Every kernel has a plain PyTorch version
beside it, which is what CPU tensors run.
"""

__version__ = "0.1.0"
