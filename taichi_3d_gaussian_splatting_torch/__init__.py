"""3D Gaussian Splatting on PyTorch and CUDA (NVIDIA Hopper, sm_90a).

A port of the JAX package ``taichi_3d_gaussian_splatting_tpu``, module for
module. Plain tensor stages (projection, binning, the key sort, layout) are
PyTorch; the per-tile forward blend is a hand-written CUDA kernel
(``csrc/blend_forward.cu``), built with ``nvcc`` at first use.

Every function follows the device of its input tensors; nothing here sets
a global default device. This package never imports ``jax``.
"""

__version__ = "0.1.0"

from .camera import CameraInfo

__all__ = ["CameraInfo", "__version__"]
