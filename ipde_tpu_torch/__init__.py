"""ipde_tpu_torch: the PyTorch/CUDA port of ipde_tpu.

Spectral solver framework for inhomogeneous elliptic PDEs on smooth 2D
domains, run eagerly on torch tensors in float64/complex128 with the dense
layer-potential sums in hand-written CUDA kernels (``csrc/``).  Module paths
and public names mirror ``ipde_tpu``; this package never imports jax.
"""

__version__ = "0.1.0"
