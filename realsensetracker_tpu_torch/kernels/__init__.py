"""Hand-written CUDA kernels for the hot path, each beside its plain torch version.

* level_kernel: fused depth -> plane table [n | d = n.q] for one pyramid
  level (the destination-frame preprocessing of projective ICP).
"""

from realsensetracker_tpu_torch.kernels.level_kernel import build_level_packed  # noqa: F401
