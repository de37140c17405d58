"""Hand-written CUDA kernels for the hot path, each beside its plain torch version.

* downsample: every coarse level of a depth pyramid (2x2 validity-aware
  mean, floor dims) from one launch.
* level_kernel: fused depth -> plane table [n | d = n.q] for one pyramid
  level (the destination-frame preprocessing of projective ICP).
* gn_step: one Gauss-Newton association round of projective ICP per
  launch -- association into the plane table, then per inner iteration the
  6x6 reduction, damped solve and SE(3) update.
* backbone: the pose graph's block-LDL^T backbone preconditioner, its
  factor and its apply (the port's own kernel: JAX's is plain XLA).
* tsdf: the TSDF volume's integrate (one thread per voxel, gates read on
  the device) and raycast march (one thread per ray), the port's own
  kernels where JAX's are plain XLA.
"""

from realsensetracker_tpu_torch.kernels.level_kernel import build_level_packed  # noqa: F401
