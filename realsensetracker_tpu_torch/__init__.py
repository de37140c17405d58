"""realsensetracker_tpu_torch: the PyTorch + CUDA port of realsensetracker_tpu.

Depth frames in, SE(3) poses out, by coarse-to-fine projective
point-to-plane Gauss-Newton, on an NVIDIA H100 (or on the CPU through the
kernels' plain PyTorch versions). The JAX package ``realsensetracker_tpu``
is the reference this port is held against by the ``tests/test_torch_*``
parity tests; the port never imports it, nor JAX.

Layer map (each module sits at the same path as its JAX counterpart):
  geometry/   SE(3) exp/log + pinhole camera
  ops/        grid normals, depth pyramid with the planar plane table
  kernels/    hand-written CUDA kernels (sources in csrc/) + plain versions:
              the pyramid level builder and the fused Gauss-Newton step
  align/      projective point-to-plane ICP (stride / normal-space
              sampling), batched over a leading B
  parallel/   batched and chunked pair registration
  data/       synthetic raycast scenes, depth-unit policy
  tracking/   frame-to-frame and frame-to-keyframe trackers, trajectory
              I/O and ATE/RPE
  api/        Tracker facade + TrackerConfig
  interop.py  carries configuration and tracker state across from JAX
"""

__version__ = "0.1.0"
