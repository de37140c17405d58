"""realsensetracker_tpu_torch: the PyTorch + CUDA port of realsensetracker_tpu.

Depth frames in, SE(3) poses out, by coarse-to-fine projective
point-to-plane Gauss-Newton or by GNC point-to-point ICP or GICP on voxel
clouds, or by joint point-to-plane + photometric Gauss-Newton on RGB-D
frames; pairwise cloud registration by FPFH matching or robust global
registration; SLAM (keyframe odometry, loop closure and pose-graph
optimization) with checkpoints; dense mapping (a TSDF volume tracked
frame to model, KinectFusion's loop, meshes and an atlas of submaps);
many sessions' streams advanced together, served over HTTP with
cross-session batching, recorded clips and TUM sequences replayed from disk, on an NVIDIA H100 by default (or, with ``device="cpu"``, on the CPU
through the kernels' plain PyTorch versions). The JAX package ``realsensetracker_tpu``
is the reference this port is held against by the ``tests/test_torch_*``
parity tests; the port never imports it, nor JAX.

Layer map (each module sits at the same path as its JAX counterpart):
  geometry/   SE(3) exp/log + pinhole camera
  ops/        grid and k-NN PCA normals, depth pyramid with the planar plane
              table, differentiable bilinear sampling; masked clouds, voxel downsample, brute-force (k-)nearest
              neighbours, FPFH features and matching
  kernels/    hand-written CUDA kernels (sources in csrc/) + plain versions:
              the pyramid downsample, the pyramid level builder, the
              fused Gauss-Newton step (a whole round, or the 6x6 system),
              the pose graph's backbone factor and apply, and the TSDF
              volume's integrate and raycast march
  align/      projective point-to-plane ICP (stride / normal-space
              sampling), batched over a leading B; photometric and joint
              RGB-D registration; Kabsch, GNC-ICP, GICP and GNC-TLS robust
              global registration
  optimize/   pose-graph optimization (GN-CG, backbone preconditioner)
  mapping/    the TSDF volume (integrate, raycast, surface extraction),
              marching-tetrahedra meshes, the submap atlas
  loop_closure/ keyframe database: place recognition, geometric verification
  models/     the rs_align_app pipeline (align_pair) and the named pipelines
  parallel/   batched and chunked pair registration; multi-stream steps
              (S slots advanced in one batched step, masked, windowed;
              depth, RGB-D and dense slots)
  data/       synthetic raycast scenes (depth and RGB-D), depth-unit policy;
              .rsc clips, TUM sequences (a numpy + zlib PNG codec), the
              protobuf cloud reader, random sources, and the FrameStream
              that prefetches frames onto the card on its own CUDA stream
  native/     the port's build and ctypes loader of the C++ host library
              (native/src: clip codec, PNG16 decoder, voxel-hash map)
  tracking/   frame-to-frame (with the voxel world map), frame-to-keyframe
              and frame-to-model trackers, their RGB-D frame and keyframe
              counterparts, the TSDF frame-to-model tracker, the SLAM
              tracker, tracker, SLAM, TSDF and submap checkpoints,
              trajectory I/O and ATE/RPE
  api/        Tracker facade + TrackerConfig; the HTTP TrackingService and
              the BatchedExecutor that coalesces sessions into one step
  cli/        rs_serve, the service's entry point; rs_replay (recorded
              clips and TUM sequences to a trajectory and its ATE) and
              rs_tracker (a synthetic stream)
  utils/      stopwatches, stage timing, device traces, NaN checks
  vis/        PNG/PLY writers and the live HTTP viewer
  device.py   the default device ("cuda") and its check
  interop.py  carries configuration, tracker and slot state across from JAX
"""

__version__ = "0.1.0"
