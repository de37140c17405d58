#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (realsensetracker_tpu_torch) once on one
NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, nvcc and no
need for JAX. Phases, one JSON line each:

  1. device     -- the card (name and power limit from nvidia-smi); TF32 off.
  2. build      -- builds csrc/downsample.cu, csrc/level_kernel.cu,
                   csrc/gn_step.cu, csrc/backbone.cu, csrc/tsdf_integrate.cu
                   and csrc/tsdf_raycast.cu, one nvcc each, started
                   together.
  2b. downsample_kernel -- holds downsample_levels against its plain torch
                   version (validity identical, depth within 2 ulp; the
                   worst gap is printed) on a 640x480 batch with 5% holes
                   (B=4), on each of its level shapes, and at 482x64 and
                   36x128, for L = 2, 3 and 4.
  3. kernel     -- holds the CUDA level kernel against its plain torch
                   version (atol 2e-5, the validity pattern identical) at
                   the four level shapes of a 640x480 frame (B=4) and at
                   482x64 and 36x128.
  4. gn_kernel  -- holds gn_round (one association round: association,
                   then inner_iters x reduction, damped 6x6 solve and SE(3)
                   update) against its plain version at the four level
                   shapes (B=4, with holes, 2048/512/256/256 points), at
                   482x64 and at the 8192-point cap, for inner_iters 1-3:
                   the pose within 1e-5 in twist, the matched count within
                   0.1% of P, rmse within 1e-4 relative, a second launch
                   bit-identical, and pair 1 alone (B=1) bit-identical to
                   its row of the B=4 launch.
  4b. gn_round_large -- the same checks at P = 8193 and 16384, above the
                   8192 points gn_round keeps in registers (it streams each
                   point's plane row through a scratch buffer there).
  5. register   -- register_batch on 64 pairs and register_batch_chunked on
                   1024 pairs (chunk 512) at 640x480 with the default
                   ProjectiveIcpConfig, against known twists.
  6. register_normal_space -- the 64 pairs with sample_mode="normal_space".
  6b. gn_profile -- a profiler window over one projective_icp_sampled call
                   at B=512 and at B=1: device kernels per call (at most
                   40), gn_round launches (sum(cfg.iters)) and the device's
                   busy share of the call's host time.
  7. tracker    -- Tracker(method="projective") over a 30-frame 640x480
                   trajectory: every frame succeeds, ATE rmse < 0.02 m.
  8. keyframe   -- Tracker(method="keyframe") over 88 u16 640x480 frames
                   (the bench.py:37-100 workload), per frame and in windows
                   of 8, the two modes in turns: identical results, every
                   frame tracked, ATE rmse < 0.02 m, one device-to-host copy
                   per window (profiler trace).
  8b. world_map -- Tracker(method="projective", map_capacity=65536) over
                   the 30 frames of phase 7: every frame succeeds, ATE rmse
                   < 0.02 m, the map count after 10 frames within 1% of the
                   same code's CPU run.
  8c. model     -- Tracker(method="model") (frame-to-model: 32768-point
                   model, 4096-point frames, 128 ICP iterations) over 20
                   640x480 frames: every frame succeeds, the last pose
                   within 0.05 of the truth, > 100 map points, and the
                   first 3 frames within 1e-3 (twist) of the CPU run.
  8d. icp       -- Tracker(method="icp") (8192-point clouds, 128 ICP
                   iterations) over 10 640x480 frames: every frame
                   succeeds, the first 3 within 1e-3 of the CPU run.
  8e. gicp      -- Tracker(method="gicp") (8192-point clouds, GicpConfig
                   defaults: 16 rounds x 8 GN steps, cov_k 32) over the 10
                   frames of phase 8d, with the same checks.
                   Phases 8b-8e also print host ms/frame medians, device
                   syncs and copies per frame (profiler trace) and peak
                   device memory; 8c-8e also the op each sync and copy
                   comes from (sync_ops, a CPU + CUDA trace of one frame).
  8f. align_pair -- get_pipeline("gicp"), ("fpfh-kabsch-icp") and
                   ("robust-global") on the 8192-point voxel cloud of one
                   640x480 frame and that cloud moved by a known twist,
                   each with its defaults and the FPFH pipelines also with
                   the cap sized to the densest ball: gicp within 5e-3 of
                   the truth and 1e-3 of its CPU run, fpfh-kabsch-icp
                   within 1e-3 of its CPU run and, auto-sized, 5e-3 of the
                   truth (tests/test_api_cli.py:97); robust-global, whose
                   answer on this scene is not stable, within 1e-3 of its
                   CPU run and valid on an 8192-point Gaussian cloud and
                   its moved copy. Prints the truth gaps, the FPFH
                   truncation flag, ms, syncs and copies per pair, the GNC
                   and peel rounds, peak memory, and (no bar) the truth
                   gaps between two frames' own clouds.
  8g. rgbd      -- Tracker(method="rgbd") (default RgbdIcpConfig) over 10
                   640x480 RGB-D frames with u8 color: every frame succeeds,
                   ATE rmse < 0.02 m, the first 3 frames within 1e-4 (twist)
                   of the CPU run; gn_system launches sum(cfg.iters) + 1 per
                   tracked frame, gn_round none; RgbdKeyframeTracker's
                   process_window(window=8) equals its per-frame process; one
                   device-to-host copy per frame and per window (profiler
                   trace); host ms/frame, device kernels per frame.
  9. timing     -- downsample, level and GN kernels vs their plain versions
                   at B=512 (640x480, L=4; per level shape; gn_round also at
                   B=1, level 0, the trackers' shape, and at level 0 with
                   8192 and 16384 points, register and streamed), in turns, and
                   register_batch_chunked pairs/s on 2048 pairs, chunk 512;
                   phase gn_system: gn_system (one association and the 6x6
                   system, no solve) against its plain version at B=512 and
                   B=1 on the four level shapes -- H and b within 1e-5 of
                   trace(H), ok_count equal, wsse and wsum within 1e-5
                   relative, two launches bit-identical -- and timed; the
                   same bars with an association pose T_assoc an inner
                   step from T (the point-sharded inner step), and
                   T_assoc=T bit-identical to the entry without one;
                   ops.correspond.k_smallest (the tie-stable k-NN) against
                   a stable sort of each row at the k-NN shapes of GICP and
                   FPFH.
  10. backbone_kernel -- holds backbone_factor and backbone_apply (the
                   port's own kernel for the pose graph's backbone
                   preconditioner: block cyclic reduction in f64) against
                   their plain versions on the backbone blocks of a 64- and
                   a 1000-node graph's first GN iteration: S_inv, U and z
                   within 1e-10 of their largest entry (bit for bit
                   expected), the kernel's solve no further from an f64
                   solve than twice the plain version's (+1e-6), a singular
                   block's non-finite factors on the plain version's blocks
                   and the apply's guard returning r, and a block singular
                   only from the left (an indefinite M, where JAX's LDL^T
                   returns r) solved to a finite z, bit for bit as the plain
                   version; timed against the plain version and, in turns,
                   against the previous design (csrc/alternatives/
                   backbone_chain.cu, a block walking the chain), with the
                   bound over f64's peak and, beside it in this line only,
                   an estimated latency floor of the critical path (from
                   assumed, not measured, Hopper latencies).
  11. pose_graph -- optimize_pose_graph on the 1000-node 5-lap graph of
                   tests/test_posegraph_loops.py:96-120 (numpy seed 3), 6 GN x
                   60 backbone-preconditioned CG steps: cost within 1.05x of a
                   1500-step unpreconditioned run, the max position error
                   halved, the card within 1e-4 of the CPU after one GN
                   iteration and, after six, within ten times the move of the
                   CPU's own result under a one-ulp change of its input; ms,
                   device kernels, syncs and copies by kind per call (the SLAM
                   defaults, 10 x 60) at K = 16, 64 and 1000 nodes: no sync and
                   no device-to-host copy before the result is read.
  12. slam      -- SlamTracker at 640x480 over the 120-frame out-and-back of
                   tools/tpu/synth640.py (numpy seed 7), rendered by the port,
                   u16 at 1/5000 m, SlamConfig defaults (deferred booking),
                   then optimize(): >= 1 loop closure, every loop edge within
                   0.05 twist of the truth, keyframe ATE no worse after
                   optimize (+1e-4), gn_round sum(iters) launches per tracked
                   frame, deferred booking equal to synchronous over 40
                   frames, the card within 1e-4 of the CPU over 20; host ms per
                   frame (median, p90 after 10 frames) and per frame after an
                   event, syncs, copies and device kernels per frame by its
                   place in the booking pipeline.

  13. tsdf_kernels -- holds the port's own TSDF kernels against their plain
                   versions on the card. csrc/tsdf_integrate.cu (tile map,
                   brick cull, update of the kept bricks) bit-identical to
                   fuse_block_reference over 10 fused 640x480 frames into
                   the default 128^3 x 4 cm volume: full pass, slab window
                   (integrate_slab=96), colored, x-slabs of 32 planes from
                   x0 = 64 (equal to the whole volume's planes) and of 37
                   from x0 = 61, 32 adversarial poses at V = 40, 48, 96 and
                   128, frames without valid depth and a closed gate (the
                   volume unchanged, no brick kept), and the slot entry
                   (4 slots, mixed gates, one call) against a call per
                   slot; for each frame the cull launched alone lists the
                   plain twin's bricks, which hold every voxel the update
                   predicate takes; the kept and updated shares at 128^3
                   and 512^3. csrc/tsdf_raycast.cu, raycast and
                   raycast_coarse_to_fine(coarse=4) at 640x480 on the
                   fused volume and at KinectFusion's 512^3 (1 GiB of tsdf
                   and weight), bit-identical to the plain version, full
                   and coarse-to-fine; times both kernels against their
                   plain versions at 128^3 and 512^3, with the bounds and
                   the march's gather count.
  14. tsdf      -- Tracker(method="tsdf"), default TsdfConfig, over the 30
                   u16 frames of phase 7, per frame and in windows of 8 in
                   turns: every frame succeeds, ATE rmse < 0.02 m, the modes
                   within 1e-6, one device-to-host copy per frame and per
                   window, the first 3 frames within 1e-4 of the CPU run,
                   per tracked frame sum(iters) gn_round launches, one
                   raycast and one integrate; ms per frame, device kernels
                   per frame and the busy share; then again with
                   track_scale=2, raycast_coarse=4.
  15. tsdf_rgbd -- use_color with photometric=RgbdIcpConfig() over 10
                   RGB-D frames: every frame succeeds, gn_system launches
                   sum(iters) + 1 per tracked frame; ms per frame.
  16. mesh_surface -- extract_mesh (131072 triangles) and
                   extract_surface_oriented of phase 14's volume: counts
                   and masks equal to the CPU run's, vertices within 1e-5.
  17. submaps   -- Tracker(method="tsdf", tsdf_submap_radius=0.96) along a
                   3 m corridor and back that leaves a 96^3 x 4 cm volume:
                   >= 2 spawns and >= 1 re-entry; optimize_atlas of the
                   same walk without re-entry accepts >= 1 loop edge; ms
                   per frame and per optimize_atlas.
  18. serve_batched -- 8 producer threads x 30 u16 640x480 frames (each
                   session its own seeded walk, 1/5000 m) through a
                   TrackingService on 127.0.0.1 over BatchedExecutor
                   (capacity 8): every frame tracks, ATE rmse < 0.02 m per
                   session, no dispatch error, sum(iters) gn_round
                   launches per dispatch, each session equal to itself
                   served alone (1e-6 twist) and its first 3 frames to the
                   CPU executor (1e-4), one device-to-host copy per
                   dispatch (profiler trace); frames/s, latency p50/p90,
                   slots and device kernels per dispatch, busy share, and
                   8 serialized Tracker(method="projective") sessions
                   behind the plain service in turns with it.
  19. serve_window -- 4 sessions posting /track_window (window 8): equal to
                   /track per frame, one copy per dispatch.
  20. serve_rgbd -- 4 RGB-D sessions x 10 frames, u8 color, capacity 4:
                   sum(iters) + 1 gn_system launches per dispatch, every
                   frame tracks, 3 frames against the CPU executor.
  21. serve_tsdf -- 4 dense sessions (128^3 slots) over phase 7's walk:
                   ATE, 1e-4 of TsdfTracker, S raycasts and S integrates
                   per dispatch; a 0.05 m submap radius reseeds.
  22. serve_plain -- the unbatched service with Tracker(method="keyframe")
                   equal to the tracker called directly.
  23. rs_serve  -- python -m realsensetracker_tpu_torch.cli.rs_serve
                   --batched --max-frames 4 as a subprocess: exit 0,
                   "served 4 frames".
  24. replay    -- host I/O and rs_replay (cli.rs_replay.main, in-process)
                   on a 60-frame 640x480 TUM-layout sequence (16-bit depth
                   PNGs at 1/5000 m, groundtruth.txt) and a 60-frame v2
                   .rsc clip with color, written by the port in a temporary
                   directory: (a) --tum --method projective --ate (ATE
                   rmse < 0.02 m), (b) the same 10 frames with --device cpu
                   (poses within 1e-4), (c) --record --method keyframe
                   --window 8, (d) --method tsdf --save-mesh, (e) --method
                   rgbd, each with its launch counts and ATE against the
                   walk; host ms per frame and frames/s per run; producer
                   decode ms per frame, native and numpy PNG path (bit-equal
                   on every frame; which one TumSequence used and why);
                   host syncs, device-to-host and host-to-device copies per
                   frame from two profiler windows differenced (1 sync per
                   frame, the pose read; none from staging), FrameStream's
                   own upload count (one u16 frame per frame in each
                   window) with the trace's frame-sized copies beside it
                   (never more), the upload stream against the compute
                   stream and the uploads' overlap with kernels, the busy
                   share; prefetch=2 against an inline load, in turns.

  25. cli        -- the remaining entry points through their main(argv) at
                   640x480, in-process: rs_benchmark projective-icp at its
                   defaults (B=64, 10 calls) and at bench.py's workload
                   (--batch 2048 --chunk 512 --iters 3), each JSON line
                   printed, the second beside phase 9's timing_register
                   rate, sum(iters) gn_round launches per registration or
                   chunk; the same with --profile (the trace's gn_round,
                   level and downsample kernels per call); its inputs
                   (rs_benchmark.projective_inputs) registered once, every
                   pair within 3e-3 of the rendered twist; the gicp and
                   gnc-icp (4 x 4096 points, no kernel), rgbd (B=8,
                   sum(iters) + 1 gn_system launches per call),
                   slam-window and tsdf-window (40 frames, window 8)
                   pipelines; rs_streams with its defaults (8 x 30),
                   --window 8, --rgb (8 x 6) and --tsdf (8 x 10, 128^3),
                   every stream tracking, the launches per step counted,
                   FPS/stream and config 5 MET or not, and each mode at
                   160x120, 2 x 4 frames, within 1e-4 (poses) of the CPU;
                   rs_align on two frames of a 640x480 clip (default
                   flags, --capacity 8192) within 1e-3 of the CPU, its
                   truth gaps printed; capture --clip and rs_viewer --view
                   --ply-dir with the PLY point counts of the CPU run;
                   rs_viewer --loop --record --live-latest (8 frames).
  26. multidevice -- the multi-device layer on a world-size-1 NCCL group
                   (a 1x1 mesh: one card, every collective run and each
                   the identity) at 640x480 with the default config:
                   register_batch_point_sharded and register_batch_sharded
                   on 64 pairs within 1e-5 (twist) of register_batch, the
                   first with rounds x inner_iters gn_system launches (the
                   association pose set) and no gn_round; the sharded
                   integrate of a frame into 128^3 and 512^3 bit-identical
                   to the unsharded volume and its raycast through the slab
                   gather within 1e-5; 8 producers x 30 u16 frames through
                   BatchingConfig(mesh=...) within 1e-6 of the unsharded
                   executor; optimize_atlas(mesh=...) on phase 17's atlas
                   with its edges and trajectory; dryrun_multichip(1); the
                   all-reduce's and the all-gathers' ms per call.
  27. kernel_alone -- the backbone (factor, apply at n = 64 and 1000), the
                   raycast (full and coarse-to-fine refine march at
                   640x480 into 128^3) and the integrate (at 128^3 and
                   512^3; its tile map and cull alone) timed alone: each
                   one's calls in one CUDA graph, the backbone and the
                   integrate in turns with their previous designs.

Each main path (register, register_normal_space, tracker, keyframe,
world_map, model, icp, gicp, align_pair, rgbd, pose_graph, slam, tsdf,
tsdf_rgbd, submaps, serve_batched, serve_window, serve_rgbd, serve_tsdf,
the replay runs a, c, d and e, each CLI run of phase 25, and phase 26's
point-sharded and data-parallel registrations, sharded integrates and
raycasts and sharded serving) runs with
every launch count set to 0 just before it and read just after; a kernel
the path runs must have launched there, and the cloud paths (model, icp,
gicp, align_pair, rs_benchmark gicp and gnc-icp), which run no kernel of
their own, must have launched none. Then the kernels line, with each kernel's bound (the
larger of its bytes over 3.35 TB/s and its operations over 67 TFLOP/s in
f32, 34 TFLOP/s in f64 for the backbone, from this run's inputs), and last
{"ok": true, "device": {...}}.
Any failed check raises: the exit code is non-zero and the last line is
not printed. Every phase line carries the seconds since the start and the
process's user and system CPU seconds. The script first starts itself
again with glibc's large blocks kept on the heap (MALLOC_ENV).

    python3 chip_smoke.py --against OTHER_ROOT [--rounds N]

times the dense tracker of this checkout against another checkout of the
repository (an earlier commit unpacked with git archive), in turns: one
fresh process per measurement, OTHER, this, this, OTHER, N rounds
(tree_host_ms: Tracker(method="tsdf") host ms per frame over phase 14's
30-frame walk at 640x480 into 128^3, and host ms per integrate call with
its launches). It prints the card's nvidia-smi line and one JSON line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import types
import warnings
from concurrent.futures import ThreadPoolExecutor

ATOL = 2e-5  # level kernel vs plain version (tests/test_kernels.py:29)
GN_TWIST_BAR = 1e-5  # gn_round's pose vs its plain version, twist of T_ref^-1 T
GN_COUNT_BAR = 1e-3  # matched count vs plain version, fraction of P
GN_RMSE_BAR = 1e-4  # rmse vs plain version, relative
MAX_KERNELS_PER_ICP = 40  # device kernels of one projective_icp_sampled call
TWIST_BAR_IDENTITY = 1e-4  # tests/test_projective_icp.py:65
TWIST_BAR_MOTION = 3e-3  # tests/test_projective_icp.py:81
TWIST_BAR_CPU = 1e-4  # CUDA vs the same code on CPU (the JAX parity bar)
ATE_BAR = 0.02  # meters, tests/test_tracking.py:40
ULP_BAR = 2  # downsample kernel vs plain version, depth
MAP_COUNT_BAR = 0.01  # world map count, CUDA vs CPU, relative
MODEL_TRUTH_BAR = 0.05  # tests/test_tracking.py:249-251
CLOUD_CPU_BAR = 1e-3  # model / icp / gicp twist, CUDA vs CPU, first 3 frames; pipelines
PIPELINE_TRUTH_BAR = 5e-3  # gicp and fpfh-kabsch-icp vs the known twist (tests/test_api_cli.py:97)
SYSTEM_BAR = 1e-5  # gn_system's H and b vs the plain version, of trace(H)
BACKBONE_PLAIN_BAR = 1e-10  # backbone kernel vs its plain version (S_inv, U, z), of the largest entry
HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak HBM3 bandwidth
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
F64_FLOPS_PER_S = 34e12  # H100 SXM f64 outside the tensor cores (NVIDIA's data sheet)
# An estimate of the backbone's latency floor (backbone_latency_floor):
# cycles of the dependent operations on its critical path, approximate
# Hopper latencies (assumed, not measured): a warp shuffle, an f64 divide
# (a Newton sequence), an f64 add or multiply, a block barrier, an L2 round
# trip and a shared-memory round trip. Printed in phase 10's line only.
LATENCY_CYCLES = {"shfl": 30, "ddiv": 150, "dop": 8, "barrier": 40, "l2": 300, "smem": 30}
# The backbone's previous design, which this script times the kernel
# against (a block walking the chain; no path of the port launches it).
PREVIOUS_BACKBONE = "alternatives/backbone_chain.cu"
# The integrate's previous design, timed in turns with the brick kernel (one
# thread per voxel of the whole grid; no path of the port launches it).
PREVIOUS_INTEGRATE = "alternatives/tsdf_integrate_flat.cu"
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    # The stride-2 compaction probes (stride2_slice :103, stride2_reshape
    # :115): the in-kernel 2x2 downsample between pyramid levels.
    "downsample_levels": (
        "realsensetracker_tpu_torch/csrc/downsample.cu",
        "tools/tpu/mosaic_probe5.py:103",
    ),
    "build_level_packed": (
        "realsensetracker_tpu_torch/csrc/level_kernel.cu",
        "realsensetracker_tpu/kernels/level_kernel.py:42",
    ),
    # The gather probes (lane_gather_w256 :53, lane_gather_w640 :66,
    # sublane_gather :79) and the reduction-layout probe (reshape_cross_lane
    # :91) of the fused GN step that Mosaic could not lower.
    "gn_round": ("realsensetracker_tpu_torch/csrc/gn_step.cu", "tools/tpu/mosaic_probe5.py:53,91"),
    # The same probes, for the unsolved system of the joint RGB-D step.
    "gn_system": ("realsensetracker_tpu_torch/csrc/gn_step.cu", "tools/tpu/mosaic_probe5.py:53,91"),
    # Not a Pallas kernel: the plain-XLA lax.scans of the backbone
    # preconditioner's factor (:222) and apply (:232), the port's own kernel.
    "backbone": ("realsensetracker_tpu_torch/csrc/backbone.cu", "realsensetracker_tpu/optimize/pose_graph.py:222,232"),
    # Not Pallas kernels either: the plain-XLA integrate (_fuse_block :277)
    # and raycast march (_march :446, _refine_subvoxel :548), the port's own.
    "tsdf_integrate": ("realsensetracker_tpu_torch/csrc/tsdf_integrate.cu", "realsensetracker_tpu/mapping/tsdf.py:277"),
    # The integrate's first launch: the frame's largest valid
    # depth per 16x16 pixels, which the brick cull reads; part of _fuse_block.
    "tsdf_depth_tiles": ("realsensetracker_tpu_torch/csrc/tsdf_integrate.cu", "realsensetracker_tpu/mapping/tsdf.py:277"),
    # Its second: the bricks that can hold an updated voxel,
    # listed on the device for the third, the update itself.
    "tsdf_cull": ("realsensetracker_tpu_torch/csrc/tsdf_integrate.cu", "realsensetracker_tpu/mapping/tsdf.py:277"),
    "tsdf_raycast": ("realsensetracker_tpu_torch/csrc/tsdf_raycast.cu", "realsensetracker_tpu/mapping/tsdf.py:446,548"),
}


# The CPU comparisons allocate distance blocks of tens to hundreds of MB at
# every search step. glibc would map each one afresh and unmap it on free,
# and the page faults of the fresh pages cost as much as the arithmetic:
# with these set, large blocks come from the heap and stay there for reuse.
# glibc reads them at start-up, so the script starts itself again once.
MALLOC_ENV = {"MALLOC_MMAP_THRESHOLD_": str(4 << 30), "MALLOC_TRIM_THRESHOLD_": str(16 << 30)}

_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script started and
    the process's CPU seconds so far (user, system)."""
    cpu = os.times()
    print(json.dumps({"phase": phase, **fields, "elapsed_s": time.perf_counter() - _START,
                      "user_s": cpu.user, "sys_s": cpu.system}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def previous_backbone():
    """ctypes bindings of the backbone's previous design, the sequential
    block-LDL^T chain: factor (D, O) -> (S_inv (n,6,6), U (n-1,6,6)) and
    apply (S_inv, U, r) -> z."""
    import ctypes

    import torch

    from realsensetracker_tpu_torch.kernels import build

    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    bb = build.load(PREVIOUS_BACKBONE)
    bb.rst_backbone_factor.argtypes = [ptr, ptr, ptr, ptr, i32, ptr]
    bb.rst_backbone_apply.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, ptr]
    stream = lambda t: torch.cuda.current_stream(t.device).cuda_stream  # noqa: E731

    def chain_factor(D, O):
        n = D.shape[0]
        S, U = torch.empty((n, 6, 6), dtype=torch.float64, device=D.device), torch.empty(
            (n - 1, 6, 6), dtype=torch.float64, device=D.device)
        err = bb.rst_backbone_factor(D.data_ptr(), O.data_ptr(), S.data_ptr(), U.data_ptr(), n, stream(D))
        check(err == 0, "previous backbone factor")
        return S, U

    def chain_apply(S, U, r):
        n = S.shape[0]
        y = torch.empty(12 * n, dtype=torch.float64, device=r.device)
        z = torch.empty_like(r)
        err = bb.rst_backbone_apply(S.data_ptr(), U.data_ptr(), r.data_ptr(), y.data_ptr(), z.data_ptr(), n,
                                    stream(r))
        check(err == 0, "previous backbone apply")
        return z

    return types.SimpleNamespace(chain_factor=chain_factor, chain_apply=chain_apply)


def previous_integrate():
    """ctypes binding of the integrate's previous design (one thread per
    voxel of the whole grid): flat(vol, depth, pose_cam_from_world, intr,
    cfg) fuses one frame into a depth-only volume in place."""
    import ctypes

    import torch

    from realsensetracker_tpu_torch.kernels import build
    from realsensetracker_tpu_torch.mapping.tsdf import f32

    ptr, i32, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = build.load(PREVIOUS_INTEGRATE)
    lib.rst_tsdf_integrate.argtypes = [ptr] * 10 + [i32] * 6 + [f] * 13 + [ptr]

    def flat(vol, depth, pcw, intr, cfg):
        v, o = cfg.resolution, cfg.origin
        h, w = depth.shape
        err = lib.rst_tsdf_integrate(
            vol.tsdf.data_ptr(), vol.weight.data_ptr(), None, None, depth.data_ptr(), None, pcw.data_ptr(),
            None, None, None, v, 0, v, h, w, 0, f32(intr.fx), f32(intr.fy), f32(intr.cx), f32(intr.cy),
            f32(o[0]), f32(o[1]), f32(o[2]), f32(cfg.voxel_size), f32(cfg.trunc), f32(1.0 / cfg.trunc),
            f32(cfg.min_depth), f32(cfg.max_depth), f32(cfg.max_weight),
            torch.cuda.current_stream(depth.device).cuda_stream)
        check(err == 0, "previous integrate")

    return flat


def tree_host_ms(root: str) -> dict:
    """Host ms of the dense main path with the package of checkout ``root``
    (imported from there, in this process): Tracker(method="tsdf") over
    phase 14's 30-frame walk as u16 at 640x480 into the default 128^3
    volume, per frame (a tracker warmed on 3 frames first; the median and
    mean of frames 2-30, each process() ending in its one host copy); and
    mapping.tsdf.integrate of the walk's last frame into a volume holding
    the first ten, 200 calls in a row, and kernels.tsdf.fuse_block alone
    (the pose inverted once), 1000 calls, per call with its launches (wall
    time to a sync after the last)."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import realsensetracker_tpu_torch as pkg
    from realsensetracker_tpu_torch.api import Tracker, TrackerConfig
    from realsensetracker_tpu_torch.data import synthetic
    from realsensetracker_tpu_torch.geometry import camera, se3
    from realsensetracker_tpu_torch.kernels import tsdf as tsdf_kernels
    from realsensetracker_tpu_torch.mapping import tsdf as tsdf_mod

    check(os.path.dirname(os.path.abspath(pkg.__file__)) == os.path.join(os.path.abspath(root), pkg.__name__),
          f"tree_host_ms: imported {pkg.__file__}, not the package of {root}")
    dev, intr = torch.device("cuda", 0), camera.TUM_FR1
    walk_d, walk_poses = synthetic.render_trajectory(intr, 30, seed=0, device=dev)
    frames = [torch.from_numpy(np.clip(d * 1000.0, 0, 65000).astype(np.uint16)).to(dev) for d in walk_d.cpu().numpy()]
    cfg = TrackerConfig(intrinsics=intr, method="tsdf", device="cuda")
    warm = Tracker(cfg)
    for f in frames[:3]:
        warm.process(f)
    tracker, ms = Tracker(cfg), []
    for i, f in enumerate(frames):
        t0 = time.perf_counter()
        res = tracker.process(f, float(i))
        ms.append((time.perf_counter() - t0) * 1e3)
        check(res.success, f"tree_host_ms: frame {i} failed")
    vcfg = tsdf_mod.TsdfConfig()
    vol = tsdf_mod.init_volume(vcfg, device=dev)
    for i in range(10):
        tsdf_mod.integrate(vol, walk_d[i], walk_poses[i], intr, vcfg)
    d, T = walk_d[-1], walk_poses[-1]
    tsdf_mod.integrate(vol, d, T, intr, vcfg)
    pcw = se3.inverse(T).contiguous()

    def per_call(fn, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    return {"root": root, "frame_ms_median": statistics.median(ms[1:]), "frame_ms_mean": statistics.mean(ms[1:]),
            "integrate_ms": per_call(lambda: tsdf_mod.integrate(vol, d, T, intr, vcfg), 200),
            "fuse_block_ms": per_call(lambda: tsdf_kernels.fuse_block(vol, d, None, pcw, intr, vcfg), 1000)}


def against(other: str, rounds: int) -> None:
    """tree_host_ms of ``other`` and of this checkout in turns (other, this,
    this, other per round), each in a fresh process: one JSON line."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card")
    here = os.path.dirname(os.path.abspath(__file__))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    runs = {"other": [], "this": []}
    for _ in range(rounds):
        for name in ("other", "this", "this", "other"):
            root = os.path.abspath(other) if name == "other" else here
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree-ms", root], capture_output=True,
                                 text=True, timeout=600, cwd=root)
            check(out.returncode == 0, f"tree_host_ms of {root} failed: {out.stderr[-2000:]}")
            runs[name].append(json.loads(out.stdout.strip().splitlines()[-1]))
    summary = {name: {k: [r[k] for r in rs] for k in ("frame_ms_median", "frame_ms_mean", "integrate_ms", "fuse_block_ms")}
               for name, rs in runs.items()}
    print(json.dumps({"phase": "against", "other": os.path.abspath(other), "rounds": rounds, "runs": summary}),
          flush=True)


def look_at(forward, pos):
    """world_from_cam (4, 4) f32 at ``pos`` with the camera's +z along
    ``forward`` (an exact axis gives a rotation of 0s and 1s)."""
    import numpy as np

    f = np.asarray(forward, np.float64)
    f = f / np.linalg.norm(f)
    helper = np.array([0.0, 1.0, 0.0]) if abs(f[1]) < 0.9 else np.array([1.0, 0.0, 0.0])
    x = np.cross(helper, f)
    x = x / np.linalg.norm(x)
    T = np.eye(4)
    T[:3, :3] = np.stack([x, np.cross(f, x), f], 1)
    T[:3, 3] = pos
    return T.astype(np.float32)


def adversarial_poses(cfg, n: int, seed: int = 0):
    """(n, 4, 4) f32 world_from_cam poses that stress the integrate's brick
    cull in the volume of ``cfg``, in turn: on a brick corner inside the
    volume looking exactly along an axis (frustum planes on voxel planes),
    on a face of the volume looking along it (grazing), outside looking in,
    and anywhere in or around it at a random tilt."""
    import numpy as np

    rng = np.random.RandomState(seed)
    v, vs = cfg.resolution, cfg.voxel_size
    lo, ext = np.array(cfg.origin, np.float64), cfg.resolution * cfg.voxel_size
    axes = np.concatenate([np.eye(3), -np.eye(3)])
    poses = []
    for k in range(n):
        if k % 4 == 0:
            corner = np.array([8 * rng.randint(-(-v // 8) + 1), 8 * rng.randint(-(-v // 8) + 1),
                               32 * rng.randint(-(-v // 32) + 1)])
            pos, fwd = lo + np.minimum(corner, v) * vs, axes[rng.randint(6)]
        elif k % 4 == 1:
            a = rng.randint(3)
            pos = lo + ext * rng.rand(3)
            pos[a] = lo[a] + ext * rng.randint(2)
            fwd = axes[(a + 1 + rng.randint(2)) % 3] * rng.choice([-1.0, 1.0])
        elif k % 4 == 2:
            d = rng.randn(3)
            pos = lo + ext / 2 + d / np.linalg.norm(d) * ext * rng.uniform(0.6, 1.5)
            fwd = lo + ext / 2 - pos + 0.1 * ext * rng.randn(3)
        else:
            pos, fwd = lo + ext * rng.uniform(-0.2, 1.2, 3), rng.randn(3)
        poses.append(look_at(fwd, pos))
    return np.stack(poses)


def backbone_work(n: int) -> tuple[int, int]:
    """(bytes, f64 operations) of one factor and one apply at n nodes:
    D and O in, S_inv and U (UL, UR) out, r in and z out; per eliminated
    node the Gauss-Jordan inverse (~880) and UL, UR (864), per kept node
    and level the next A and B (1,368); per apply ~156 per kept node and
    level, ~228 per eliminated node."""
    from realsensetracker_tpu_torch.kernels import backbone

    kept = sum(len(j) for _, _, j in backbone.levels(n))
    nbytes = 4 * 36 * (2 * n - 1) + 8 * 36 * 3 * n + 8 * 36 * 3 * n + 2 * 4 * 6 * n
    return nbytes, n * (880 + 864) + kept * 1368 + kept * 156 + n * 228


def backbone_latency_floor(n: int, clock_hz: float) -> float:
    """An estimate, not a measurement: ms of the critical path of one
    factor and one apply at the assumed LATENCY_CYCLES and the card's
    maximum SM clock:
    per level the factor's two phases each wait on an L2 round trip and a
    barrier, an inversion chains 6 pivot steps (2 shuffles, a divide, 2
    f64 operations) and its product 6 multiply-adds after 6 shuffles; the
    apply's two passes chain a shared-memory read, 6 multiply-adds and a
    barrier per level."""
    from realsensetracker_tpu_torch.kernels import backbone

    c = LATENCY_CYCLES
    lv = len(backbone.levels(n))
    factor = lv * (2 * (c["l2"] + c["barrier"]) + 6 * (2 * c["shfl"] + c["ddiv"] + 2 * c["dop"])
                   + 6 * c["shfl"] + 12 * c["dop"])
    apply = 2 * lv * (c["smem"] + 12 * c["dop"] + c["barrier"])
    return (factor + apply) / clock_hz * 1e3


def backbone_and_slam_phases(ctx) -> dict:
    """Phases 10-12: the backbone kernel against its plain version, pose-graph
    optimization, and SLAM at 640x480. ctx carries main()'s helpers (dev,
    card, reset_counts, read_counts, check_counts, bound, turns, time_ms,
    ate_of, slam_intr: the SLAM phase's camera). Returns the backbone row's numbers for the kernels line."""
    import numpy as np
    import torch

    from realsensetracker_tpu_torch.align import projective
    from realsensetracker_tpu_torch.data import synthetic
    from realsensetracker_tpu_torch.kernels import backbone
    from realsensetracker_tpu_torch.optimize import pose_graph as pg
    from realsensetracker_tpu_torch.tracking import trajectory
    from realsensetracker_tpu_torch.tracking.slam import SlamConfig, SlamTracker, _se3_log_np

    dev, card = ctx.dev, ctx.card

    # ---- 10. backbone kernel vs plain version ------------------------------
    def blocks_of(graph, n, lm=1e-6):
        """The backbone blocks and right-hand side of a graph's first GN
        iteration, as optimize_pose_graph builds them."""
        zero = torch.zeros((n, 6), dtype=torch.float32, device=dev)
        r_edges = pg._edge_residuals(zero, graph)
        w_rob = pg.robust_weights(r_edges, 0.1, use_gm=False)
        J = pg.edge_jacobians(graph, graph.poses, graph.weights * w_rob)
        D, O = pg.backbone_blocks(graph, J, n, torch.full((), lm, device=dev))
        return D, O, -pg.gradient(J, graph, (r_edges * w_rob[:, None]).reshape(-1), n)

    graphs = {16: synthetic.lap_graph(2, 8, seed=3, loop_every=4), 64: synthetic.lap_graph(2, 32, seed=3, loop_every=4),
              1000: synthetic.lap_graph(5, 200, seed=3)}
    prev = previous_backbone()
    clock_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    rel = lambda a, b: ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()  # noqa: E731
    bb_rows, bb_err = [], 0.0
    for k_ in (64, 1000):
        _, est, loops = graphs[k_]
        n = est.shape[0]
        D, O, r = blocks_of(pg.from_trajectory(est, loop_edges=loops, device=dev), n)
        S, U = backbone.backbone_factor(D, O)
        z = backbone.backbone_apply(S, U, r)
        S_ref, U_ref = backbone.backbone_factor_reference(D, O)
        z_ref = backbone.backbone_apply_reference(S_ref, U_ref, r)
        z_mixed = backbone.backbone_apply(S_ref.contiguous(), U_ref.contiguous(), r)
        S64, U64 = backbone.backbone_factor_reference(D.double(), O.double())
        z64 = backbone.backbone_apply_reference(S64, U64, r.double())
        S_old, U_old = prev.chain_factor(D, O)
        z_old = prev.chain_apply(S_old, U_old, r)
        torch.cuda.synchronize()
        gaps = {"S_inv": rel(S, S_ref), "U": rel(U, U_ref), "z": rel(z, z_ref), "apply_on_plain_factors":
                rel(z_mixed, z_ref)}
        err_k, err_p, err_old = rel(z, z64), rel(z_ref, z64), rel(z_old, z64)
        what = f"backbone at n={n}"
        check(max(gaps.values()) <= BACKBONE_PLAIN_BAR, f"{what}: kernel vs plain {gaps} > {BACKBONE_PLAIN_BAR}")
        check(err_k <= 2 * err_p + 1e-6, f"{what}: kernel {err_k} from the f64 solve, plain {err_p}")
        bits = torch.equal(S, S_ref) and torch.equal(U, U_ref) and torch.equal(z, z_ref)
        err = max((S - S_ref).abs().max().item(), (U - U_ref).abs().max().item(), (z - z_ref).abs().max().item())
        bb_err = max(bb_err, err)
        # The previous design (one block walking the chain) in turns with the new one.
        f_new, f_old = ctx.turns(lambda: prev.chain_factor(D, O), lambda: backbone.backbone_factor(D, O), 50, 50)
        a_new, a_old = ctx.turns(lambda: prev.chain_apply(S_old, U_old, r), lambda: backbone.backbone_apply(S, U, r),
                                 200, 200)
        k_ms, p_ms = ctx.turns(lambda: backbone.backbone_apply_reference(*backbone.backbone_factor_reference(D, O), r),
                               lambda: backbone.backbone_apply(*backbone.backbone_factor(D, O), r), 2, 50)
        nbytes, flops = backbone_work(n)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F64_FLOPS_PER_S * 1e3
        b_ms, b_by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
        bb_rows.append({"n": n, "levels": len(backbone.levels(n)), "kernel_vs_plain": gaps, "bit_identical": bits,
                        "kernel_vs_f64": err_k, "plain_vs_f64": err_p, "previous_vs_f64": err_old,
                        "max_abs_err": err, "ms": k_ms, "factor_ms": f_new, "apply_ms": a_new, "plain_ms": p_ms,
                        "previous_factor_ms": f_old, "previous_apply_ms": a_old, "previous_ms": f_old + a_old,
                        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "f64_ops": flops,
                        "latency_floor_estimate_ms": backbone_latency_floor(n, clock_hz),
                        "latency_floor_estimate_from": {"assumed_cycles": LATENCY_CYCLES, "max_sm_clock_hz": clock_hz},
                        "dependent_phases": {"factor": 2 * len(backbone.levels(n)),
                                             "apply": 2 * len(backbone.levels(n))}})
    # The guard: a singular block (A_17 = 0 and decoupled, so it is still 0
    # when the reduction inverts it) leaves non-finite factors on the same
    # blocks in both versions, and the apply then returns r itself.
    D, O, r = blocks_of(pg.from_trajectory(graphs[64][1], loop_edges=graphs[64][2], device=dev), graphs[64][1].shape[0])
    D_left, O_left = D.clone(), O.clone()
    D[17], O[16], O[17] = -backbone.DIAG * torch.eye(6, device=dev), 0.0, 0.0
    S, U = backbone.backbone_factor(D, O)
    S_ref, U_ref = backbone.backbone_factor_reference(D, O)
    bad = lambda t: (~torch.isfinite(t)).flatten(1).any(-1)  # noqa: E731
    check(torch.equal(bad(S), bad(S_ref)) and bool(bad(S)[17]), "backbone guard: non-finite blocks differ")
    check(torch.equal(backbone.backbone_apply(S, U, r), r), "backbone guard: the apply did not return r")
    guard_blocks = int(bad(S).sum().item())
    # A block singular only from the left (A_17 = 0, O_16 = 0, O_17 kept):
    # M is indefinite, JAX's LDL^T meets S_17 = 0 and its guard returns r;
    # the reduction keeps node 17 at the first level, where its right
    # neighbour makes it regular, and solves to a finite z, in the kernel
    # as in the plain version.
    D_left[17], O_left[16] = -backbone.DIAG * torch.eye(6, device=dev), 0.0
    z_left = backbone.backbone_apply(*backbone.backbone_factor(D_left, O_left), r)
    z_left_ref = backbone.backbone_apply_reference(*backbone.backbone_factor_reference(D_left, O_left), r)
    check(bool(torch.isfinite(z_left).all()) and not torch.equal(z_left, r) and torch.equal(z_left, z_left_ref),
          "backbone: a block singular only from the left is not solved as the plain version solves it")
    emit("backbone_kernel", bars={"kernel_vs_plain": BACKBONE_PLAIN_BAR, "vs_f64": "2x plain + 1e-6"},
         rows=bb_rows, guard_blocks_non_finite=guard_blocks, left_singular_block_finite_and_bit_identical=True,
         card=card)
    big = bb_rows[-1]

    # ---- 11. pose-graph optimization (main path) ----------------------------
    gt, est, loops = graphs[1000]
    graph = pg.from_trajectory(est, loop_edges=loops, device=dev)
    kw = dict(gn_iters=6, huber_delta=0.1)
    ctx.reset_counts()
    p_pcg, c_pcg = pg.optimize_pose_graph(graph, cg_iters=60, precondition=True, **kw)
    c_pcg = float(c_pcg)
    ctx.check_counts(ctx.read_counts(), "pose_graph", 0, 0, 0, backbones=6 * (1 + 61))
    _, c_ref = pg.optimize_pose_graph(graph, cg_iters=1500, precondition=False, **kw)
    _, c_plain60 = pg.optimize_pose_graph(graph, cg_iters=60, precondition=False, **kw)
    c_ref, c_plain60 = float(c_ref), float(c_plain60)
    # The card against the same code on the CPU. After the first GN
    # iteration, at the Geman-McClure switch, this graph's result follows
    # the last ulp: the CPU's own result moves by 1e-2 when the input poses
    # move by one ulp (ROADMAP section 3). So the 1e-4 bar holds at one GN
    # iteration, and at six the card's gap is held to ten times that move.
    ulp_est = np.nextafter(est, np.float32(np.inf)).astype(np.float32)
    ulp_est[:, 3, :] = est[:, 3, :]
    cpu_runs = {}
    for gi in (1, 6):
        for name_, e_ in (("cpu", est), ("cpu_ulp", ulp_est)):
            p_, c_ = pg.optimize_pose_graph(pg.from_trajectory(e_, loop_edges=loops, device="cpu"), gn_iters=gi,
                                            cg_iters=60, huber_delta=0.1)
            cpu_runs[name_, gi] = (p_, float(c_))
    p_gpu1, c_gpu1 = pg.optimize_pose_graph(graph, gn_iters=1, cg_iters=60, huber_delta=0.1)
    p_cpu, c_cpu = cpu_runs["cpu", 6]
    gap1 = {"cost_rel": abs(float(c_gpu1) / cpu_runs["cpu", 1][1] - 1),
            "pose": float((p_gpu1.cpu() - cpu_runs["cpu", 1][0]).abs().max())}
    gap6 = {"cost_rel": abs(c_pcg / c_cpu - 1), "pose": float((p_pcg.cpu() - p_cpu).abs().max())}
    ulp6 = {"cost_rel": abs(cpu_runs["cpu_ulp", 6][1] / c_cpu - 1),
            "pose": float((cpu_runs["cpu_ulp", 6][0] - p_cpu).abs().max())}
    check(c_pcg <= 1.05 * c_ref + 1e-8, f"pose_graph: PCG cost {c_pcg} > 1.05 x the 1500-step plain CG's {c_ref}")
    check(gap1["cost_rel"] <= 1e-4 and gap1["pose"] <= 1e-4, f"pose_graph: one GN iteration, card vs CPU {gap1}")
    check(gap6["cost_rel"] <= 10 * ulp6["cost_rel"] + 1e-4,
          f"pose_graph: six GN iterations, card vs CPU {gap6}, the CPU's one-ulp move {ulp6}")
    pos_err = lambda P: float(np.abs(P[:, :3, 3] - gt[:, :3, 3]).max())  # noqa: E731
    err_after = pos_err(p_pcg.cpu().numpy())
    check(err_after < 0.5 * pos_err(est), f"pose_graph: max position error {err_after} vs {pos_err(est)}")

    def profile_call(g):
        """One optimize_pose_graph call (the SLAM defaults, 10 x 60): host
        ms to its return and to the synchronize; in a trace of the call,
        before its result is read: device kernels, stream syncs, and device
        copies by kind (the DtoD ones are scalars that torch.func's
        transforms copy on the card)."""
        pg.optimize_pose_graph(g, gn_iters=10, cg_iters=60)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        poses_, _ = pg.optimize_pose_graph(g, gn_iters=10, cg_iters=60)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t0) * 1e3
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            pg.optimize_pose_graph(g, gn_iters=10, cg_iters=60)
        names = [e.name for e in prof.events()]
        poses_.cpu()  # the read
        return {"ms_to_return": enqueue_ms, "ms_to_sync": total_ms,
                "device_kernels": sum(n_.startswith("cudaLaunchKernel") for n_ in names),
                # The profiler's own exit is a cudaDeviceSynchronize: streams only.
                "syncs": sum(n_ == "cudaStreamSynchronize" for n_ in names),
                "copies": {kind: sum(kind in n_ for n_ in names) for kind in ("DtoH", "HtoD", "DtoD")}}

    per_k = {}
    for k_, (_, est_k, loops_k) in graphs.items():
        per_k[k_] = row_ = profile_call(pg.from_trajectory(est_k, loop_edges=loops_k, device=dev))
        row_["kernels_per_cg_step"] = row_["device_kernels"] / (10 * 60)
        check(row_["syncs"] == 0 and row_["copies"]["DtoH"] == 0,
              f"pose_graph K={k_}: {row_} -- a host sync or device-to-host copy before the read")
    emit("pose_graph", nodes=est.shape[0], edges=int(graph.edges_i.shape[0]), gn_iters=6, cost_pcg60=c_pcg,
         cost_plain1500=c_ref, cost_plain60=c_plain60, cost_cpu_pcg60=c_cpu, card_vs_cpu_gn1=gap1,
         card_vs_cpu_gn6=gap6, cpu_one_ulp_move_gn6=ulp6, max_position_error_before=pos_err(est),
         max_position_error_after=err_after, per_call=per_k, card=card)

    # ---- 12. SLAM at 640x480 (main path) -------------------------------------
    # The 120-frame out-and-back of tools/tpu/synth640.py (numpy seed 7), u16
    # at 1/5000 m, SlamConfig defaults but the intrinsics and depth scale.
    intr = ctx.slam_intr
    rng = np.random.RandomState(7)
    fwd = np.zeros((60, 6), np.float32)
    fwd[:, 2] = 0.025
    fwd[:, 0:2] = 0.004 * rng.randn(60, 2)
    fwd[:, 3:6] = 0.006 * rng.randn(60, 3)
    twists = np.concatenate([fwd, -fwd[::-1][:59]], 0)
    poses_gt = synthetic.poses_from_twists(torch.from_numpy(twists).to(dev))
    scene = synthetic.default_scene(seed=0, device=dev)
    frames = [np.clip(np.round(synthetic.render_depth(intr, T, scene).cpu().numpy() * 5000.0), 0, 65535)
              .astype(np.uint16) for T in poses_gt]
    gt_np = poses_gt.cpu().numpy()
    n_frames = len(frames)
    slam_cfg = SlamConfig(intrinsics=intr, depth_scale=1.0 / 5000.0, device=str(dev))
    kf_rounds = sum(projective.fit_levels(slam_cfg.icp, intr.height, intr.width).iters)
    kf_levels = len(projective.fit_levels(slam_cfg.icp, intr.height, intr.width).iters)
    warm = SlamTracker(slam_cfg)  # library initialisation, outside every count and time
    for i, f in enumerate(frames[:14]):
        warm.process(f, float(i))
    warm.flush_pending()

    tracker = SlamTracker(slam_cfg)
    torch.cuda.synchronize()
    ctx.reset_counts()
    ms, events = [], []
    for i, f in enumerate(frames):
        t0 = time.perf_counter()
        res = tracker.process(f, float(i))
        ms.append((time.perf_counter() - t0) * 1e3)
        if res.is_new_keyframe:
            events.append(i)
    t0 = time.perf_counter()
    tracker.flush_pending()
    flush_ms = (time.perf_counter() - t0) * 1e3
    stream_launches = ctx.read_counts()
    ctx.check_counts(stream_launches, "slam", kf_levels * n_frames, kf_rounds * (n_frames - 1), n_frames)
    kfs = tracker._keyframes
    kf_frames = [k.frame_index for k in kfs]
    before = np.stack([k.pose for k in kfs])
    n_loops = tracker.num_loop_closures
    check(n_loops >= 1, "slam: no loop closure")
    loop_gaps = []
    for i_, j_, T_, _w in tracker._loop_edges:
        T_true = np.linalg.inv(gt_np[kf_frames[i_]]) @ gt_np[kf_frames[j_]]
        loop_gaps.append(float(np.linalg.norm(_se3_log_np(np.linalg.inv(T_) @ T_true))))
    check(max(loop_gaps, default=0.0) < 0.05, f"slam: a loop edge {max(loop_gaps, default=0.0)} from the truth")
    ctx.reset_counts()
    t0 = time.perf_counter()
    opt = tracker.optimize()
    opt_ms = (time.perf_counter() - t0) * 1e3
    opt_launches = dict(backbone.LAUNCHES)
    ctx.check_counts(ctx.read_counts(), "slam optimize", 0, 0, 0, backbones=10 * (1 + 61))
    check(np.isfinite(opt).all(), "slam: optimized poses not finite")

    def kf_ate(P):
        est_t, gt_t = trajectory.Trajectory(), trajectory.Trajectory()
        for fi, T in zip(kf_frames, P):
            est_t.append(float(fi), T)
            gt_t.append(float(fi), gt_np[fi])
        return trajectory.absolute_trajectory_error(est_t, gt_t)["rmse"]

    ate_before, ate_after = kf_ate(before), kf_ate(opt)
    check(ate_after <= ate_before + 1e-4, f"slam: keyframe ATE {ate_after} after optimize, {ate_before} before")
    traj_ate = ctx.ate_of(tracker.trajectory, poses_gt)["rmse"]

    # Deferred booking against synchronous booking, on the card.
    runs = {}
    for defer in (True, False):
        t_ = SlamTracker(dataclasses.replace(slam_cfg, defer_keyframe_booking=defer))
        for i, f in enumerate(frames[:40]):
            t_.process(f, float(i))
        t_.flush_pending()
        runs[defer] = t_
    a_, b_ = runs[True], runs[False]
    check([k.frame_index for k in a_._keyframes] == [k.frame_index for k in b_._keyframes],
          "slam: deferred and synchronous keyframes differ")
    check([e[:2] for e in a_._loop_edges] == [e[:2] for e in b_._loop_edges], "slam: loop edges differ by booking")
    defer_gap = float(np.abs(np.stack(a_.trajectory.poses) - np.stack(b_.trajectory.poses)).max())
    for ea, eb in zip(a_._loop_edges, b_._loop_edges):
        defer_gap = max(defer_gap, float(np.abs(ea[2] - eb[2]).max()))
    check(defer_gap <= 1e-6, f"slam: deferred and synchronous booking part by {defer_gap}")

    # The card against the same code on the CPU, first 20 frames.
    cpu_t = SlamTracker(dataclasses.replace(slam_cfg, device="cpu"))
    gpu_t = SlamTracker(slam_cfg)
    for i, f in enumerate(frames[:20]):
        cpu_t.process(f, float(i))
        gpu_t.process(f, float(i))
    cpu_t.flush_pending()
    gpu_t.flush_pending()
    check([k.frame_index for k in cpu_t._keyframes] == [k.frame_index for k in gpu_t._keyframes],
          "slam: card and CPU keyframes differ")
    cpu_gap = float(np.abs(np.stack(cpu_t.trajectory.poses) - np.stack(gpu_t.trajectory.poses)).max())
    check(cpu_gap <= TWIST_BAR_CPU, f"slam: card vs CPU poses {cpu_gap} > {TWIST_BAR_CPU}")

    # Host copies and device kernels per frame, by the frame's place in the
    # booking pipeline: a fresh tracker, frames 72-95 (the way back, where
    # place recognition finds candidates to verify) each profiled on its own.
    prof_t = SlamTracker(slam_cfg)
    per_class = {}
    for i, f in enumerate(frames[:96]):
        if i < 72:
            prof_t.process(f, float(i))
            continue
        pending = prof_t._pending_kf["stage"] if prof_t._pending_kf is not None else 0
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            res = prof_t.process(f, float(i))
        names = [e.name for e in prof.events()]
        row = {"syncs": sum(n_ == "cudaStreamSynchronize" for n_ in names),
               "copies": sum(n_.startswith("cudaMemcpy") for n_ in names),
               "kernels": sum(n_.startswith("cudaLaunchKernel") for n_ in names)}
        cls = "event" if res.is_new_keyframe else ("plain" if pending == 0 else f"stage_{pending}")
        per_class.setdefault(cls, []).append(row)
    per_class = {c: {k_: statistics.median(r[k_] for r in rows) for k_ in ("syncs", "copies", "kernels")}
                 | {"frames": len(rows)} for c, rows in per_class.items()}

    steady = ms[10:]
    event_ms = [ms[i] for i in events if i >= 10]
    stage_ms = {f"event+{k_}": [ms[i + k_] for i in events if i >= 10 and i + k_ < n_frames] for k_ in (1, 2, 3, 4)}
    emit("slam", frames=n_frames, keyframes=len(kfs), keyframe_frames=kf_frames, loops=n_loops,
         loop_edges=[list(e[:2]) for e in tracker._loop_edges], loop_twist_gaps=loop_gaps,
         keyframe_ate_before=ate_before, keyframe_ate_after=ate_after, trajectory_ate=traj_ate,
         host_ms_per_frame_median=statistics.median(steady), host_ms_per_frame_p90=float(np.percentile(steady, 90)),
         host_ms_per_frame_max=max(steady), host_ms_event_frames=event_ms,
         host_ms_after_event={k_: (statistics.median(v) if v else None) for k_, v in stage_ms.items()},
         flush_ms=flush_ms, optimize_ms=opt_ms, launches=stream_launches,
         launches_per_frame={"gn_round": kf_rounds, "build_level_packed": kf_levels, "downsample_levels": 1},
         optimize_launches=opt_launches,
         per_frame_by_pipeline_place=per_class, deferred_vs_sync_gap_40=defer_gap, card_vs_cpu_gap_20=cpu_gap,
         card=card)
    return {"max_abs_err": bb_err, "ms": big["ms"], "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"], "previous_ms": big["previous_ms"]}


def dense_phases(ctx) -> dict:
    """Phases 13-17: the TSDF integrate and raycast kernels against their
    plain versions (and timed at 128^3 and 512^3), Tracker(method="tsdf")
    at 640x480 (the dense main path), its photometric variant, mesh and
    surface extraction, and the submap atlas. ctx carries main()'s helpers
    (dev, card, reset_counts, read_counts, check_counts, bound, turns,
    time_ms, ate_of, twist_gap, trace_calls, intr: the camera). Returns the
    two kernel rows' numbers for the kernels line, and under "atlas" phase
    17's loop atlas before its optimize_atlas with the edges and poses that
    optimize gave."""
    import copy

    import numpy as np
    import torch

    from realsensetracker_tpu_torch.align import projective
    from realsensetracker_tpu_torch.align.rgbd import RgbdIcpConfig
    from realsensetracker_tpu_torch.api import Tracker, TrackerConfig
    from realsensetracker_tpu_torch.data import synthetic
    from realsensetracker_tpu_torch.geometry import se3
    from realsensetracker_tpu_torch.kernels import tsdf as tsdf_kernels
    from realsensetracker_tpu_torch.mapping import mesh as mesh_mod
    from realsensetracker_tpu_torch.mapping import submaps as submaps_mod
    from realsensetracker_tpu_torch.mapping import tsdf as tsdf_mod

    dev, card, intr = ctx.dev, ctx.card, ctx.intr
    cfg = tsdf_mod.TsdfConfig()  # 128^3 x 4 cm
    h, w = intr.height, intr.width

    def profile_frame(run):
        """(device kernels launched, device busy share of the host time, host
        ms) of one call of run(), profiler on."""
        run()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.events()
        api = sum(e.name.startswith("cudaLaunchKernel") for e in events)
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        busy, end = 0.0, float("-inf")
        for a, b in sorted((e.time_range.start, e.time_range.end) for e in device):
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        return api, busy / wall_us, wall_us / 1e3

    # A corridor: spheres along +x in front of a wall at 2.2 m and a floor
    # 0.9 m below the camera (tests/test_submaps.py:36-47, 24 spheres over
    # 4.5 m). Phase 17 walks it; phase 13's slab case fuses its first
    # frames, whose update support fits a 96^3 window (the default scene's
    # wall at 4 m does not).
    span, out_n = 3.0, 50
    rng = np.random.RandomState(3)
    cx = np.linspace(-0.5, span + 1.0, 24)
    centers = np.stack([cx, rng.uniform(-0.3, 0.55, 24), rng.uniform(0.9, 1.6, 24)], 1).astype(np.float32)
    radii = rng.uniform(0.16, 0.32, 24).astype(np.float32)
    corridor = synthetic.Scene(torch.from_numpy(centers).to(dev), torch.from_numpy(radii).to(dev),
                               floor_y=0.9, wall_z=2.2)
    out_poses = np.tile(np.eye(4, dtype=np.float32), (out_n, 1, 1))
    out_poses[:, 0, 3] = np.linspace(0.0, span, out_n)
    atlas_poses = torch.from_numpy(np.concatenate([out_poses, out_poses[::-1][1:]])).to(dev)
    atlas_depths = torch.stack([synthetic.render_depth(intr, P_, corridor) for P_ in atlas_poses])

    # ---- 13. tsdf_kernels: integrate and raycast vs plain versions ----------
    depths, colors, poses = synthetic.render_trajectory_rgbd(intr, 10, seed=0, device=dev)
    colors = colors.contiguous()
    worst = {"integrate": 0.0, "raycast": 0.0}

    def fuse_checked(vk, vp, depth, color, pose_wc, cfg_, start=None, fits=None, x0=0, gate=None):
        """One frame through the kernel into vk and through the plain
        version into vp; the cull launched alone on the same frame
        (depth_tiles, cull_bricks) lists the plain twin's bricks, and those
        hold every brick the update predicate touches (on a copy of vp whose
        weights are zero). Returns (the kept share, the updated voxels)."""
        nx = vk.tsdf.shape[0]
        pcw = se3.inverse(pose_wc).contiguous()
        zero = tsdf_mod.TsdfVolume(*(None if a is None else (torch.zeros_like(a) if i % 2 else a.clone())
                                     for i, a in enumerate(vp)))
        tsdf_kernels.fuse_block(vk, depth, color, pcw, intr, cfg_, gate=gate, start=start, fits=fits, x0=x0)
        tsdf_kernels.fuse_block_reference(vp, depth, color, pcw, intr, cfg_, gate, start, fits, x0)
        tsdf_kernels.fuse_block_reference(zero, depth, color, pcw, intr, cfg_, gate, start, fits, x0)
        one = lambda t: None if t is None else t[None]  # noqa: E731
        count = torch.empty((1,), dtype=torch.int32, device=dev)
        tiles = tsdf_kernels.depth_tiles(depth[None], cfg_, count)
        kept = tsdf_kernels.cull_bricks(pcw[None], tiles, count, intr, cfg_, h, w, x0, nx, one(gate), one(start),
                                        one(fits))[: int(count.item())]
        twin = tsdf_kernels.brick_mask_reference(
            pcw[None], intr, cfg_, tsdf_kernels.depth_tiles_reference(depth[None], cfg_), h, w, x0, nx, one(gate),
            one(start), one(fits))[0]
        check(torch.equal(torch.sort(kept).values, torch.nonzero(twin.reshape(-1))[:, 0]),
              f"tsdf_kernels: the kernel's kept bricks differ from the twin's at {cfg_}")
        missed = int((tsdf_kernels.bricks_holding(zero.weight > 0) & ~twin).sum())
        check(missed == 0, f"tsdf_kernels: {missed} bricks with an updated voxel culled at {cfg_}")
        return kept.numel() / twin.numel(), int((zero.weight > 0).sum())

    def bits_of(vk, vp, what):
        torch.cuda.synchronize()
        gap = max((a - b).abs().max().item() for a, b in zip(vk, vp) if a is not None)
        check(all(torch.equal(a, b) for a, b in zip(vk, vp) if a is not None),
              f"tsdf_kernels: {what} not bit-identical to its plain version (gap {gap})")
        worst["integrate"] = max(worst["integrate"], gap)
        return gap

    def fuse_both(cfg_, color, depths_=depths, poses_=poses):
        vk = tsdf_mod.init_volume(cfg_, with_color=color, device=dev)
        vp = tsdf_mod.clone_volume(vk)
        fits_n, kept = 0, []
        for i in range(depths_.shape[0]):
            c = colors[i] if color else None
            start = fits = None
            if 0 < cfg_.integrate_slab < cfg_.resolution:
                start, fits = tsdf_mod.slab_window(depths_[i], poses_[i], intr, cfg_)
                fits_n += int(fits)
            kept.append(fuse_checked(vk, vp, depths_[i], c, poses_[i], cfg_, start, fits)[0])
        gap = bits_of(vk, vp, f"the integrate (slab {cfg_.integrate_slab}, color {color})")
        return vk, {"volume": cfg_.resolution, "slab": cfg_.integrate_slab, "color": color, "max_abs_err": gap,
                    "bit_identical": True, "observed_voxels": int((vk.weight > 0).sum()), "slab_fits": fits_n,
                    "visited_share": kept}

    vol, full_case = fuse_both(cfg, False)
    _, slab_case = fuse_both(cfg._replace(integrate_slab=96), False, atlas_depths[:10], atlas_poses[:10])

    # One rank's x-slab of a sharded volume (mapping/sharded.py): planes
    # 64..95 alone, from x0 = 64, by the kernel and by its plain version;
    # the kernel's slab equals the whole-volume kernel's planes bit for bit.
    x0, nx = 64, 32
    sk = tsdf_mod.TsdfVolume(torch.ones((nx, 128, 128), device=dev), torch.zeros((nx, 128, 128), device=dev))
    sp = tsdf_mod.clone_volume(sk)
    for i in range(depths.shape[0]):
        fuse_checked(sk, sp, depths[i], None, poses[i], cfg, x0=x0)
    x_gap = bits_of(sk, sp, "the x-slab from x0 = 64")
    check(torch.equal(sk.tsdf, vol.tsdf[x0 : x0 + nx]) and torch.equal(sk.weight, vol.weight[x0 : x0 + nx]),
          "tsdf_kernels: the x-slab differs from the whole volume's planes")
    # A slab of 37 planes from x0 = 61, off the bricks' boundaries.
    sk = tsdf_mod.TsdfVolume(torch.ones((37, 128, 128), device=dev), torch.zeros((37, 128, 128), device=dev))
    sp = tsdf_mod.clone_volume(sk)
    for i in range(depths.shape[0]):
        fuse_checked(sk, sp, depths[i], None, poses[i], cfg, x0=61)
    bits_of(sk, sp, "the x-slab from x0 = 61")
    x_slab_case = {"volume": cfg.resolution, "x0": [x0, 61], "planes": [nx, 37], "max_abs_err": x_gap,
                   "bit_identical": True, "equals_whole_volume_planes": True,
                   "observed_voxels": int((sk.weight > 0).sum())}

    # Adversarial poses (adversarial_poses: brick corners and faces along the
    # axes, grazing, outside looking in, tilted) at V = 40, 48, 96, 128 of
    # the 4.8 m cube, the scene rendered with 5% NaN holes; a frame without
    # valid depth and a closed gate leave the volume bit-identical.
    adversarial = []
    g = torch.Generator(device=dev).manual_seed(14)
    scene = synthetic.default_scene(seed=0, device=dev)
    for v_ in (40, 48, 96, 128):
        cfg_v = tsdf_mod.sized_config(resolution=v_, voxel_size=4.8 / v_)
        adv = torch.from_numpy(adversarial_poses(cfg_v, 32, seed=v_)).to(dev)
        vk = tsdf_mod.init_volume(cfg_v, device=dev)
        vp = tsdf_mod.clone_volume(vk)
        kept = []
        for P_ in adv:
            d = synthetic.render_depth(intr, P_, scene)
            d = torch.where(torch.rand(d.shape, generator=g, device=dev) < 0.05, float("nan"), d).contiguous()
            kept.append(fuse_checked(vk, vp, d, None, P_, cfg_v)[0])
        adversarial.append({"volume": v_, "poses": len(adv), "visited_share_mean": statistics.mean(kept),
                            "max_abs_err": bits_of(vk, vp, f"the integrate at {v_}^3 over adversarial poses"),
                            "bit_identical": True, "observed_voxels": int((vk.weight > 0).sum())})
    held = {}
    for name, d, gate in (("no valid depth", torch.full((h, w), float("nan"), device=dev), None),
                          ("zeros and beyond max_depth", torch.where(depths[0] > 2.0, 20.0, 0.0).contiguous(), None),
                          ("closed gate", depths[0], torch.zeros((), dtype=torch.bool, device=dev))):
        vk, vp = tsdf_mod.clone_volume(vol), tsdf_mod.clone_volume(vol)
        kept, _ = fuse_checked(vk, vp, d, None, poses[0], cfg, gate=gate)
        bits_of(vk, vp, name)
        check(kept == 0.0 and torch.equal(vk.tsdf, vol.tsdf) and torch.equal(vk.weight, vol.weight),
              f"tsdf_kernels: {name} changed the volume or kept bricks")
        held[name] = {"visited_share": kept, "volume_unchanged": True}

    # The slot entry: S = 4 slots with gates (1, 0, 1, 1), three steps, one
    # launch each, against a launch per slot.
    n_s = 4
    slots = tsdf_mod.TsdfVolume(torch.ones((n_s, 128, 128, 128), device=dev),
                                torch.zeros((n_s, 128, 128, 128), device=dev))
    single = tsdf_mod.clone_volume(slots)
    slot_gates = torch.tensor([True, False, True, True], device=dev)
    for f in range(3):
        ds = depths[f : f + n_s].contiguous()
        ps = torch.stack([se3.inverse(P_) for P_ in poses[f : f + n_s]]).contiguous()
        before = dict(tsdf_kernels.LAUNCHES)
        tsdf_kernels.fuse_blocks(slots, ds, None, ps, intr, cfg, gates=slot_gates)
        check(tsdf_kernels.LAUNCHES["tsdf_integrate"] == before["tsdf_integrate"] + 1, "tsdf_kernels: slot launches")
        for i in range(n_s):
            tsdf_kernels.fuse_block(tsdf_mod.TsdfVolume(single.tsdf[i], single.weight[i]), ds[i], None, ps[i], intr,
                                    cfg, gate=slot_gates[i])
    torch.cuda.synchronize()
    check(torch.equal(slots.tsdf, single.tsdf) and torch.equal(slots.weight, single.weight),
          "tsdf_kernels: the slot entry differs from a launch per slot")
    check(torch.equal(slots.weight[1], torch.zeros_like(slots.weight[1])), "tsdf_kernels: a closed slot changed")
    slot_case = {"slots": n_s, "gates": [1, 0, 1, 1], "steps": 3, "bit_identical_to_single_launches": True}
    check(slab_case["slab_fits"] > 0, "tsdf_kernels: the slab window never engaged")
    _, color_case = fuse_both(cfg, True)

    field = tsdf_mod.march_field(vol)
    T = poses[-1]

    def c2f_reference(coarse):
        ci = tsdf_mod.coarse_intrinsics(intr, coarse)
        dc = tsdf_kernels.march_reference(field, T, ci, cfg, cfg.num_steps)
        z0, seeded = tsdf_mod.coarse_seeds(dc, coarse, cfg)
        return tsdf_kernels.march_reference(field, T, intr, cfg, cfg.refine_steps, z_start=z0, gate=seeded,
                                            subvoxel_iters=cfg.subvoxel_iters)

    ray_cases = []
    for name, got, ref in (
        ("raycast", tsdf_mod.raycast(vol, T, intr, cfg),
         tsdf_kernels.march_reference(field, T, intr, cfg, cfg.num_steps, subvoxel_iters=cfg.subvoxel_iters)),
        ("raycast_coarse_to_fine(coarse=4)", tsdf_mod.raycast_coarse_to_fine(vol, T, intr, cfg, 4, cfg.refine_steps),
         c2f_reference(4)),
    ):
        torch.cuda.synchronize()
        check(torch.equal(got > 0, ref > 0), f"tsdf_kernels: {name} hit masks differ")
        hit = got > 0
        gap = (got[hit] - ref[hit]).abs().max().item() if bool(hit.any()) else 0.0
        check(torch.equal(got, ref), f"tsdf_kernels: {name} not bit-identical to its plain version (gap {gap})")
        worst["raycast"] = max(worst["raycast"], gap)
        ray_cases.append({"case": name, "volume": 128, "hits": int(hit.sum()), "max_abs_err": gap,
                          "bit_identical": True})

    def integrate_stats(cfg_, vol_, depth, pose):
        """One frame fused into a copy of vol_ by the kernel and the plain
        version (bit-identical, the kept bricks as fuse_checked holds them)
        and the integrate's bound for it: bytes, the frame read once and
        tsdf and weight read and written at each voxel the update predicate
        takes (counted where a copy with zero weights changes weight, so a
        saturated volume counts in full); ~10 f32 operations each. Returns
        ((bound ms, what bounds it), the stats for the phase line)."""
        vk, vp = tsdf_mod.clone_volume(vol_), tsdf_mod.clone_volume(vol_)
        kept, upd = fuse_checked(vk, vp, depth, None, pose, cfg_)
        bits_of(vk, vp, f"the integrate at {cfg_.resolution}^3")
        del vk, vp
        return ctx.bound(depth.numel() * 4 + upd * 16, upd * 10), {
            "updated_voxels": upd, "updated_share": upd / cfg_.resolution ** 3, "visited_share": kept,
            "bit_identical": True}

    def raycast_bound(cfg_, out):
        """Gathers: per ray the start sample and one per march step up to its
        hit (all n_steps for a miss), 16 per refined hit; bytes: the distinct
        field words those can touch (at most V^3) and the depth written;
        operations: ~30 per gather."""
        step = cfg_.step_frac * cfg_.trunc
        hit = out > 0
        steps = torch.where(hit, torch.ceil((out - cfg_.min_depth) / step).clamp(1, cfg_.num_steps),
                            float(cfg_.num_steps))
        gathers = int(steps.sum().item()) + out.numel() + int(hit.sum()) * 16 * cfg_.subvoxel_iters
        return ctx.bound(min(gathers, cfg_.resolution ** 3) * 4 + out.numel() * 4, gathers * 30), gathers

    def march_cases(cfg_, vol_):
        """At this volume: the kernel bit-identical to its plain version,
        full (subvoxel_iters of the config) and coarse-to-fine (coarse 4)."""
        it = cfg_.subvoxel_iters
        field_ = tsdf_mod.march_field(vol_)  # the volume as the integrate timing left it
        full_args = (field_, T, intr, cfg_, cfg_.num_steps)
        got, ref = tsdf_kernels.march(*full_args, subvoxel_iters=it), tsdf_kernels.march_reference(
            *full_args, subvoxel_iters=it)
        ci = tsdf_mod.coarse_intrinsics(intr, 4)
        c2f = tsdf_mod.raycast_coarse_to_fine(vol_, T, intr, cfg_, 4, cfg_.refine_steps)
        dc = tsdf_kernels.march_reference(field_, T, ci, cfg_, cfg_.num_steps)
        z0, seeded = tsdf_mod.coarse_seeds(dc, 4, cfg_)
        c2f_ref = tsdf_kernels.march_reference(field_, T, intr, cfg_, cfg_.refine_steps, z_start=z0, gate=seeded,
                                               subvoxel_iters=it)
        torch.cuda.synchronize()
        check(torch.equal(got, ref) and torch.equal(c2f, c2f_ref),
              f"tsdf_kernels: the raycast at {cfg_.resolution}^3 is not bit-identical to its plain version")
        return {"raycast_bit_identical": {"full": True, "coarse_to_fine": True},
                "raycast_hits": int((got > 0).sum()), "raycast_c2f_hits": int((c2f > 0).sum())}

    pcw = se3.inverse(T)
    timing = {}
    ik, ip = ctx.turns(lambda: tsdf_kernels.fuse_block_reference(vol, depths[-1], None, pcw, intr, cfg),
                       lambda: tsdf_kernels.fuse_block(vol, depths[-1], None, pcw, intr, cfg), 3, 50)
    (ib, ib_by), istats = integrate_stats(cfg, vol, depths[-1], T)
    # The tile map and the cull against their plain versions (tiles equal,
    # the kept bricks as a set equal to the twin's), the plain versions
    # timed with events; the kernels alone in phase 27 (CUDA graphs).
    d_last = depths[-1][None]
    count = torch.empty((1,), dtype=torch.int32, device=dev)
    tiles_k, tiles_p = tsdf_kernels.depth_tiles(d_last, cfg, count), tsdf_kernels.depth_tiles_reference(d_last, cfg)
    kept_k = tsdf_kernels.cull_bricks(pcw[None], tiles_k, count, intr, cfg, h, w)[: int(count.item())]
    mask_p = tsdf_kernels.brick_mask_reference(pcw[None], intr, cfg, tiles_p, h, w).reshape(-1)
    check(torch.equal(tiles_k, tiles_p), "tsdf_kernels: the tile map differs from its plain version")
    check(torch.equal(torch.sort(kept_k).values, torch.nonzero(mask_p)[:, 0]),
          "tsdf_kernels: the cull's brick list differs from its plain twin")
    tp = ctx.time_ms(lambda: tsdf_kernels.depth_tiles_reference(d_last, cfg), 20)
    cp = ctx.time_ms(lambda: tsdf_kernels.brick_mask_reference(pcw[None], intr, cfg, tiles_p, h, w), 5)
    n_bricks = mask_p.numel()
    tiles_bound = ctx.bound(d_last.numel() * 4 + tiles_p.numel() * 4, d_last.numel() * 3)
    # The cull's bytes: the pose, the tile map, the kept bricks' list entries
    # and their count; its operations: ~40 f64 per corner, 8 corners a brick.
    c_bytes, c_ops = 64 + tiles_p.numel() * 4 + kept_k.numel() * 8 + 4, n_bricks * 8 * 40
    t_b, t_o = c_bytes / HBM_BYTES_PER_S * 1e3, c_ops / F64_FLOPS_PER_S * 1e3
    cull_row = {"max_abs_err": 0.0, "ms": None, "plain_ms": cp, "bound_ms": max(t_b, t_o),
                "bound_by": "bytes" if t_b >= t_o else "operations"}
    tiles_row = {"max_abs_err": 0.0, "ms": None, "plain_ms": tp, "bound_ms": tiles_bound[0],
                 "bound_by": tiles_bound[1]}
    # The raycast's row: the march of the volume's planes (the renders'
    # source), the march of the built field beside it.
    rk, rp = ctx.turns(
        lambda: tsdf_kernels.march_reference(field, T, intr, cfg, cfg.num_steps, subvoxel_iters=cfg.subvoxel_iters),
        lambda: tsdf_kernels.march(vol, T, intr, cfg, cfg.num_steps, subvoxel_iters=cfg.subvoxel_iters), 2, 20)
    rk_field = ctx.time_ms(lambda: tsdf_kernels.march(field, T, intr, cfg, cfg.num_steps,
                                                      subvoxel_iters=cfg.subvoxel_iters), 20)
    (rb, rb_by), gathers = raycast_bound(cfg, tsdf_mod.raycast(vol, T, intr, cfg))
    timing[128] = {"integrate_ms": ik, "integrate_plain_ms": ip, "integrate_bound_ms": ib,
                   "integrate_bound_by": ib_by, **istats,
                   "raycast_ms": rk, "raycast_field_ms": rk_field, "raycast_plain_ms": rp,
                   "raycast_bound_ms": rb, "raycast_bound_by": rb_by, "raycast_gathers": gathers,
                   **march_cases(cfg, vol)}

    # KinectFusion's 512^3 volume: 1 GiB of tsdf + weight (the 5.12 m cube at 1 cm).
    cfg512 = tsdf_mod.sized_config(resolution=512, voxel_size=0.01)
    vol512 = tsdf_mod.init_volume(cfg512, device=dev)
    for i in range(depths.shape[0]):
        tsdf_mod.integrate(vol512, depths[i], poses[i], intr, cfg512)
    field512 = tsdf_mod.march_field(vol512)
    ik5, ip5 = ctx.turns(lambda: tsdf_kernels.fuse_block_reference(vol512, depths[-1], None, pcw, intr, cfg512),
                         lambda: tsdf_kernels.fuse_block(vol512, depths[-1], None, pcw, intr, cfg512), 1, 10)
    (ib5, ib5_by), istats5 = integrate_stats(cfg512, vol512, depths[-1], T)
    rk5, rp5 = ctx.turns(
        lambda: tsdf_kernels.march_reference(field512, T, intr, cfg512, cfg512.num_steps, subvoxel_iters=1),
        lambda: tsdf_kernels.march(vol512, T, intr, cfg512, cfg512.num_steps, subvoxel_iters=1), 1, 10)
    rk5_field = ctx.time_ms(lambda: tsdf_kernels.march(field512, T, intr, cfg512, cfg512.num_steps,
                                                       subvoxel_iters=1), 10)
    out512 = tsdf_mod.raycast(vol512, T, intr, cfg512)
    (rb5, rb5_by), gathers5 = raycast_bound(cfg512, out512)
    timing[512] = {"integrate_ms": ik5, "integrate_plain_ms": ip5, "integrate_bound_ms": ib5,
                   "integrate_bound_by": ib5_by, **istats5, "raycast_ms": rk5, "raycast_field_ms": rk5_field,
                   "raycast_plain_ms": rp5, "raycast_bound_ms": rb5, "raycast_bound_by": rb5_by,
                   "raycast_gathers": gathers5, "hits": int((out512 > 0).sum()),
                   **march_cases(cfg512, vol512)}
    del vol512, field512
    emit("tsdf_kernels", frame=[h, w], integrate_cases=[full_case, slab_case, color_case, x_slab_case],
         adversarial=adversarial, held=held, slots=slot_case, raycast_cases=ray_cases,
         timing=timing, card=card)

    # ---- 14. tsdf: Tracker(method="tsdf") at 640x480 (main path) ------------
    # The 30-frame random walk of phase 7, u16 millimetres at depth_scale 1e-3.
    walk_d, walk_poses = synthetic.render_trajectory(intr, 30, seed=0, device=dev)
    frames = [np.clip(d * 1000.0, 0, 65000).astype(np.uint16) for d in walk_d.cpu().numpy()]
    frames_dev = [torch.from_numpy(f).to(dev) for f in frames]
    icp_cfg = projective.fit_levels(projective.ProjectiveIcpConfig(), h, w)
    levels, rounds = len(icp_cfg.iters), sum(icp_cfg.iters)

    def tsdf_tracker(**tsdf_kw):
        return Tracker(TrackerConfig(intrinsics=intr, method="tsdf", tsdf=cfg._replace(**tsdf_kw), device="cuda"))

    def run_modes(tsdf_kw, window=8):
        """Per frame and process_window(window) over the 30 frames, one window
        of frames each in turns: (per-frame results, windowed results,
        per-frame launches, host ms per frame of each mode)."""
        warm = tsdf_tracker(**tsdf_kw)  # library initialisation, outside every count and time
        warm.process_window(frames_dev[:3], window=window)
        per, win = tsdf_tracker(**tsdf_kw), tsdf_tracker(**tsdf_kw)
        pr, wr, pms, wms = [], [], [], []
        launches = {}
        for s in range(0, len(frames_dev), window):
            chunk = frames_dev[s:s + window]
            ts = [float(i) for i in range(s, s + len(chunk))]
            ctx.reset_counts()
            t0 = time.perf_counter()
            pr += [per.process(f, t) for f, t in zip(chunk, ts)]
            pms.append((time.perf_counter() - t0) * 1e3 / len(chunk))
            for k, v in ctx.read_counts().items():
                launches[k] = launches.get(k, 0) + v
            ctx.reset_counts()
            t0 = time.perf_counter()
            wr += win.process_window(chunk, ts, window=window)
            wms.append((time.perf_counter() - t0) * 1e3 / len(chunk))
            ctx.read_counts()
        return per, win, pr, wr, launches, pms, wms

    per, win, pr, wr, launches, pms, wms = run_modes({})
    n = len(frames_dev)
    tracked = n - 1
    ctx.check_counts(launches, "tsdf per frame", levels * tracked, rounds * tracked, 2 * tracked,
                     integrates=n, raycasts=tracked)
    check(all(r.success for r in pr) and all(r.success for r in wr), "tsdf: a frame failed")
    pose_gap = max(float(np.abs(a.pose - b.pose).max()) for a, b in zip(pr, wr))
    check(pose_gap <= 1e-6, f"tsdf: process_window parts from per-frame process by {pose_gap}")
    tsdf_ate = ctx.ate_of(per.trajectory, walk_poses)
    check(tsdf_ate["rmse"] < ATE_BAR, f"tsdf: ATE rmse {tsdf_ate['rmse']} >= {ATE_BAR}")
    frame_copies, frame_dev_ms = ctx.trace_calls(lambda i: per.process(frames_dev[i]), 2)
    frame_syncs = frame_copies.get("cudaStreamSynchronize", 0)
    frame_dtoh = sum(v for k, v in frame_copies.items() if "DtoH" in k)
    check(frame_syncs == 1 and frame_dtoh <= 1, f"tsdf: {frame_syncs} host copies per frame ({frame_copies})")
    win_copies, _ = ctx.trace_calls(lambda i: win.process_window(frames_dev[:8], window=8), 1)
    win_syncs = win_copies.get("cudaStreamSynchronize", 0)
    win_dtoh = sum(v for k, v in win_copies.items() if "DtoH" in k)
    check(win_syncs == 1 and win_dtoh <= 1, f"tsdf: {win_syncs} host copies per window ({win_copies})")
    kernels_pf, busy_pf, host_pf = profile_frame(lambda: per.process(frames_dev[5]))
    cpu = Tracker(TrackerConfig(intrinsics=intr, method="tsdf", tsdf=cfg, device="cpu"))
    cpu_poses = [cpu.process(f).pose for f in frames[:3]]
    vs_cpu = ctx.twist_gap(cpu_poses, [r.pose for r in pr[:3]])
    check(vs_cpu <= TWIST_BAR_CPU, f"tsdf: CUDA vs CPU twist {vs_cpu} > {TWIST_BAR_CPU}")
    # The reduced render: tracking at 320x240 with the coarse-to-fine raycast.
    per2, _, pr2, wr2, launches2, pms2, wms2 = run_modes({"track_scale": 2, "raycast_coarse": 4})
    ctx.check_counts(launches2, "tsdf track_scale=2", levels * tracked, rounds * tracked, 3 * tracked,
                     integrates=n, raycasts=2 * tracked)
    check(all(r.success for r in pr2), "tsdf track_scale=2: a frame failed")
    ts2_ate = ctx.ate_of(per2.trajectory, walk_poses)
    copies2, _ = ctx.trace_calls(lambda i: per2.process(frames_dev[i]), 2)
    syncs2 = copies2.get("cudaStreamSynchronize", 0)
    check(syncs2 == 1, f"tsdf track_scale=2: {syncs2} host copies per frame ({copies2})")
    kernels2, busy2, host2 = profile_frame(lambda: per2.process(frames_dev[5]))
    emit("tsdf", frames=n, config={"volume": cfg.resolution, "voxel_size": cfg.voxel_size, "iters": list(icp_cfg.iters)},
         ate_rmse=tsdf_ate["rmse"], twist_vs_cpu_3=vs_cpu, window_pose_gap=pose_gap, launches=launches,
         host_copies_per_frame=frame_syncs, host_copies_per_window=win_syncs, copies_and_syncs_per_frame=frame_copies,
         ms_per_frame_median=statistics.median(pms[1:]), windowed_ms_per_frame_median=statistics.median(wms[1:]),
         device_ms_per_frame=frame_dev_ms, device_kernels_per_frame=kernels_pf, busy_share=busy_pf,
         profiled_host_ms=host_pf,
         track_scale2_coarse4={"ate_rmse": ts2_ate["rmse"], "launches": launches2,
                               "ms_per_frame_median": statistics.median(pms2[1:]),
                               "windowed_ms_per_frame_median": statistics.median(wms2[1:]),
                               "device_kernels_per_frame": kernels2, "busy_share": busy2, "profiled_host_ms": host2,
                               "host_copies_per_frame": syncs2},
         card=card)

    # ---- 15. tsdf_rgbd: photometric KinectFusion (main path) -----------------
    rgbd_cfg = projective.fit_levels(RgbdIcpConfig(), h, w)
    colors8 = [np.clip(c * 255, 0, 255).astype(np.uint8) for c in colors.cpu().numpy()]
    colors8_dev = [torch.from_numpy(c).to(dev) for c in colors8]
    photo_cfg = TrackerConfig(intrinsics=intr, method="tsdf", tsdf=cfg, tsdf_color=True, tsdf_photometric=True,
                              device="cuda")
    warm = Tracker(photo_cfg)
    for i in range(2):
        warm.process(depths[i], color=colors8_dev[i])
    photo = Tracker(photo_cfg)
    ctx.reset_counts()
    photo_res, photo_ms = [], []
    for i in range(depths.shape[0]):
        t0 = time.perf_counter()
        photo_res.append(photo.process(depths[i], float(i), color=colors8_dev[i]))
        photo_ms.append((time.perf_counter() - t0) * 1e3)
    photo_launches = ctx.read_counts()
    nf = depths.shape[0]
    ctx.check_counts(photo_launches, "tsdf_rgbd", len(rgbd_cfg.iters) * (nf - 1), 0, 2 * (nf - 1),
                     systems=(sum(rgbd_cfg.iters) + 1) * (nf - 1), integrates=nf, raycasts=nf - 1)
    check(all(r.success for r in photo_res), "tsdf_rgbd: a frame failed")
    photo_ate = ctx.ate_of(photo.trajectory, poses)
    photo_copies, _ = ctx.trace_calls(lambda i: photo.process(depths[8 + i], color=colors8_dev[8 + i]), 2)
    photo_syncs = photo_copies.get("cudaStreamSynchronize", 0)
    check(photo_syncs == 1, f"tsdf_rgbd: {photo_syncs} host copies per frame ({photo_copies})")
    emit("tsdf_rgbd", frames=nf, ate_rmse=photo_ate["rmse"], launches=photo_launches, host_copies_per_frame=photo_syncs,
         ms_per_frame_median=statistics.median(photo_ms[1:]), ms_per_frame_max=max(photo_ms[1:]), card=card)

    # ---- 16. mesh_surface: extraction on the tsdf phase's volume -------------
    dense = per._impl.tsdf_volume
    dense_cpu = tsdf_mod.TsdfVolume(*(None if a is None else a.cpu() for a in dense))
    t0 = time.perf_counter()
    mesh = mesh_mod.extract_mesh(dense, cfg, 131072)
    cloud, normals = tsdf_mod.extract_surface_oriented(dense, cfg)
    torch.cuda.synchronize()
    extract_ms = (time.perf_counter() - t0) * 1e3
    mesh_cpu = mesh_mod.extract_mesh(dense_cpu, cfg, 131072)
    cloud_cpu, normals_cpu = tsdf_mod.extract_surface_oriented(dense_cpu, cfg)
    tri, tri_cpu = int(mesh.mask.sum()), int(mesh_cpu.mask.sum())
    pts, pts_cpu = int(cloud.mask.sum()), int(cloud_cpu.mask.sum())
    check(tri == tri_cpu > 1000 and pts == pts_cpu > 1000, f"mesh_surface: counts {tri}/{tri_cpu}, {pts}/{pts_cpu}")
    check(torch.equal(mesh.mask.cpu(), mesh_cpu.mask), "mesh_surface: triangle masks differ from the CPU run")
    vgap = (mesh.vertices.cpu() - mesh_cpu.vertices).abs().max().item()
    pgap = (cloud.points.cpu() - cloud_cpu.points).abs().max().item()
    ngap = (normals.cpu() - normals_cpu).abs().max().item()
    check(vgap <= 1e-5 and pgap <= 1e-5, f"mesh_surface: vertex gap {vgap}, point gap {pgap} > 1e-5")
    emit("mesh_surface", triangles=tri, points=pts, vertex_gap_vs_cpu=vgap, point_gap_vs_cpu=pgap,
         normal_gap_vs_cpu=ngap, device_ms=extract_ms, card=card)

    # ---- 17. submaps: the atlas along a corridor that leaves a 96^3 volume ---
    sub_cfg = tsdf_mod.sized_config(resolution=96, voxel_size=0.04)
    atlas_cfg = TrackerConfig(intrinsics=intr, method="tsdf", tsdf=sub_cfg, tsdf_submap_radius=0.96, device="cuda")
    atlas = Tracker(atlas_cfg)
    ctx.reset_counts()
    atlas_ms = []
    atlas_res = []
    for i in range(atlas_depths.shape[0]):
        t0 = time.perf_counter()
        atlas_res.append(atlas.process(atlas_depths[i], float(i)))
        atlas_ms.append((time.perf_counter() - t0) * 1e3)
    atlas_launches = ctx.read_counts()
    impl = atlas._impl
    sids = [sid for _, sid in impl._span_log]
    spawns = impl.num_submaps - 1
    reentries = len(sids) - len(set(sids))
    check(all(r.success for r in atlas_res), "submaps: a frame failed")
    check(spawns >= 2 and reentries >= 1, f"submaps: {spawns} spawns, {reentries} re-entries")
    check(atlas_launches["tsdf_integrate"] > 0 and atlas_launches["tsdf_raycast"] > 0, "submaps: no dense launch")
    atlas_ate = ctx.ate_of(impl.trajectory, atlas_poses)
    # optimize_atlas on the same walk without re-entry: the return leg's
    # submaps overlap the outbound ones (tests/test_submaps.py:134).
    loop_atlas = submaps_mod.SubmapTsdfTracker(
        intr, submaps_mod.SubmapConfig(volume=sub_cfg, spawn_radius=0.96, reactivate=False), device=dev)
    for i in range(atlas_depths.shape[0]):
        loop_atlas.process(atlas_depths[i], float(i))
    pre = ctx.ate_of(loop_atlas.trajectory, atlas_poses)
    atlas_before = copy.deepcopy(loop_atlas)  # phase multidevice repeats the optimize on a mesh
    t0 = time.perf_counter()
    loops = submaps_mod.optimize_atlas(loop_atlas)
    opt_ms = (time.perf_counter() - t0) * 1e3
    post = ctx.ate_of(loop_atlas.trajectory, atlas_poses)
    check(loops >= 1, "submaps: optimize_atlas accepted no loop edge")
    emit("submaps", frames=len(atlas_res), volume=sub_cfg.resolution, spawn_radius=0.96, spawns=spawns,
         reentries=reentries, span_log=impl._span_log, ate_rmse=atlas_ate["rmse"], launches=atlas_launches,
         ms_per_frame_median=statistics.median(atlas_ms[1:]), ms_per_frame_max=max(atlas_ms[1:]),
         optimize_atlas={"loops": loops, "ms": opt_ms, "submaps": loop_atlas.num_submaps,
                         "ate_rmse_before": pre["rmse"], "ate_rmse_after": post["rmse"]},
         card=card)

    return {
        "tsdf_integrate": {"max_abs_err": worst["integrate"], "ms": ik, "plain_ms": ip, "bound_ms": ib,
                           "bound_by": ib_by},
        "tsdf_depth_tiles": tiles_row,
        "tsdf_cull": cull_row,
        "tsdf_raycast": {"max_abs_err": worst["raycast"], "ms": rk, "plain_ms": rp, "bound_ms": rb,
                         "bound_by": rb_by, "gathers": gathers},
        "atlas": {"before": atlas_before, "loops": loops, "poses": [np.array(T) for T in loop_atlas.trajectory.poses]},
    }


def serving_phases(ctx) -> None:
    """Phases 18-23: the serving paths at 640x480 (camera.TUM_FR1, default
    ProjectiveIcpConfig, u16 bodies at 1/5000 m) through a real
    TrackingService on 127.0.0.1: the batched executor at capacity 8
    (BASELINE config 5) against 8 serialized trackers, /track_window, RGB-D
    and dense slots, the plain service, and rs_serve as a subprocess. ctx
    carries main()'s helpers (dev, card, intr, reset_counts, read_counts,
    check_counts, ate_of, twist_gap)."""
    import threading

    import numpy as np
    import torch

    from realsensetracker_tpu_torch.align import projective
    from realsensetracker_tpu_torch.align.rgbd import RgbdIcpConfig
    from realsensetracker_tpu_torch.api import Tracker, TrackerConfig
    from realsensetracker_tpu_torch.api.batching import BatchedExecutor, BatchingConfig
    from realsensetracker_tpu_torch.api.service import TrackingService, get_json, post_frame, post_window
    from realsensetracker_tpu_torch.data import synthetic
    from realsensetracker_tpu_torch.mapping import tsdf as tsdf_mod
    from realsensetracker_tpu_torch.tracking.trajectory import Trajectory
    from realsensetracker_tpu_torch.tracking.tsdf_tracker import TsdfTracker

    dev, card, intr = ctx.dev, ctx.card, ctx.intr
    h, w = intr.height, intr.width
    scale = 1.0 / 5000.0
    timeout = 120.0  # every client call
    cfg = projective.fit_levels(projective.ProjectiveIcpConfig(), h, w)
    levels, rounds = len(cfg.iters), sum(cfg.iters)

    def u16(d):
        return np.clip(d.cpu().numpy() * 5000.0 + 0.5, 0, 65535).astype(np.uint16)

    def batching(**kw):
        kw.setdefault("capacity", 8)
        return BatchingConfig(intrinsics=intr, depth_scale=scale, request_timeout_s=300.0, **kw)

    def drive(url, frames, window=None):
        """Each session's producer thread posts its frames in order (one
        /track per frame, or /track_window batches of ``window``). Returns
        (records per session, request latencies ms, wall seconds)."""
        n = len(frames)
        recs, lat, errors = [[] for _ in range(n)], [[] for _ in range(n)], []

        def worker(i):
            try:
                fr = frames[i]
                step = window or 1
                for s in range(0, len(fr), step):
                    t0 = time.perf_counter()
                    if window:
                        out = post_window(url, fr[s:s + step], ts=np.arange(s, s + step, dtype=np.float64),
                                          session=f"s{i}", window=window, timeout=timeout)
                        recs[i] += out["frames"]
                    else:
                        recs[i].append(post_frame(url, fr[s], ts=float(s), session=f"s{i}", timeout=timeout))
                    lat[i].append((time.perf_counter() - t0) * 1e3)
            except Exception as e:  # reported below
                errors.append(f"session {i}: {e!r}")

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        check(not any(th.is_alive() for th in threads), "serve: a producer thread hung")
        check(not errors, f"serve: {errors}")
        return recs, [x for xs in lat for x in xs], wall

    def poses_of(records):
        return [np.asarray(r["pose"], np.float32) for r in records]

    def ate(records, truth):
        traj = Trajectory()
        for i, p in enumerate(poses_of(records)):
            traj.append(float(i), p)
        return ctx.ate_of(traj, truth)["rmse"]

    def traced(run):
        """(device kernels, device-to-host copies, host syncs, busy share of
        the host time) of run(), from a profiler trace; the dispatcher
        thread's device work is traced by CUPTI whatever thread issued it."""
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.events()
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels = [e for e in device if not e.name.startswith(("Memcpy", "Memset"))]
        dtoh = sum("DtoH" in e.name for e in device)
        syncs = sum(e.name == "cudaStreamSynchronize" for e in events)
        busy, end = 0.0, float("-inf")
        for a, b in sorted((e.time_range.start, e.time_range.end) for e in device):
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        return len(kernels), dtoh, syncs, busy / wall_us

    def pct(xs, q):
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    # ---- 18. serve_batched: 8 producers x 30 frames, capacity 8 (main path) --
    n_sessions, n_frames = 8, 30
    streams_d, truths = [], []
    for i in range(n_sessions):
        d, p = synthetic.render_trajectory(intr, n_frames, scene=synthetic.default_scene(seed=100 + i, device=dev),
                                           seed=i)
        streams_d.append(u16(d))
        truths.append(p)
    warm_ex = BatchedExecutor(batching())  # library initialisation, outside every count and time
    try:
        warm = warm_ex.make_session_tracker()
        for f in range(3):
            warm.process(streams_d[0][f])
    finally:
        warm_ex.close()

    def serve(make_service, frames, window=None):
        svc, ex = make_service()
        try:
            out = drive(f"http://127.0.0.1:{svc.port}", frames, window)
            return out + ((ex.stats() if ex else None),)
        finally:
            svc.close()
            if ex is not None:
                ex.close()

    def batched_service(**kw):
        ex = BatchedExecutor(batching(**kw))
        return TrackingService(ex.make_session_tracker, extra_status=ex.stats, depth_scale=scale), ex

    def plain_service():
        make = lambda: Tracker(TrackerConfig(intrinsics=intr, method="projective", depth_scale=scale,  # noqa: E731
                                             device="cuda"))
        return TrackingService(make, depth_scale=scale), None

    ctx.reset_counts()
    recs, lat, wall, st = serve(batched_service, streams_d)
    got = ctx.read_counts()
    d_n = st["dispatches"]
    # The slot state's blank pyramid (built at the first dispatch) is one
    # more pyramid than the dispatches.
    ctx.check_counts(got, "serve_batched", levels * (d_n + 1), rounds * d_n, d_n + 1)
    check(st["errors"] == 0 and st["frames"] == n_sessions * n_frames, f"serve_batched: executor stats {st}")
    check(all(r["success"] for rs in recs for r in rs), "serve_batched: a frame failed")
    ates = [ate(recs[i], truths[i]) for i in range(n_sessions)]
    check(max(ates) < ATE_BAR, f"serve_batched: ATE rmse {ates}")
    # Each session alone, through the same executor configuration: batching
    # must not change what a session computes.
    # solo_gap is the twist of a^-1 b, which reads ~3e-8 for equal f32
    # poses; solo_diff is the largest entry difference, exact up to the
    # service's 9-decimal JSON rounding of the batched poses.
    solo_gap, solo_diff = 0.0, 0.0
    solo_ex = BatchedExecutor(batching())
    try:
        for i in range(n_sessions):
            t_ = solo_ex.make_session_tracker()
            alone = [t_.process(streams_d[i][f], float(f)).pose for f in range(n_frames)]
            t_.release()
            solo_gap = max(solo_gap, ctx.twist_gap(alone, poses_of(recs[i])))
            solo_diff = max(solo_diff, float(np.abs(np.stack(alone) - np.stack(poses_of(recs[i]))).max()))
    finally:
        solo_ex.close()
    check(solo_gap <= 1e-6, f"serve_batched: a session served alone parts by {solo_gap} > 1e-6")
    # The first 3 rounds against the same executor on the CPU.
    cpu_ex = BatchedExecutor(batching(device="cpu", linger_ms=200.0))
    try:
        cpu_tr = [cpu_ex.make_session_tracker() for _ in range(n_sessions)]
        cpu_poses = [None] * n_sessions

        def cpu_worker(i):
            cpu_poses[i] = [cpu_tr[i].process(streams_d[i][f], float(f)).pose for f in range(3)]

        threads = [threading.Thread(target=cpu_worker, args=(i,)) for i in range(n_sessions)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        check(all(p is not None for p in cpu_poses), "serve_batched: the CPU executor did not finish")
    finally:
        cpu_ex.close()
    vs_cpu = max(ctx.twist_gap(cpu_poses[i], poses_of(recs[i])[:3]) for i in range(n_sessions))
    check(vs_cpu <= TWIST_BAR_CPU, f"serve_batched: card vs CPU twist {vs_cpu} > {TWIST_BAR_CPU}")
    # Device kernels, copies and busy share of two rounds of the 8 sessions.
    prof_ex = BatchedExecutor(batching(linger_ms=50.0))
    prof_svc = TrackingService(prof_ex.make_session_tracker, extra_status=prof_ex.stats, depth_scale=scale)
    try:
        prof_url = f"http://127.0.0.1:{prof_svc.port}"
        drive(prof_url, [s[:2] for s in streams_d])  # seeds every slot
        before = prof_ex.stats()["dispatches"]
        kern, dtoh, syncs, busy = traced(lambda: drive(prof_url, [s[2:4] for s in streams_d]))
        prof_d = prof_ex.stats()["dispatches"] - before
    finally:
        prof_svc.close()
        prof_ex.close()
    check(dtoh == prof_d, f"serve_batched: {dtoh} device-to-host copies in {prof_d} dispatches")
    # The same frames through 8 serialized Tracker(method="projective")
    # sessions behind the plain service, in turns with the batched run.
    turns_ = []
    for make in (plain_service, batched_service, batched_service, plain_service):
        _, lat_, wall_, _ = serve(make, streams_d)
        turns_.append({"mode": "batched" if make is batched_service else "plain",
                       "frames_per_s": n_sessions * n_frames / wall_, "p50_ms": pct(lat_, 0.5),
                       "p90_ms": pct(lat_, 0.9)})
    emit("serve_batched", sessions=n_sessions, frames=n_frames, capacity=8, frames_per_s=n_sessions * n_frames / wall,
         latency_ms={"p50": pct(lat, 0.5), "p90": pct(lat, 0.9), "max": max(lat)}, dispatches=d_n,
         mean_slots_per_dispatch=st["mean_batch"], max_slots_per_dispatch=st["max_batch"], launches=got,
         gn_round_per_dispatch=got["gn_round"] / d_n, ate_rmse=ates, solo_twist_gap=solo_gap, solo_pose_max_abs_diff=solo_diff,
         twist_vs_cpu_3=vs_cpu,
         profiled={"dispatches": prof_d, "device_kernels_per_dispatch": kern / max(prof_d, 1),
                   "dtoh_per_dispatch": dtoh / max(prof_d, 1), "syncs": syncs, "busy_share": busy},
         turns=turns_, card=card)

    # ---- 19. serve_window: 4 sessions, /track_window with window=8 ---------
    win_frames = [s[:16] for s in streams_d[:4]]
    ctx.reset_counts()
    wrecs, wlat, wwall, wst = serve(lambda: batched_service(capacity=8, window=8), win_frames, window=8)
    wgot = ctx.read_counts()
    wd = wst["dispatches"]
    ctx.check_counts(wgot, "serve_window", levels * (8 * wd + 1), rounds * 8 * wd, 8 * wd + 1)
    check(wst["errors"] == 0, f"serve_window: executor stats {wst}")
    win_gap = max(float(np.abs(np.stack(poses_of(wrecs[i])) - np.stack(poses_of(recs[i][:16]))).max())
                  for i in range(4))
    check(win_gap <= 1e-6, f"serve_window: /track_window parts from /track by {win_gap}")
    wex = BatchedExecutor(batching(window=8, linger_ms=50.0))
    wsvc = TrackingService(wex.make_session_tracker, extra_status=wex.stats, depth_scale=scale)
    try:
        wurl = f"http://127.0.0.1:{wsvc.port}"
        drive(wurl, [s[:8] for s in win_frames], window=8)
        before = wex.stats()["dispatches"]
        wkern, wdtoh, _, wbusy = traced(lambda: drive(wurl, [s[8:16] for s in win_frames], window=8))
        wprof_d = wex.stats()["dispatches"] - before
    finally:
        wsvc.close()
        wex.close()
    check(wdtoh == wprof_d, f"serve_window: {wdtoh} device-to-host copies in {wprof_d} dispatches")
    emit("serve_window", sessions=4, frames=16, window=8, dispatches=wd, mean_slots_per_dispatch=wst["mean_batch"],
         frames_per_s=4 * 16 / wwall, latency_ms={"p50": pct(wlat, 0.5), "p90": pct(wlat, 0.9)}, launches=wgot,
         pose_gap_vs_track=win_gap, profiled={"dispatches": wprof_d, "dtoh_per_dispatch": wdtoh / max(wprof_d, 1),
                                              "device_kernels_per_dispatch": wkern / max(wprof_d, 1),
                                              "busy_share": wbusy}, card=card)

    # ---- 20. serve_rgbd: 4 sessions x 10 RGB-D frames, u8 color ------------
    rgbd_cfg = projective.fit_levels(RgbdIcpConfig(), h, w)
    r_levels, r_steps = len(rgbd_cfg.iters), sum(rgbd_cfg.iters) + 1
    n_rgbd = 10
    rgbd_frames, rgbd_truth = [], []
    for i in range(4):
        scene_i = synthetic.default_scene(seed=200 + i, device=dev)
        d, c, p = synthetic.render_trajectory_rgbd(intr, n_rgbd, scene=scene_i, seed=i)
        rgbd_frames.append((u16(d), np.clip(c.cpu().numpy() * 255, 0, 255).astype(np.uint8)))
        rgbd_truth.append(p)

    def drive_rgbd(url, n):
        out, errors = [[] for _ in range(4)], []

        def worker(i):
            try:
                dd, cc = rgbd_frames[i]
                out[i] = [post_frame(url, dd[f], ts=float(f), color=cc[f], session=f"r{i}", timeout=timeout)
                          for f in range(n)]
            except Exception as e:  # reported below
                errors.append(f"session {i}: {e!r}")

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        check(not errors and not any(th.is_alive() for th in threads), f"serve_rgbd: {errors}")
        return out

    def rgbd_run(device, n):
        ex = BatchedExecutor(batching(capacity=4, rgbd=True, device=device, linger_ms=100.0))
        svc = TrackingService(ex.make_session_tracker, extra_status=ex.stats, depth_scale=scale)
        try:
            t0 = time.perf_counter()
            out = drive_rgbd(f"http://127.0.0.1:{svc.port}", n)
            return out, ex.stats(), time.perf_counter() - t0
        finally:
            svc.close()
            ex.close()

    ctx.reset_counts()
    rrecs, rst, rwall = rgbd_run("cuda", n_rgbd)
    rgot = ctx.read_counts()
    rd = rst["dispatches"]
    ctx.check_counts(rgot, "serve_rgbd", r_levels * (rd + 1), 0, 2 * rd + 1, systems=r_steps * rd)
    check(rst["errors"] == 0 and all(r["success"] for rs in rrecs for r in rs), f"serve_rgbd: {rst}")
    rates = [ate(rrecs[i], rgbd_truth[i]) for i in range(4)]
    rcpu, _, _ = rgbd_run("cpu", 3)
    rvs_cpu = max(ctx.twist_gap(poses_of(rcpu[i]), poses_of(rrecs[i])[:3]) for i in range(4))
    check(rvs_cpu <= TWIST_BAR_CPU, f"serve_rgbd: card vs CPU twist {rvs_cpu} > {TWIST_BAR_CPU}")
    emit("serve_rgbd", sessions=4, frames=n_rgbd, capacity=4, dispatches=rd, mean_slots_per_dispatch=rst["mean_batch"],
         launches=rgot, gn_system_per_dispatch=rgot["gn_system"] / rd, ate_rmse=rates, twist_vs_cpu_3=rvs_cpu,
         frames_per_s=4 * n_rgbd / rwall, card=card)

    # ---- 21. serve_tsdf: 4 sessions x phase 7's 30 frames, 128^3 slots -----
    walk_d, walk_poses = synthetic.render_trajectory(intr, 30, seed=0, device=dev)
    walk = u16(walk_d)
    vol_cfg = tsdf_mod.TsdfConfig()
    ctx.reset_counts()
    trecs, tlat, twall, tst = serve(lambda: batched_service(capacity=4, tsdf=True, tsdf_cfg=vol_cfg),
                                    [walk] * 4)
    tgot = ctx.read_counts()
    td = tst["dispatches"]
    ctx.check_counts(tgot, "serve_tsdf", levels * td, rounds * td, 2 * td, integrates=td, raycasts=4 * td)
    check(tst["errors"] == 0 and all(r["success"] for rs in trecs for r in rs), f"serve_tsdf: {tst}")
    tates = [ate(trecs[i], walk_poses) for i in range(4)]
    check(max(tates) < ATE_BAR, f"serve_tsdf: ATE rmse {tates}")
    single = TsdfTracker(intr, volume=vol_cfg, depth_scale=scale, device=dev)
    single_poses = [single.process(walk[f], float(f)).pose for f in range(30)]
    tvs_single = max(ctx.twist_gap(single_poses, poses_of(trecs[i])) for i in range(4))
    check(tvs_single <= TWIST_BAR_CPU, f"serve_tsdf: slots part from TsdfTracker by {tvs_single}")
    sub_ex = BatchedExecutor(batching(capacity=4, tsdf=True, tsdf_cfg=vol_cfg, tsdf_submap_radius=0.05))
    try:
        sub = sub_ex.make_session_tracker()
        sub_res = [sub.process(walk[f], float(f)) for f in range(30)]
        reseeds = sub.num_reseeds
    finally:
        sub_ex.close()
    check(reseeds >= 1 and all(r.success for r in sub_res), f"serve_tsdf: {reseeds} reseeds under the submap radius")
    emit("serve_tsdf", sessions=4, frames=30, volume=vol_cfg.resolution, dispatches=td,
         mean_slots_per_dispatch=tst["mean_batch"], launches=tgot, ate_rmse=tates, twist_vs_tsdf_tracker=tvs_single,
         frames_per_s=4 * 30 / twall, latency_ms={"p50": pct(tlat, 0.5), "p90": pct(tlat, 0.9)},
         submap_radius_0_05={"reseeds": reseeds, "frames": len(sub_res)}, card=card)

    # ---- 22. serve_plain: the unbatched service, Tracker(method="keyframe") -
    kf_cfg = TrackerConfig(intrinsics=intr, method="keyframe", depth_scale=scale, device="cuda")
    plain_svc = TrackingService(lambda: Tracker(kf_cfg), depth_scale=scale)
    try:
        purl = f"http://127.0.0.1:{plain_svc.port}"
        t0 = time.perf_counter()
        precs = [post_frame(purl, walk[f], ts=float(f), timeout=timeout) for f in range(30)]
        pwall = time.perf_counter() - t0
        status = get_json(purl, "/status", timeout=timeout)
    finally:
        plain_svc.close()
    direct = Tracker(kf_cfg)
    direct_poses = [direct.process(walk[f], float(f)).pose for f in range(30)]
    pgap = float(np.abs(np.stack(poses_of(precs)) - np.stack(direct_poses)).max())
    check(pgap <= 1e-6 and all(r["success"] for r in precs), f"serve_plain: service parts from the tracker by {pgap}")
    emit("serve_plain", frames=30, method="keyframe", pose_gap_vs_direct=pgap, frames_per_s=30 / pwall,
         status_frames=status["frames"], card=card)

    # ---- 23. rs_serve: the CLI as a subprocess ------------------------------
    n_cli = 4
    cli_intr = type(intr)(fx=0.8 * w, fy=0.8 * w, cx=(w - 1) / 2, cy=(h - 1) / 2, width=w, height=h)
    cli_d, _ = synthetic.render_trajectory(cli_intr, n_cli, seed=1, device=dev)
    cli_frames = u16(cli_d)
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "realsensetracker_tpu_torch.cli.rs_serve", "--batched", "--max-frames", str(n_cli),
         "--depth-scale", str(scale)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")},
    )
    try:
        banner, m = "", None
        for _ in range(50):  # the address line, past any warnings on the merged stream
            line = proc.stdout.readline()
            m = re.search(r"http://127\.0\.0\.1:(\d+)/", line)
            if m or not line:
                banner = line
                break
        check(m is not None, f"rs_serve: no address line (last {banner!r})")
        cli_url = f"http://127.0.0.1:{m.group(1)}"
        cli_recs = [post_frame(cli_url, cli_frames[f], ts=float(f), timeout=timeout) for f in range(n_cli)]
        rest, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    check(proc.returncode == 0, f"rs_serve: exit code {proc.returncode}: {rest}")
    check(f"served {n_cli} frames" in rest, f"rs_serve: {rest!r}")
    check(all(r["success"] for r in cli_recs), "rs_serve: a frame failed")
    emit("rs_serve", frames=n_cli, banner=banner.strip(), tail=rest.strip().splitlines()[-1], card=card)


def replay_phase(ctx) -> None:
    """Phase 24: host I/O and the replay entry point at 640x480. Writes a
    60-frame TUM-layout sequence (16-bit depth PNGs at 1/5000 m) and a
    60-frame v2 .rsc clip with color in a temporary directory, through the
    port's writers, and replays them with cli.rs_replay.main in-process:
    files -> decode on the FrameStream's producer thread -> pinned staging
    -> an upload on its own CUDA stream -> the tracker -> the kernels. ctx
    carries main()'s helpers (dev, card, reset_counts, read_counts,
    check_counts)."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from realsensetracker_tpu_torch.align import projective
    from realsensetracker_tpu_torch.align.rgbd import RgbdIcpConfig
    from realsensetracker_tpu_torch.api import Tracker, TrackerConfig
    from realsensetracker_tpu_torch.cli import rs_replay
    from realsensetracker_tpu_torch.data import recorded, tum
    from realsensetracker_tpu_torch.data import stream as frame_stream
    from realsensetracker_tpu_torch.data.stream import stream_tum
    from realsensetracker_tpu_torch.geometry import camera
    from realsensetracker_tpu_torch.tracking import trajectory
    from realsensetracker_tpu_torch.utils.profiling import device_trace

    dev, card = ctx.dev, ctx.card
    n_frames, h, w = 60, 480, 640
    cfg = projective.ProjectiveIcpConfig()
    levels, rounds = len(cfg.iters), sum(cfg.iters)
    rgbd_cfg = projective.fit_levels(RgbdIcpConfig(), h, w)
    rgbd_levels, rgbd_steps = len(rgbd_cfg.iters), sum(rgbd_cfg.iters) + 1
    tmp = tempfile.mkdtemp(prefix="replay-")
    seq_dir, clip_path = os.path.join(tmp, "seq"), os.path.join(tmp, "clip.rsc")

    t0 = time.perf_counter()
    tum.synthesize_tum_sequence(seq_dir, num_frames=n_frames, seed=0, width=w, height=h)
    _, clip_truth = recorded.record_synthetic_clip(clip_path, num_frames=n_frames, seed=0, width=w, height=h,
                                                   with_color=True, return_poses=True)
    write_s = time.perf_counter() - t0
    seq = tum.TumSequence.open(seq_dir)
    paths = [os.path.join(seq_dir, rel) for _, rel in seq.depth_index]

    # PNG decoders: the native one (when the library loads) bit-equal to
    # the numpy one on every frame; producer decode ms per frame of each.
    png_backend, png_why = tum.png_backend()
    clip_backend, clip_why = recorded.backend()
    t0 = time.perf_counter()
    numpy_frames = [tum.read_png(p) for p in paths]
    numpy_ms = (time.perf_counter() - t0) * 1e3 / n_frames
    decode = {"numpy_ms_per_frame": numpy_ms}
    if png_backend == "native":
        from realsensetracker_tpu_torch.native import png_io

        t0 = time.perf_counter()
        native_frames = [png_io.read_png16(p) for p in paths]
        decode["native_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / n_frames
        t0 = time.perf_counter()
        batch = seq.load_depth_batch(range(n_frames), raw=True)
        decode["native_batch_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / n_frames
        check(all(np.array_equal(a, b) for a, b in zip(native_frames, numpy_frames)),
              "replay: the native PNG decoder differs from the numpy one")
        check(np.array_equal(batch, np.stack(numpy_frames)), "replay: the native batch decoder differs")
    emit("replay_io", frames=n_frames, shape=[h, w], write_s=write_s, png_backend=png_backend,
         png_backend_why=png_why, clip_backend=clip_backend, clip_backend_why=clip_why,
         native_equals_numpy=png_backend == "native", producer_decode=decode, card=card)

    def replay(argv):
        """rs_replay.main(argv + --json) with the counts reset just before
        and read just after: (rows, summary lines, launches)."""
        out = io.StringIO()
        ctx.reset_counts()
        with contextlib.redirect_stdout(out):
            rc = rs_replay.main(argv + ["--json"])
        launches = ctx.read_counts()
        check(rc == 0, f"rs_replay {argv}: exit {rc}")
        rows = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
        lines = [ln for ln in out.getvalue().splitlines() if not ln.startswith("{")]
        return rows, lines, launches

    def ate_line(lines):
        return json.loads(next(ln for ln in lines if ln.startswith("ATE:"))[len("ATE:"):])

    def host_ms(rows, warm=5):
        ms = [r["ms"] for r in rows[warm:]]
        return statistics.median(ms)

    def fps(lines):
        m = re.search(r"processed (\d+) frames in ([\d.]+)s \(([\d.]+) fps\)", "\n".join(lines))
        check(m is not None, f"replay: no 'processed' line in {lines}")
        return int(m.group(1)), float(m.group(3))

    def clip_ate(rows):
        est, gt = trajectory.Trajectory(), trajectory.Trajectory()
        for r in rows:
            est.append(r["timestamp"], np.asarray(r["pose"], np.float64).reshape(4, 4))
            gt.append(r["timestamp"], clip_truth[r["frame"]].numpy())
        return trajectory.absolute_trajectory_error(est, gt)

    runs = {}
    # (a) TUM, projective: raw u16 frames streamed, ATE against groundtruth.txt.
    traj_a = os.path.join(tmp, "traj_a.txt")
    rows, lines, got = replay(["--tum", seq_dir, "--method", "projective", "--ate", "--trajectory-out", traj_a])
    ctx.check_counts(got, "replay projective", levels * n_frames, rounds * (n_frames - 1), n_frames)
    n, rate = fps(lines)
    ate = ate_line(lines)
    check(n == n_frames and all(r["success"] for r in rows), f"replay projective: {n} frames, a frame failed")
    check(ate["rmse"] < ATE_BAR, f"replay projective: ATE rmse {ate['rmse']} >= {ATE_BAR}")
    check(os.path.getsize(traj_a) > 0, "replay projective: no trajectory file")
    runs["a_tum_projective"] = {"frames": n, "ate_rmse": ate["rmse"], "host_ms_per_frame_median": host_ms(rows),
                                "fps": rate, "launches": got}

    # (b) the same for 10 frames on the CPU: the card within 1e-4.
    cpu_rows, _, cpu_got = replay(["--tum", seq_dir, "--method", "projective", "--max-frames", "10",
                                   "--device", "cpu"])
    ctx.check_counts(cpu_got, "replay projective on the CPU", 0, 0, 0)
    gap = max(float(np.abs(np.asarray(a["pose"]) - np.asarray(b["pose"])).max()) for a, b in zip(rows, cpu_rows))
    check(len(cpu_rows) == 10 and gap <= TWIST_BAR_CPU, f"replay: card vs CPU pose gap {gap} > {TWIST_BAR_CPU}")
    runs["b_card_vs_cpu"] = {"frames": len(cpu_rows), "pose_max_abs_diff": gap, "bar": TWIST_BAR_CPU}

    # (c) the clip, keyframe in windows of 8: the first window seeds frame 0
    # and pads the other 7 to 8 rows, the last pads its 4; one batched
    # pyramid and 8 rows of GN rounds per window.
    window = 8
    rows, lines, got = replay(["--record", clip_path, "--method", "keyframe", "--window", str(window)])
    n_win = 1 + -(-(n_frames - 1) // window)  # the seed, then ceil(59 / 8) windows
    ctx.check_counts(got, "replay keyframe windowed", levels * n_win, rounds * window * (n_win - 1), n_win)
    c_ate = clip_ate(rows)
    check(len(rows) == n_frames and all(r["success"] for r in rows), "replay keyframe: a frame failed")
    check(c_ate["rmse"] < ATE_BAR, f"replay keyframe: ATE rmse {c_ate['rmse']} >= {ATE_BAR}")
    runs["c_clip_keyframe_w8"] = {"frames": fps(lines)[0], "ate_rmse": c_ate["rmse"],
                                  "host_ms_per_frame_median": host_ms(rows), "fps": fps(lines)[1], "launches": got}

    # (d) the clip, tsdf (default 128^3 x 4 cm volume) with a mesh export.
    mesh_path = os.path.join(tmp, "mesh.ply")
    rows, lines, got = replay(["--record", clip_path, "--method", "tsdf", "--save-mesh", mesh_path])
    tracked = n_frames - 1
    ctx.check_counts(got, "replay tsdf", levels * tracked, rounds * tracked, 2 * tracked,
                     integrates=n_frames, raycasts=tracked)
    d_ate = clip_ate(rows)
    m = re.search(r"mesh \((\d+) triangles\)", "\n".join(lines))
    check(m is not None and int(m.group(1)) > 0 and os.path.getsize(mesh_path) > 0, f"replay tsdf: mesh {lines}")
    check(all(r["success"] for r in rows), "replay tsdf: a frame failed")
    check(d_ate["rmse"] < ATE_BAR, f"replay tsdf: ATE rmse {d_ate['rmse']} >= {ATE_BAR}")
    runs["d_clip_tsdf_mesh"] = {"frames": fps(lines)[0], "ate_rmse": d_ate["rmse"], "triangles": int(m.group(1)),
                                "host_ms_per_frame_median": host_ms(rows), "fps": fps(lines)[1], "launches": got}

    # (e) the clip, rgbd: gray from the clip's color plane, gn_system.
    rows, lines, got = replay(["--record", clip_path, "--method", "rgbd"])
    ctx.check_counts(got, "replay rgbd", rgbd_levels * n_frames, 0, 2 * n_frames - 1,
                     systems=rgbd_steps * (n_frames - 1))
    e_ate = clip_ate(rows)
    check(all(r["success"] for r in rows), "replay rgbd: a frame failed")
    check(e_ate["rmse"] < ATE_BAR, f"replay rgbd: ATE rmse {e_ate['rmse']} >= {ATE_BAR}")
    runs["e_clip_rgbd"] = {"frames": fps(lines)[0], "ate_rmse": e_ate["rmse"],
                           "host_ms_per_frame_median": host_ms(rows), "fps": fps(lines)[1], "launches": got}
    emit("replay", bar_ate=ATE_BAR, runs=runs, card=card)

    # Syncs and copies per frame: two profiled replays of 10 and 30 frames,
    # differenced (set-up and the first, untracked frame cancel out). Host
    # syncs are also counted by the profiler's thread: the thread that
    # launches the kernels (the consumer) and any other (the producer).
    def profiled(max_frames):
        before = dict(frame_stream.UPLOADS)
        with device_trace(tmp, f"trace{max_frames}.json") as prof:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = rs_replay.main(["--tum", seq_dir, "--method", "projective", "--max-frames", str(max_frames)])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        check(rc == 0, "replay: profiled run failed")
        counted = {k: frame_stream.UPLOADS[k] - before[k] for k in before}
        check(counted == {"frames": max_frames, "arrays": max_frames},
              f"replay: FrameStream uploaded {counted} in a {max_frames}-frame run (expected one u16 frame each)")
        events = prof.events()
        launches = [e.thread for e in events if e.name.startswith("cudaLaunchKernel")]
        consumer = statistics.mode(launches) if launches else None
        sync_names = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
        syncs = [e for e in events if e.name in sync_names]
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        with open(os.path.join(tmp, f"trace{max_frames}.json")) as f:
            trace = json.load(f)["traceEvents"]
        kernels = [e for e in trace if e.get("cat") == "kernel"]
        htod = [e for e in trace if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
        uploads = [e for e in htod if e["args"].get("bytes") == h * w * 2]  # the u16 frames
        check(0 < len(uploads) <= counted["arrays"],
              f"replay: the trace holds {len(uploads)} frame-sized uploads, FrameStream made {counted['arrays']}")
        compute = statistics.mode([e["args"]["stream"] for e in kernels]) if kernels else None
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
        overlap = 0.0
        for u in uploads:
            a, b = u["ts"], u["ts"] + u["dur"]
            overlap += sum(max(0.0, min(b, y) - max(a, x)) for x, y in spans if x < b and y > a)
        busy, end = 0.0, float("-inf")
        for a, b in sorted((e.time_range.start, e.time_range.end) for e in device):
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        return {"syncs": len(syncs), "syncs_consumer_thread": sum(e.thread == consumer for e in syncs),
                "syncs_other_threads": sum(e.thread != consumer for e in syncs),
                "dtoh": sum("DtoH" in e.name for e in device), "htod": len(htod), "frame_uploads": len(uploads),
                "counted_uploads": counted["arrays"], "uploads_missing_from_trace": counted["arrays"] - len(uploads),
                "upload_streams": sorted({e["args"]["stream"] for e in uploads}), "compute_stream": compute,
                "upload_us": sum(e["dur"] for e in uploads), "upload_overlap_us": overlap,
                "busy_share": busy / wall_us}

    # The uploads are held by FrameStream's own count (one per frame in each
    # run, above); the trace's frame-sized memcpy records are reported beside
    # it: the trace holds fewer than the run made, by a number that moves by
    # one from run to run, so they do not difference to one per frame.
    p10, p30 = profiled(10), profiled(30)
    per_frame = {k: (p30[k] - p10[k]) / 20
                 for k in ("syncs", "syncs_other_threads", "dtoh", "htod", "frame_uploads", "counted_uploads")}
    check(per_frame["syncs"] == 1, f"replay: host syncs per frame {per_frame} (expected 1: the pose read)")
    check(per_frame["counted_uploads"] == 1, f"replay: frame uploads per frame {per_frame}")
    check(p30["compute_stream"] not in p30["upload_streams"],
          f"replay: uploads on streams {p30['upload_streams']}, the compute stream is {p30['compute_stream']}")

    # prefetch=2 against an inline load over the same 60 frames, in turns.
    def run_prefetch():
        trk = Tracker(TrackerConfig(intrinsics=camera.TUM_FR1, method="projective", depth_scale=1 / tum.DEPTH_SCALE))
        with stream_tum(seq, raw=True, device=dev) as fs:
            for ts, d in fs:
                trk.process(d, ts)

    def run_inline():
        trk = Tracker(TrackerConfig(intrinsics=camera.TUM_FR1, method="projective", depth_scale=1 / tum.DEPTH_SCALE))
        for ts, d in seq.frames(raw=True):
            trk.process(torch.from_numpy(d).to(dev), ts)

    turns_ms = {"prefetch": [], "inline": []}
    for name, fn in (("prefetch", run_prefetch), ("inline", run_inline), ("inline", run_inline),
                     ("prefetch", run_prefetch)):
        t0 = time.perf_counter()
        fn()
        turns_ms[name].append((time.perf_counter() - t0) * 1e3 / n_frames)
    emit("replay_stream", per_frame=per_frame, window_10=p10, window_30=p30,
         uploads_off_compute_stream=p30["compute_stream"] not in p30["upload_streams"],
         upload_overlap_share=p30["upload_overlap_us"] / max(p30["upload_us"], 1e-9),
         ms_per_frame_prefetch2=turns_ms["prefetch"], ms_per_frame_inline=turns_ms["inline"], card=card)
    shutil.rmtree(tmp, ignore_errors=True)


def _capture_main(main, argv):
    """main(argv) with its standard output and error captured: (rc, stdout
    lines, stderr)."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue().splitlines(), err.getvalue()


def _recording(module, names):
    """Wrap module.<name> for each name so that the state each call
    returns (out[0]) is kept: (box, undo)."""
    box, saved = {}, {name: getattr(module, name) for name in names}
    for name, fn in saved.items():
        def record(*a, _fn=fn, **k):
            out = _fn(*a, **k)
            box["state"] = out[0]
            return out

        setattr(module, name, record)
    return box, lambda: [setattr(module, n, f) for n, f in saved.items()]


def cli_phase(ctx) -> None:
    """Phase 25: the remaining entry points on the card, each through its
    main(argv) at 640x480: rs_benchmark (every pipeline), rs_streams (the
    four modes), rs_align, capture and rs_viewer. ctx carries main()'s
    helpers (dev, card, reset_counts, read_counts, check_counts) and
    timing_register_pairs_per_s, phase 9's rate on the same workload."""
    import numpy as np
    import shutil
    import tempfile

    import torch

    from realsensetracker_tpu_torch.align import projective
    from realsensetracker_tpu_torch.align.rgbd import RgbdIcpConfig
    from realsensetracker_tpu_torch.cli import capture, rs_align, rs_benchmark, rs_streams, rs_viewer
    from realsensetracker_tpu_torch.data import recorded, synthetic
    from realsensetracker_tpu_torch.geometry import se3
    from realsensetracker_tpu_torch.parallel import batched, streams

    dev, card = ctx.dev, ctx.card
    h, w = 480, 640
    cfg = projective.ProjectiveIcpConfig()
    levels, rounds = len(cfg.iters), sum(cfg.iters)
    rgbd_cfg = projective.fit_levels(RgbdIcpConfig(), h, w)
    rgbd_levels, rgbd_steps = len(rgbd_cfg.iters), sum(rgbd_cfg.iters) + 1
    tmp = tempfile.mkdtemp(prefix="cli-")

    def bench(argv):
        """rs_benchmark.main(argv) with the counts reset just before and read
        just after: (JSON record, launches, seconds)."""
        ctx.reset_counts()
        t0 = time.perf_counter()
        rc, lines, _ = _capture_main(rs_benchmark.main, argv)
        seconds = time.perf_counter() - t0
        launches = ctx.read_counts()
        check(rc == 0 and len(lines) == 1, f"rs_benchmark {argv}: exit {rc}, {lines}")
        return json.loads(lines[0]), launches, seconds

    # rs_benchmark projective-icp: the defaults (B=64, 10 calls after a
    # warm-up), then bench.py's workload (2048 pairs in chunks of 512, 3
    # calls). register_batch: one target and one source pyramid per
    # registration (or per chunk), sum(iters) gn_round launches.
    runs = {}
    rec, got, secs = bench([])
    n_calls = 1 + 10
    ctx.check_counts(got, "rs_benchmark default", levels * n_calls, rounds * n_calls, 2 * n_calls)
    runs["projective_b64"] = {"record": rec, "launches": got, "seconds_with_setup": secs}
    rec, got, secs = bench(["--batch", "2048", "--chunk", "512", "--iters", "3"])
    n_chunks = (1 + 3) * (2048 // 512)
    ctx.check_counts(got, "rs_benchmark 2048/512", levels * n_chunks, rounds * n_chunks, 2 * n_chunks)
    runs["projective_b2048_c512"] = {"record": rec, "launches": got, "seconds_with_setup": secs,
                                     "timing_register_pairs_per_s": ctx.timing_register_pairs_per_s}
    print(json.dumps(runs["projective_b64"]["record"]), flush=True)
    print(json.dumps(rec), flush=True)

    # The same run with --profile: the device trace of the timed region
    # (2 calls) holds sum(iters) gn_round kernels per call, and level and
    # downsample kernels (a trace can miss the first kernel or two after
    # the profiler starts: those are counted exactly above).
    prof_dir = os.path.join(tmp, "profile")
    rec_p, got_p, _ = bench(["--iters", "2", "--profile", prof_dir])
    with open(os.path.join(prof_dir, "trace.json")) as f:
        kernels = [e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    traced = {name: sum(name in k for k in kernels)
              for name in ("gn_round_kernel", "level_packed_kernel", "downsample_kernel")}
    check(traced["gn_round_kernel"] == 2 * rounds, f"rs_benchmark --profile: {traced} (gn_round {2 * rounds})")
    check(traced["level_packed_kernel"] > 0 and traced["downsample_kernel"] > 0, f"rs_benchmark --profile: {traced}")
    runs["projective_profiled"] = {"record": rec_p, "trace_kernels": traced, "device_kernels": len(kernels)}

    # The factored inputs, registered once: every pair within 3e-3 (twist)
    # of the rendered motion.
    intr, src, dst, T_true = rs_benchmark.projective_inputs(64, w, h, dev)
    ctx.reset_counts()
    T = batched.register_batch(src, dst, intr, cfg).transform
    ctx.read_counts()
    gaps = se3.log(se3.compose(se3.inverse(T_true)[None], T)).abs().amax(-1)
    worst = gaps.max().item()
    check(worst < TWIST_BAR_MOTION, f"rs_benchmark inputs: twist gap {worst} >= {TWIST_BAR_MOTION}")
    runs["projective_inputs"] = {"pairs": 64, "twist_gap_max": worst, "bar": TWIST_BAR_MOTION}
    del src, dst

    # The other pipelines, small. The cloud pipelines run no kernel of the
    # port's; rgbd one target pyramid, one source chain and
    # sum(iters) + 1 gn_system launches per registration of the batch.
    rec, got, secs = bench(["--pipeline", "gicp", "--batch", "4", "--points", "4096", "--iters", "1"])
    ctx.check_counts(got, "rs_benchmark gicp", 0, 0, 0)
    runs["gicp"] = {"record": rec, "seconds_with_setup": secs}
    rec, got, secs = bench(["--pipeline", "gnc-icp", "--batch", "4", "--points", "4096", "--iters", "1"])
    ctx.check_counts(got, "rs_benchmark gnc-icp", 0, 0, 0)
    runs["gnc_icp"] = {"record": rec, "seconds_with_setup": secs}
    rec, got, secs = bench(["--pipeline", "rgbd", "--batch", "8", "--iters", "2"])
    ctx.check_counts(got, "rs_benchmark rgbd", rgbd_levels * 3, 0, 2 * 3, systems=rgbd_steps * 3)
    runs["rgbd"] = {"record": rec, "launches": got, "seconds_with_setup": secs}
    for name in ("slam-window", "tsdf-window"):
        rec, got, secs = bench(["--pipeline", name, "--batch", "40", "--window", "8"])
        want = ("gn_round", "build_level_packed", "downsample_levels") + (
            ("tsdf_depth_tiles", "tsdf_cull", "tsdf_integrate", "tsdf_raycast") if name == "tsdf-window" else ())
        check(all(got[k] > 0 for k in want), f"rs_benchmark {name}: launches {got}")
        runs[name] = {"record": rec, "launches": got, "seconds_with_setup": secs}
    emit("cli_rs_benchmark", runs=runs, card=card)

    # rs_streams, the four modes at 640x480: per step one batched
    # registration of the 8 streams (sum(iters) gn_round launches, one
    # pyramid), or one joint RGB-D registration (sum(iters) + 1 gn_system
    # launches), or 8 renders (2 raycast launches each, coarse-to-fine)
    # and 8 integrates. The warm-up step (or window) is counted with them.

    def streams_run(argv):
        ctx.reset_counts()
        rc, lines, err = _capture_main(rs_streams.main, argv)
        got = ctx.read_counts()
        check(rc == 0, f"rs_streams {argv}: exit {rc}: {err}")
        m = re.search(r"x (\d+) steps in ([\d.]+)s: ([\d.]+) FPS/stream \((\d+) frames/s aggregate\)",
                      "\n".join(lines))
        check(m is not None, f"rs_streams {argv}: no summary in {lines[-3:]}")
        target = next(ln for ln in lines if ln.startswith("config-5 target"))
        tracking = [ln for ln in lines if ln.startswith("frame ")]
        check(tracking and all(ln.endswith("8/8 streams tracking") for ln in tracking),
              f"rs_streams {argv}: {[ln for ln in tracking if not ln.endswith('8/8 streams tracking')]}")
        return {"steps": int(m.group(1)), "seconds": float(m.group(2)), "fps_per_stream": float(m.group(3)),
                "frames_per_s": int(m.group(4)), "config5": target.split(": ")[1], "launches": got}

    s = 8  # the CLI's default --streams
    modes = {}
    t0 = time.perf_counter()
    # (label, extra flags, steps with the warm-up, the set-up's launches)
    for label, extra, n, setup in (
            ("depth", [], 1 + 29, {"levels": levels, "pyramids": 1}),
            ("window8", ["--window", "8"], 8 + 24 + 5, {"levels": levels, "pyramids": 1}),
            ("rgb", ["--rgb", "--frames", "6"], 1 + 5, {"levels": rgbd_levels, "pyramids": 1}),
            ("tsdf", ["--tsdf", "--frames", "10"], 1 + 9, {"integrates": 1})):
        r = streams_run(extra)
        if label == "rgb":  # per step: the target pyramid, the source chain, the joint steps
            per = {"levels": rgbd_levels, "gn_rounds": 0, "pyramids": 2, "systems": rgbd_steps}
        elif label == "tsdf":  # per step: S coarse-to-fine renders, one registration, one integrate of the S
            per = {"levels": levels, "gn_rounds": rounds, "pyramids": 2, "integrates": 1, "raycasts": 2 * s}
        else:  # per step: one pyramid of the S new frames, one registration
            per = {"levels": levels, "gn_rounds": rounds, "pyramids": 1}
        want = {k: per.get(k, 0) * n + setup.get(k, 0) for k in set(per) | set(setup)}
        ctx.check_counts(r["launches"], f"rs_streams {label}", **want)
        r["launches_per_step"] = per
        modes[label] = r
    modes_s = time.perf_counter() - t0

    # The card against the CPU, each mode at 160x120, 2 streams x 4 frames,
    # on the same frames (rendered on the CPU for both runs): the final
    # poses of every stream within 1e-4.
    small = ["--streams", "2", "--frames", "4", "--width", "160", "--height", "120"]
    real_renders = {name: getattr(synthetic, name) for name in ("render_trajectory", "render_trajectory_rgbd")}

    def render_on_cpu(real):
        def render(intr_, n_, scene=None, **kw):
            return real(intr_, n_, scene=synthetic.Scene(*(x.cpu() if torch.is_tensor(x) else x for x in scene)),
                        **kw)
        return render

    vs_cpu = {}
    t0 = time.perf_counter()
    for label, extra in (("depth", []), ("window2", ["--window", "2"]), ("rgb", ["--rgb"]), ("tsdf", ["--tsdf"])):
        poses = {}
        for device in ("cuda", "cpu"):
            box, undo = _recording(streams, ("step_streams", "step_streams_window", "step_streams_masked_rgbd",
                                             "step_tsdf_streams"))
            for name, real in real_renders.items():
                setattr(synthetic, name, render_on_cpu(real))
            try:
                rc, _, err = _capture_main(rs_streams.main, small + extra + ["--device", device])
            finally:
                undo()
                for name, real in real_renders.items():
                    setattr(synthetic, name, real)
            check(rc == 0, f"rs_streams {label} on {device}: {err}")
            poses[device] = box["state"].poses.cpu().double()
        vs_cpu[label] = (poses["cuda"] - poses["cpu"]).abs().max().item()
    vs_cpu_s = time.perf_counter() - t0
    worst = max(vs_cpu.values())
    check(worst <= TWIST_BAR_CPU, f"rs_streams: card vs CPU poses {vs_cpu} > {TWIST_BAR_CPU}")
    emit("cli_rs_streams", streams=s, modes=modes, poses_vs_cpu=vs_cpu, bar_vs_cpu=TWIST_BAR_CPU,
         seconds={"modes": modes_s, "vs_cpu": vs_cpu_s}, card=card)

    # rs_align on two 640x480 frames of a clip (default flags, the 8192
    # cap): the card within 1e-3 of the CPU. The truth gaps are printed
    # with no bar: two frames' own voxel clouds sample the surfaces
    # differently (phase align_pair), and the FPFH cap of 64 truncates the
    # 0.5 m ball, whose Kabsch seed can land off even on shared points.
    clip_path = os.path.join(tmp, "clip.rsc")
    clip, clip_poses = recorded.record_synthetic_clip(clip_path, num_frames=2, seed=0, width=w, height=h,
                                                      with_color=True, return_poses=True)
    T_rel = se3.compose(se3.inverse(clip_poses[1]), clip_poses[0])

    def align(argv):
        ctx.reset_counts()
        t0 = time.perf_counter()
        rc, lines, err = _capture_main(rs_align.main, argv + ["--capacity", "8192"])
        seconds = time.perf_counter() - t0
        got = ctx.read_counts()
        check(rc == 0, f"rs_align {argv}: exit {rc}: {err}")
        text = "\n".join(lines)
        nums = re.findall(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?", text.split("transform :")[1])[:16]
        T_ = torch.tensor([float(x) for x in nums], dtype=torch.float64).reshape(4, 4)
        return {"T": T_, "matches": int(text.split("matches :")[1].split()[0]), "seconds": seconds,
                "launches": got}

    def gap(Ta, Tb):
        return se3.log((torch.linalg.inv(Ta.double()) @ Tb.double()).float()).abs().max().item()

    card_run = align(["--clip", clip_path])
    cpu_run = align(["--clip", clip_path, "--device", "cpu"])
    align_vs_cpu = gap(card_run["T"], cpu_run["T"])
    check(align_vs_cpu <= CLOUD_CPU_BAR, f"rs_align: card vs CPU twist {align_vs_cpu} > {CLOUD_CPU_BAR}")
    src_cloud = rs_align._cloud_from_depth(clip.depths[0], clip.intrinsics, 8192, dev)
    pts = src_cloud.points[src_cloud.mask]
    np.save(os.path.join(tmp, "s.npy"), pts.cpu().numpy())
    np.save(os.path.join(tmp, "d.npy"), se3.transform_points(T_rel.to(dev), pts).cpu().numpy())
    shared = align(["-s", os.path.join(tmp, "s.npy"), "-t", os.path.join(tmp, "d.npy")])
    align_row = {
        "card_vs_cpu_twist": align_vs_cpu, "bar_vs_cpu": CLOUD_CPU_BAR,
        "clip_truth_gap_card": gap(card_run["T"], T_rel), "clip_truth_gap_cpu": gap(cpu_run["T"], T_rel),
        "shared_points_truth_gap_card": gap(shared["T"], T_rel), "motion_twist_max": se3.log(T_rel).abs().max().item(),
        "matches": [card_run["matches"], cpu_run["matches"], shared["matches"]],
        "seconds": {"card": card_run["seconds"], "cpu": cpu_run["seconds"], "shared_card": shared["seconds"]},
        "launches_card": card_run["launches"],
    }

    # capture --clip and rs_viewer --view --ply-dir: the PLY point counts
    # of the card's run equal to the CPU's; the live loop records.
    def ply_counts(directory):
        counts = {}
        for name in sorted(os.listdir(directory)):
            with open(os.path.join(directory, name)) as f:
                head = f.read(200)
            counts[name] = int(re.search(r"element vertex (\d+)", head).group(1))
        return counts

    plys = {}
    for device in ("cuda", "cpu"):
        cap_dir, view_dir = os.path.join(tmp, f"cap-{device}"), os.path.join(tmp, f"view-{device}")
        os.makedirs(cap_dir)
        rc, _, err = _capture_main(capture.main, ["--clip", clip_path, "--frames", "2", "--out",
                                                  os.path.join(cap_dir, "{:04d}.ply"), "--device", device])
        check(rc == 0, f"capture on {device}: {err}")
        rc, _, err = _capture_main(rs_viewer.main, ["--view", clip_path, "--ply-dir", view_dir, "--device", device])
        check(rc == 0, f"rs_viewer --ply-dir on {device}: {err}")
        plys[device] = {"capture": ply_counts(cap_dir), "viewer": ply_counts(view_dir)}
    check(plys["cuda"] == plys["cpu"] and len(plys["cuda"]["capture"]) == len(plys["cuda"]["viewer"]) == 2,
          f"capture/rs_viewer PLY counts: card {plys['cuda']}, CPU {plys['cpu']}")
    live_clip, latest = os.path.join(tmp, "live.rsc"), os.path.join(tmp, "latest.png")
    n_live = 8
    rc, lines, err = _capture_main(rs_viewer.main, ["--loop", "--frames", str(n_live), "--record", live_clip,
                                                    "--live-latest", latest])
    check(rc == 0 and f"live loop: {n_live} frames shown" in lines, f"rs_viewer --loop: {rc} {lines} {err}")
    with open(latest, "rb") as f:
        check(f.read(8) == b"\x89PNG\r\n\x1a\n", "rs_viewer --live-latest: not a PNG")
    check(len(recorded.read_clip(live_clip)) == n_live, "rs_viewer --loop --record: frame count")
    emit("cli_tools", rs_align=align_row, ply_points=plys["cuda"], ply_equal_cpu=True,
         live_loop={"frames": n_live, "recorded": n_live, "png_bytes": os.path.getsize(latest)}, card=card)
    shutil.rmtree(tmp, ignore_errors=True)


def multidevice_phase(ctx) -> None:
    """Phase 26, multidevice: the multi-device layer (parallel/mesh,
    multihost, sharded, batched.register_batch_sharded, mapping/sharded,
    BatchingConfig(mesh=...), optimize_atlas(mesh=...), parallel/dryrun) on
    a world-size-1 NCCL group of this process: a 1x1 mesh, one card, every
    collective run and each the identity. ctx carries main()'s helpers
    (dev, card, reset_counts, read_counts, check_counts, time_ms) and
    dense_phases' "atlas". One JSON line; any failed check raises."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from realsensetracker_tpu_torch.align import projective
    from realsensetracker_tpu_torch.api.batching import BatchedExecutor, BatchingConfig
    from realsensetracker_tpu_torch.data import synthetic
    from realsensetracker_tpu_torch.geometry import camera, se3
    from realsensetracker_tpu_torch.mapping import sharded as tsdf_sharded
    from realsensetracker_tpu_torch.mapping import submaps as submaps_mod
    from realsensetracker_tpu_torch.mapping import tsdf as tsdf_mod
    from realsensetracker_tpu_torch.parallel import batched, multihost, sharded
    from realsensetracker_tpu_torch.parallel import mesh as mesh_mod
    from realsensetracker_tpu_torch.parallel.dryrun import dryrun_multichip

    dev, card = ctx.dev, ctx.card
    t_phase = time.perf_counter()
    mesh = mesh_mod.make_mesh()  # no group yet: a world-size-1 NCCL group over an in-memory store
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1, "multidevice: not one NCCL rank")
        check(tuple(mesh.mesh.shape) == (1, 1) and mesh_mod.mesh_device(mesh) == dev, "multidevice: mesh")
        multihost.all_processes_ready()
        intr, cfg = camera.TUM_FR1, projective.ProjectiveIcpConfig()
        levels, rounds = len(cfg.iters), sum(cfg.iters)

        # -- registration: 64 pairs at 640x480, the default config ----------
        n_pairs = 64
        scene = synthetic.default_scene(seed=5, device=dev)
        twists = 0.02 * torch.randn((n_pairs, 6), generator=torch.Generator().manual_seed(12))
        rendered = [synthetic.render_pair(intr, tw, scene) for tw in twists]
        src = torch.stack([r[1] for r in rendered])
        dst = torch.stack([r[0] for r in rendered])
        ref = batched.register_batch(src, dst, intr, cfg)
        ctx.reset_counts()
        T_pt, rmse_pt = sharded.register_batch_point_sharded(mesh, src, dst, intr, cfg)
        pt_launches = ctx.read_counts()
        ctx.check_counts(pt_launches, "multidevice point-sharded", levels, 0, 2, systems=rounds * cfg.inner_iters)
        ctx.reset_counts()
        res_dp = batched.register_batch_sharded(mesh, src, dst, intr, cfg)
        dp_launches = ctx.read_counts()
        ctx.check_counts(dp_launches, "multidevice data-parallel", levels, rounds, 2)

        def gap(T):
            return se3.log(se3.compose(se3.inverse(ref.transform), T)).abs().amax().item()

        pt_gap, dp_gap = gap(T_pt), gap(res_dp.transform)
        truth = torch.stack([r[2] for r in rendered])
        truth_gap = se3.log(se3.compose(se3.inverse(truth), T_pt)).abs().amax().item()
        check(bool(torch.isfinite(T_pt).all() and torch.isfinite(rmse_pt).all()), "multidevice: non-finite pose")
        check(pt_gap <= 1e-5 and dp_gap <= 1e-5, f"multidevice: twist gaps {pt_gap}, {dp_gap} > 1e-5")
        def host_ms(fn, reps=3):
            out = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(out)

        # Host ms per call in turns: plain, point-sharded, data-parallel, plain.
        reg_ms = [host_ms(lambda: batched.register_batch(src, dst, intr, cfg)),
                  host_ms(lambda: sharded.register_batch_point_sharded(mesh, src, dst, intr, cfg)),
                  host_ms(lambda: batched.register_batch_sharded(mesh, src, dst, intr, cfg)),
                  host_ms(lambda: batched.register_batch(src, dst, intr, cfg))]
        def profiled(fn):
            """Launches, host syncs, device-to-host copies and the device's
            busy share of one call of fn, from a profiler trace."""
            fn()
            torch.cuda.synchronize()
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            events = prof.events()
            device = sorted((e.time_range.start, e.time_range.end) for e in events
                            if e.device_type == torch.autograd.DeviceType.CUDA)
            busy, end = 0.0, float("-inf")
            for a, b in device:
                busy += max(0.0, b - max(a, end))
                end = max(end, b)
            return {"launches": sum(e.name.startswith("cudaLaunchKernel") for e in events),
                    "syncs": sum("Synchronize" in e.name for e in events),
                    "dtoh": sum("DtoH" in e.name or "Device -> Host" in e.name for e in events),
                    "busy_share": busy / wall_us}

        registration = {"pairs": n_pairs, "point_sharded_twist_gap": pt_gap, "data_parallel_twist_gap": dp_gap,
                        "host_ms_per_call": {"register_batch": (reg_ms[0] + reg_ms[3]) / 2,
                                             "point_sharded": reg_ms[1], "data_parallel": reg_ms[2]},
                        "profiled": {"register_batch": profiled(lambda: batched.register_batch(src, dst, intr, cfg)),
                                     "point_sharded": profiled(
                                         lambda: sharded.register_batch_point_sharded(mesh, src, dst, intr, cfg))},
                        "data_parallel_bit_identical": bool(torch.equal(res_dp.transform, ref.transform)),
                        "truth_twist_gap": truth_gap, "launches_point_sharded": pt_launches,
                        "launches_data_parallel": dp_launches}

        # -- the collectives, timed: one inner step's all-reduce (64 pairs x
        # 45 floats), and the slab gathers of the raycast below.
        row = torch.zeros((n_pairs, 45), device=dev)
        point_group = mesh.get_group("point")
        allreduce_ms = ctx.time_ms(lambda: dist.all_reduce(row, group=point_group), 200)

        # -- sharded TSDF: 128^3 x 4 cm and 512^3 x 1 cm (1 GB of tsdf+weight)
        eye = se3.identity(device=dev)
        depth = synthetic.render_depth(intr, eye, synthetic.default_scene(seed=0, device=dev))
        tsdf_cases = []
        for v in (128, 512):
            vcfg = tsdf_mod.sized_config(resolution=v, voxel_size=5.12 / v)
            vol = tsdf_sharded.init_volume_sharded(vcfg, mesh)
            whole = tsdf_mod.init_volume(vcfg, device=dev)
            ctx.reset_counts()
            tsdf_sharded.integrate(vol, depth, eye, intr, vcfg)
            ctx.check_counts(ctx.read_counts(), f"multidevice integrate {v}^3", 0, 0, 0, integrates=1)
            tsdf_mod.integrate(whole, depth, eye, intr, vcfg)
            local, x0 = tsdf_sharded.local_slab(vol)
            check(x0 == 0 and torch.equal(local.tsdf, whole.tsdf) and torch.equal(local.weight, whole.weight),
                  f"multidevice: sharded integrate at {v}^3 differs from the unsharded volume")
            ctx.reset_counts()
            r_sh = tsdf_sharded.raycast(vol, eye, intr, vcfg)
            ctx.check_counts(ctx.read_counts(), f"multidevice raycast {v}^3", 0, 0, 0, raycasts=1, planes=0)
            r_ref = tsdf_mod.raycast(whole, eye, intr, vcfg)
            torch.cuda.synchronize()
            hit = r_ref > 0
            r_gap = (r_sh - r_ref).abs().max().item()
            check(torch.equal(r_sh > 0, hit) and r_gap <= 1e-5, f"multidevice: raycast at {v}^3 gap {r_gap}")
            field_local = tsdf_mod.march_field(local)
            gather_ms = ctx.time_ms(lambda f=field_local: mesh_mod.all_gather(f, mesh, "data"), 20)
            tsdf_cases.append({"volume": v, "voxel_m": 5.12 / v, "observed_voxels": int((whole.weight > 0).sum()),
                               "integrate_bit_identical": True, "raycast_max_abs_err": r_gap,
                               "raycast_hits": int(hit.sum()), "gather_bytes": field_local.numel() * 4,
                               "all_gather_ms": gather_ms,
                               "all_gather_GBps": field_local.numel() * 4 / gather_ms / 1e6})
            del vol, whole, local, field_local

        # -- serving: 8 producers x 30 u16 640x480 frames, slots over the mesh
        n_sessions, n_frames = 8, 30
        walks = [synthetic.render_trajectory(intr, n_frames, seed=40 + i, device=dev)[0] for i in range(n_sessions)]
        frames = [np.clip(w_.cpu().numpy() * 5000.0 + 0.5, 0, 65535).astype(np.uint16) for w_ in walks]

        def serve(mesh_):
            ex = BatchedExecutor(BatchingConfig(intrinsics=intr, capacity=n_sessions, depth_scale=2e-4, mesh=mesh_,
                                                request_timeout_s=300.0))
            try:
                trackers = [ex.make_session_tracker() for _ in range(n_sessions)]
                poses = np.zeros((n_sessions, n_frames, 4, 4), np.float32)
                errors = []

                def producer(i):
                    try:
                        for f in range(n_frames):
                            poses[i, f] = trackers[i].process(frames[i][f], f / 30.0).pose
                    except Exception as e:  # re-raised below on the main thread
                        errors.append(e)

                threads = [threading.Thread(target=producer, args=(i,)) for i in range(n_sessions)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=300)
                check(not errors and not any(th.is_alive() for th in threads), f"multidevice serving: {errors}")
                return poses, ex.stats()
            finally:
                ex.close()

        def timed_serve(mesh_):
            t0 = time.perf_counter()
            out = serve(mesh_)
            return out + (n_sessions * n_frames / (time.perf_counter() - t0),)

        # Frames/s in turns: unsharded, sharded (its launches counted),
        # sharded, unsharded.
        p_plain, _, fps_p1 = timed_serve(None)
        ctx.reset_counts()
        p_mesh, st_mesh, fps_m1 = timed_serve(mesh)
        got = ctx.read_counts()
        d_n = st_mesh["dispatches"]
        ctx.check_counts(got, "multidevice serving", levels * (d_n + 1), rounds * d_n, d_n + 1)
        check(st_mesh["errors"] == 0 and st_mesh["frames"] == n_sessions * n_frames, f"multidevice: {st_mesh}")
        p_mesh2, _, fps_m2 = timed_serve(mesh)
        _, _, fps_p2 = timed_serve(None)
        serve_gap = float(max(np.abs(p_mesh - p_plain).max(), np.abs(p_mesh2 - p_plain).max()))
        check(serve_gap <= 1e-6, f"multidevice: sharded executor poses {serve_gap} from the unsharded executor's")
        serving = {"sessions": n_sessions, "frames": n_frames, "dispatches": d_n, "mean_batch": st_mesh["mean_batch"],
                   "frames_per_s": [fps_m1, fps_m2], "unsharded_frames_per_s": [fps_p1, fps_p2],
                   "pose_max_abs_diff_vs_unsharded": serve_gap, "launches": got}

        # -- optimize_atlas(mesh=...) on phase 17's loop atlas ---------------
        t0 = time.perf_counter()
        loops = submaps_mod.optimize_atlas(ctx.atlas["before"], mesh=mesh)
        atlas_ms = (time.perf_counter() - t0) * 1e3
        atlas_gap = float(max(np.abs(np.asarray(a) - b).max()
                              for a, b in zip(ctx.atlas["before"].trajectory.poses, ctx.atlas["poses"])))
        check(loops == ctx.atlas["loops"] and atlas_gap <= 1e-6,
              f"multidevice: optimize_atlas(mesh) {loops} edges (unsharded {ctx.atlas['loops']}), gap {atlas_gap}")
        atlas = {"loops": loops, "trajectory_max_abs_diff_vs_unsharded": atlas_gap, "ms": atlas_ms}
    finally:
        dist.destroy_process_group()

    # -- the dry run: its own rank process, its own NCCL group ---------------
    t0 = time.perf_counter()
    dry = dryrun_multichip(1)
    dry["wall_s"] = time.perf_counter() - t0
    emit("multidevice", world_size=1, backend="nccl", mesh=[1, 1], registration=registration, tsdf=tsdf_cases,
         serving=serving, optimize_atlas=atlas, dryrun=dry,
         collectives={"all_reduce_ms": allreduce_ms, "all_reduce_bytes": row.numel() * 4,
                      "all_gather_ms": {c["volume"]: c["all_gather_ms"] for c in tsdf_cases}},
         phase_s=time.perf_counter() - t_phase, card=card)


def kernel_alone_phase(ctx) -> None:
    """Phase 27: the backbone, the raycast and the integrate timed alone on
    the card, each one's calls captured in one CUDA graph and replayed
    between two events (a small kernel's events otherwise time its
    launches): factor and apply at n = 64 and 1000 in turns with the
    previous chain, the full march and the coarse-to-fine refine march at
    640x480 into 128^3 (of the planes, in turns with the march of the
    field), a 512^3 coarse-to-fine render by its planes in turns with the
    field built and marched, and the integrate at 128^3 and 512^3 in turns
    with its previous design, its tile map alone and with the cull. Last of the
    phases, so that no graph runs before a profiler window. ctx: dev, card,
    graph_ms, intr."""
    import torch

    from realsensetracker_tpu_torch.data import synthetic
    from realsensetracker_tpu_torch.geometry import se3
    from realsensetracker_tpu_torch.kernels import backbone
    from realsensetracker_tpu_torch.kernels import tsdf as tsdf_kernels
    from realsensetracker_tpu_torch.mapping import tsdf as tsdf_mod
    from realsensetracker_tpu_torch.optimize import pose_graph as pg

    dev, intr = ctx.dev, ctx.intr
    prev = previous_backbone()
    rows = {}
    for n, (laps, per, kw) in ((64, (2, 32, {"loop_every": 4})), (1000, (5, 200, {}))):  # phase 10's graphs
        _, est, loops = synthetic.lap_graph(laps, per, seed=3, **kw)
        graph = pg.from_trajectory(est, loop_edges=loops, device=dev)
        zero = torch.zeros((n, 6), dtype=torch.float32, device=dev)
        r_edges = pg._edge_residuals(zero, graph)
        w_rob = pg.robust_weights(r_edges, 0.1, use_gm=False)
        J = pg.edge_jacobians(graph, graph.poses, graph.weights * w_rob)
        D, O = pg.backbone_blocks(graph, J, n, torch.full((), 1e-6, device=dev))
        r = -pg.gradient(J, graph, (r_edges * w_rob[:, None]).reshape(-1), n)
        S, U = backbone.backbone_factor(D, O)
        S_old, U_old = prev.chain_factor(D, O)
        ms = {}
        for name in ("previous", "kernel", "kernel", "previous"):
            fac = (lambda: prev.chain_factor(D, O)) if name == "previous" else (lambda: backbone.backbone_factor(D, O))
            app = (lambda: prev.chain_apply(S_old, U_old, r)) if name == "previous" else (
                lambda: backbone.backbone_apply(S, U, r))
            ms.setdefault(f"{name}_factor", []).append(ctx.graph_ms(fac, 10))
            ms.setdefault(f"{name}_apply", []).append(ctx.graph_ms(app, 50))
        rows[f"backbone_n{n}"] = {k: sum(v) / len(v) for k, v in ms.items()}

    cfg = tsdf_mod.TsdfConfig()
    depths, _, poses = synthetic.render_trajectory_rgbd(intr, 10, seed=0, device=dev)
    vol = tsdf_mod.init_volume(cfg, device=dev)
    for i in range(depths.shape[0]):
        tsdf_mod.integrate(vol, depths[i], poses[i], intr, cfg)
    field, T, it = tsdf_mod.march_field(vol), poses[-1], cfg.subvoxel_iters
    dc = tsdf_kernels.march(field, T, tsdf_mod.coarse_intrinsics(intr, 4), cfg, cfg.num_steps)
    z0, seeded = tsdf_mod.coarse_seeds(dc, 4, cfg)
    cases = {"full": ((T, intr, cfg, cfg.num_steps), dict(subvoxel_iters=it)),
             "fine": ((T, intr, cfg, cfg.refine_steps), dict(z_start=z0, gate=seeded, subvoxel_iters=it))}
    for case, (a, kw) in cases.items():  # the march of the planes (the renders'), of the field in turns
        ms = {}
        for name in ("field", "kernel", "kernel", "field"):
            source = vol if name == "kernel" else field
            ms.setdefault(name, []).append(ctx.graph_ms(lambda: tsdf_kernels.march(source, *a, **kw), 20))
        rows[f"raycast_{case}_128"] = {k: sum(v) / len(v) for k, v in ms.items()}

    # A whole 512^3 render of the benchmark's KinectFusion configuration
    # (trunc 0.1 m, coarse-to-fine x4), the last frame's pose, both ways in
    # turns: the march field built and marched twice (the route a sharded
    # volume keeps), and the two marches of the planes (render_model_depth).
    cfg512 = tsdf_mod.sized_config(resolution=512, voxel_size=0.01)._replace(trunc=0.1, raycast_coarse=4)
    vol512 = tsdf_mod.init_volume(cfg512, device=dev)
    for i in range(depths.shape[0]):
        tsdf_mod.integrate(vol512, depths[i], poses[i], intr, cfg512)

    def render_by_field():
        f = tsdf_mod.march_field(vol512)
        dc_ = tsdf_kernels.march(f, T, tsdf_mod.coarse_intrinsics(intr, 4), cfg512, cfg512.num_steps)
        z_c, gate_c = tsdf_mod.coarse_seeds(dc_, 4, cfg512)
        return tsdf_kernels.march(f, T, intr, cfg512, cfg512.refine_steps, z_start=z_c, gate=gate_c,
                                  subvoxel_iters=cfg512.subvoxel_iters)

    def render_by_planes():
        return tsdf_mod.render_model_depth(vol512, T, intr, cfg512)

    check(torch.equal(render_by_field(), render_by_planes()), "kernel_alone: the 512^3 render differs by its source")
    ms = {}
    for name in ("field", "planes", "planes", "field"):
        ms.setdefault(name, []).append(ctx.graph_ms(render_by_field if name == "field" else render_by_planes, 10))
    rows["render_512"] = {**{k: sum(v) / len(v) for k, v in ms.items()}, "runs": ms,
                          "field_build": ctx.graph_ms(lambda: tsdf_mod.march_field(vol512), 10)}
    del vol512

    # The integrate (tile map, cull, update) in turns with its previous
    # design (one thread per voxel of the grid), the last frame into the
    # volume phase 13 timed, at 128^3 and 512^3; the tile map alone and with
    # the cull.
    flat = previous_integrate()
    pcw = se3.inverse(T).contiguous()
    d, h, w = depths[-1], intr.height, intr.width
    for cfg_ in (cfg, tsdf_mod.sized_config(resolution=512, voxel_size=0.01)):
        vol_ = vol if cfg_ is cfg else tsdf_mod.init_volume(cfg_, device=dev)
        if cfg_ is not cfg:
            for i in range(depths.shape[0]):
                tsdf_mod.integrate(vol_, depths[i], poses[i], intr, cfg_)
        reps = 50 if cfg_ is cfg else 10
        ms = {}
        for name in ("previous", "kernel", "kernel", "previous"):
            run = (lambda: flat(vol_, d, pcw, intr, cfg_)) if name == "previous" else (
                lambda: tsdf_kernels.fuse_block(vol_, d, None, pcw, intr, cfg_))
            ms.setdefault(name, []).append(ctx.graph_ms(run, reps))
        count = torch.empty((1,), dtype=torch.int32, device=dev)
        tiles = tsdf_kernels.depth_tiles(d[None], cfg_, count)
        rows[f"integrate_{cfg_.resolution}"] = {
            **{k: sum(v) / len(v) for k, v in ms.items()}, "runs": ms,
            "tile_map": ctx.graph_ms(lambda: tsdf_kernels.depth_tiles(d[None], cfg_, count), 50),
            "tile_map_and_cull": ctx.graph_ms(lambda: (tsdf_kernels.depth_tiles(d[None], cfg_, count),
                                                       tsdf_kernels.cull_bricks(pcw[None], tiles, count, intr, cfg_,
                                                                                h, w)), 50)}
        del vol_
    emit("kernel_alone", rows=rows, card=ctx.card)
    return rows


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card")

    from realsensetracker_tpu_torch.align import projective, robust_global
    from realsensetracker_tpu_torch.align.rgbd import RgbdIcpConfig
    from realsensetracker_tpu_torch.api import AlignConfig, Tracker, TrackerConfig
    from realsensetracker_tpu_torch.data import synthetic
    from realsensetracker_tpu_torch.geometry import camera, se3
    from realsensetracker_tpu_torch.kernels import backbone, build, downsample, gn_step, level_kernel
    from realsensetracker_tpu_torch.kernels import tsdf as tsdf_kernels
    from realsensetracker_tpu_torch.models import get_pipeline
    from realsensetracker_tpu_torch.ops import correspond, fpfh, pyramid, voxel
    from realsensetracker_tpu_torch.ops.cloud import Cloud
    from realsensetracker_tpu_torch.parallel import batched
    from realsensetracker_tpu_torch.tracking import trajectory
    from realsensetracker_tpu_torch.tracking.frame_to_model import frame_cloud
    from realsensetracker_tpu_torch.tracking.keyframe_rgbd import RgbdKeyframeTracker

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 1. device -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    emit(
        "device", card=card, count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, capability=list(torch.cuda.get_device_capability(0)),
    )

    intr = camera.TUM_FR1
    cfg = projective.ProjectiveIcpConfig()
    num_levels = len(cfg.iters)
    rounds = sum(cfg.iters)  # association rounds per registration
    level_intrs = pyramid.level_intrinsics(intr, num_levels)
    level_samples = [max(cfg.samples // cfg.coarse_sample_divisor**li, cfg.min_samples) for li in range(num_levels)]
    scene = synthetic.default_scene(seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def levels_of(depth):
        """Masked depth of each pyramid level, as build_pyramid feeds it to the kernel."""
        valid = camera.valid_mask(depth, cfg.min_depth, cfg.max_depth)
        d = torch.where(valid, depth, 0.0)
        out = []
        for _ in range(num_levels):
            out.append(d.contiguous())
            d, valid = pyramid.downsample_depth(d, valid)
        return out

    # Launch counts: each main path runs with every count at 0 and is read
    # just after; main_launches sums the main paths for the kernels line.
    main_launches = dict.fromkeys(KERNELS, 0)

    def reset_counts():
        downsample.LAUNCHES = 0
        level_kernel.LAUNCHES = 0
        for k in gn_step.LAUNCHES:
            gn_step.LAUNCHES[k] = 0
        for k in backbone.LAUNCHES:
            backbone.LAUNCHES[k] = 0
        for k in tsdf_kernels.LAUNCHES:
            tsdf_kernels.LAUNCHES[k] = 0

    def read_counts():
        torch.cuda.synchronize()
        got = {"downsample_levels": downsample.LAUNCHES, "build_level_packed": level_kernel.LAUNCHES,
               **gn_step.LAUNCHES, "backbone": sum(backbone.LAUNCHES.values()), **tsdf_kernels.LAUNCHES}
        for k, v in got.items():
            if k in main_launches:  # tsdf_raycast_planes: a part of tsdf_raycast
                main_launches[k] += v
        return got

    def check_counts(got, what, levels, gn_rounds, pyramids, systems=0, backbones=0, integrates=0, raycasts=0,
                     planes=None):
        """levels: level-kernel launches; gn_rounds: association rounds;
        pyramids: downsample launches (one per pyramid or source-level set);
        systems: gn_system launches (joint RGB-D steps); backbones: backbone
        factor + apply launches; integrates: TSDF integrates (each one
        tile-map, one cull and one brick launch, whatever its slots);
        raycasts: raycast-march launches; planes: those of them that read a
        volume's planes (None: all, as every render of a whole volume on
        the card does)."""
        want = {"downsample_levels": pyramids, "build_level_packed": levels, "gn_round": gn_rounds,
                "gn_system": systems, "backbone": backbones, "tsdf_depth_tiles": integrates, "tsdf_cull": integrates,
                "tsdf_integrate": integrates, "tsdf_raycast": raycasts,
                "tsdf_raycast_planes": raycasts if planes is None else planes}
        check(got == want, f"{what}: launches {got}, expected {want}")

    def bound(nbytes, flops):
        """(ms, what bounds it): the least time of the card for the work."""
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")

    # ---- 2. build the kernels, one nvcc each, together -------------------
    sources = (downsample.SOURCE, level_kernel.SOURCE, gn_step.SOURCE, backbone.SOURCE, *tsdf_kernels.SOURCES,
               PREVIOUS_BACKBONE, PREVIOUS_INTEGRATE)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        list(pool.map(build.build, sources))
    build_s = time.perf_counter() - t0
    ptxas = {}
    for src in sources:
        log = (build.library_path(src).parent / "build.log").read_text()
        ptxas[src] = [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln or "Compiling entry function" in ln]
    emit("build", seconds=build_s, ptxas=ptxas)

    def holes(d, frac=0.05):
        mask = torch.rand(d.shape, generator=gen, device=dev) < frac
        return torch.where(mask, 0.0, d).contiguous()

    # ---- 2b. downsample kernel vs plain version --------------------------
    ds_worst = {"ulps": 0, "abs": 0.0}

    def compare_downsample(d, levels):
        got = downsample.downsample_levels(d, levels, cfg.min_depth)
        ref = downsample.downsample_levels_reference(d, levels)
        torch.cuda.synchronize()
        check(len(got) == len(ref) == levels - 1, f"downsample at {tuple(d.shape)}: {len(got)} levels")
        ulps, err = 0, 0.0
        for (gd, gv), (rd, rv) in zip(got, ref):
            check(torch.equal(gv, rv), f"downsample at {tuple(d.shape)} L={levels}: validity differs")
            if gd.numel():
                ulps = max(ulps, (gd.view(torch.int32) - rd.view(torch.int32)).abs().max().item())
                err = max(err, (gd - rd).abs().max().item())
        check(ulps <= ULP_BAR, f"downsample at {tuple(d.shape)} L={levels}: {ulps} ulp > {ULP_BAR}")
        ds_worst["ulps"], ds_worst["abs"] = max(ds_worst["ulps"], ulps), max(ds_worst["abs"], err)
        return {"shape": list(d.shape), "levels": levels, "max_ulps": ulps, "max_abs_err": err}

    poses4 = se3.exp(0.02 * torch.randn((4, 6), generator=gen, device=dev))
    frames4 = torch.stack([synthetic.render_depth(intr, T, scene) for T in poses4])
    ds_cases = []
    for d in levels_of(frames4):
        for levels in ((2, 3, 4) if d.shape[-1] == intr.width else (2,)):
            ds_cases.append(compare_downsample(holes(d), levels))
    for h, w, f in ((482, 64, 60.0), (36, 128, 50.0)):
        odd = camera.Intrinsics(fx=f, fy=f, cx=(w - 1) / 2, cy=(h - 1) / 2, width=w, height=h)
        d = torch.stack([synthetic.render_depth(odd, T, scene) for T in poses4])
        for levels in (2, 3, 4):
            ds_cases.append(compare_downsample(holes(levels_of(d)[0]), levels))
    emit("downsample_kernel", ulp_bar=ULP_BAR, worst=ds_worst, cases=ds_cases)

    # ---- 3. level kernel vs plain version --------------------------------
    max_err = 0.0

    def compare(d, li):
        nonlocal max_err
        got = level_kernel.build_level_packed(d, li)
        ref = level_kernel.build_level_packed_reference(d, li)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        same_valid = torch.equal(got[:, :3].abs().sum(1) > 0, ref[:, :3].abs().sum(1) > 0)
        max_err = max(max_err, err)
        check(err <= ATOL, f"kernel vs plain at {tuple(d.shape)}: max abs err {err} > {ATOL}")
        check(same_valid, f"kernel vs plain at {tuple(d.shape)}: validity pattern differs")
        return {"shape": list(d.shape), "max_abs_err": err, "valid_frac": (ref[:, 2] != 0).float().mean().item()}

    cases = [compare(holes(d), li) for d, li in zip(levels_of(frames4), level_intrs)]
    odd_shapes = []
    for h, w, f in ((482, 64, 60.0), (36, 128, 50.0)):
        odd = camera.Intrinsics(fx=f, fy=f, cx=(w - 1) / 2, cy=(h - 1) / 2, width=w, height=h)
        d = torch.stack([synthetic.render_depth(odd, T, scene) for T in poses4])
        odd_shapes.append((odd, d))
        cases.append(compare(holes(levels_of(d)[0]), odd))
    emit("kernel", atol=ATOL, cases=cases)

    # ---- 4. GN round vs plain version ------------------------------------
    gn_err = 0.0  # worst abs error of a pose entry

    def same_round(a, b):
        return torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))

    def compare_gn(T, pts, ok, packed, li):
        nonlocal gn_err
        p = pts.shape[-1]
        shape = f"B={T.shape[0]} {packed.shape[-2]}x{packed.shape[-1]} P={p}"
        rows = []
        for inner in (1, 2, 3):
            cfg_i = cfg._replace(inner_iters=inner)
            got = gn_step.gn_round(T, pts, ok, packed, li, cfg_i)
            again = gn_step.gn_round(T, pts, ok, packed, li, cfg_i)
            alone = gn_step.gn_round(T[1:2], pts[1:2], ok[1:2], packed[1:2], li, cfg_i)
            T_ref, (rmse_ref, _, count_ref) = gn_step.gn_round_reference(T, pts, ok, packed, li, cfg_i)
            torch.cuda.synchronize()
            T_got, (rmse, _, count) = got
            what = f"gn_round at {shape} inner_iters={inner}"
            check(same_round(again, got), f"{what}: a second launch differs")
            check(same_round(alone, (T_got[1:2], tuple(x[1:2] for x in got[1]))), f"{what}: pair 1 depends on B")
            check(bool(torch.isfinite(T_got).all()), f"{what}: non-finite poses")
            twist = se3.log(se3.compose(se3.inverse(T_ref), T_got)).abs().max().item()
            dcount = (count - count_ref).abs().max().item()
            rmse_gap = (rmse - rmse_ref).abs()
            check(twist <= GN_TWIST_BAR, f"{what}: twist {twist} > {GN_TWIST_BAR}")
            check(dcount <= GN_COUNT_BAR * p, f"{what}: matched count off by {dcount}")
            check(bool((rmse_gap <= GN_RMSE_BAR * rmse_ref).all()), f"{what}: rmse {rmse} vs {rmse_ref}")
            err = (T_got - T_ref).abs().max().item()
            gn_err = max(gn_err, err)
            rows.append({"inner_iters": inner, "twist_err": twist, "pose_max_abs_err": err, "count_diff": dcount,
                         "rmse_rel": (rmse_gap / rmse_ref.clamp_min(1e-30)).max().item(),
                         "matched": count_ref.tolist()})
        return {"shape": shape, "rounds": rows}

    def gn_inputs(dst_depth, src_depth, li, count, T):
        packed = level_kernel.build_level_packed(holes(dst_depth), li)
        pts, ok = projective.sample_depth_points(holes(src_depth), li, count)
        return T.contiguous(), pts.transpose(1, 2).contiguous(), ok.contiguous(), packed

    moved = se3.exp(0.01 * torch.randn((4, 6), generator=gen, device=dev))
    src4 = torch.stack([synthetic.render_depth(intr, T, scene) for T in se3.compose(poses4, moved)])
    gn_cases = [
        compare_gn(*gn_inputs(dd, ds, li, count, moved), li)
        for dd, ds, li, count in zip(levels_of(frames4), levels_of(src4), level_intrs, level_samples)
    ]
    odd, d_odd = odd_shapes[0]
    d_src = torch.stack([synthetic.render_depth(odd, T, scene) for T in se3.compose(poses4, moved)])
    gn_cases.append(compare_gn(*gn_inputs(levels_of(d_odd)[0], levels_of(d_src)[0], odd, 2048, moved), odd))
    cap = gn_step.REGISTER_POINTS  # four points per thread
    gn_cases.append(compare_gn(*gn_inputs(levels_of(frames4)[0], levels_of(src4)[0], intr, cap, moved), intr))
    emit("gn_kernel", bars={"twist": GN_TWIST_BAR, "count_of_P": GN_COUNT_BAR, "rmse_rel": GN_RMSE_BAR},
         cases=gn_cases)

    # ---- 4b. gn_round above the register path ----------------------------
    large = [compare_gn(*gn_inputs(levels_of(frames4)[0], levels_of(src4)[0], intr, p, moved), intr)
             for p in (cap + 1, 2 * cap)]
    emit("gn_round_large", bars={"twist": GN_TWIST_BAR, "count_of_P": GN_COUNT_BAR, "rmse_rel": GN_RMSE_BAR},
         cases=large)

    # ---- 5. batched registration (main path) -----------------------------
    scale = torch.tensor([0.02, 0.02, 0.02, 0.015, 0.015, 0.015], device=dev)
    twists = (2 * torch.rand((64, 6), generator=gen, device=dev) - 1) * scale
    twists[0] = 0.0  # one identity pair
    truth = se3.exp(twists)
    dst = synthetic.render_depth(intr, se3.identity(device=dev), scene)[None].expand(64, -1, -1).contiguous()
    src = torch.stack([synthetic.render_depth(intr, T, scene) for T in truth])

    def twist_errors(T_est, T_true):
        err = se3.log(se3.compose(se3.inverse(T_true), T_est)).abs()
        return err[:, :3].amax(-1), err[:, 3:].amax(-1)

    def check_twists(res, T_true, identity_rows, what, motion_bar=TWIST_BAR_MOTION):
        t_err, r_err = twist_errors(res.transform, T_true)
        worst = torch.maximum(t_err, r_err)
        check(bool(torch.isfinite(res.transform).all()), f"{what}: non-finite transforms")
        check(worst[identity_rows].max().item() < TWIST_BAR_IDENTITY, f"{what}: identity pairs off")
        check(worst.max().item() < motion_bar, f"{what}: twist error {worst.max().item()}")
        return {"t_err_max": t_err.max().item(), "r_err_max": r_err.max().item(),
                "identity_err_max": worst[identity_rows].max().item(),
                "pairs_within_3e-3": int((worst < TWIST_BAR_MOTION).sum().item()),
                "inlier_fraction_min": res.inlier_fraction.min().item(),
                "rmse_max": res.rmse.max().item()}

    reset_counts()
    res64 = batched.register_batch(src, dst, intr, cfg)
    check_counts(read_counts(), "register_batch", num_levels, rounds, 2)
    acc64 = check_twists(res64, truth, torch.tensor([0]), "register_batch B=64")

    reps = 16
    src_big, dst_big, truth_big = src.repeat(reps, 1, 1), dst.repeat(reps, 1, 1), truth.repeat(reps, 1, 1)
    chunk = 512
    chunks = src_big.shape[0] // chunk
    reset_counts()
    res_big = batched.register_batch_chunked(src_big, dst_big, intr, cfg, chunk=chunk)
    chunk_launches = read_counts()
    check_counts(chunk_launches, "register_batch_chunked", num_levels * chunks, rounds * chunks, 2 * chunks)
    for i in range(0, src_big.shape[0], chunk):
        part = batched.register_batch(src_big[i : i + chunk], dst_big[i : i + chunk], intr, cfg)
        for a, b in zip(res_big, part):
            check(torch.equal(a[i : i + chunk], b), f"chunk at {i} differs from register_batch")
    acc_big = check_twists(res_big, truth_big, torch.arange(0, 1024, 64), "register_batch_chunked B=1024")
    emit("register", pairs=64, accuracy_64=acc64, chunked_pairs=1024, chunk=chunk,
         chunked_launches=chunk_launches, accuracy_1024=acc_big,
         bars={"identity": TWIST_BAR_IDENTITY, "motion": TWIST_BAR_MOTION})

    # ---- 6. normal-space registration (main path) ------------------------
    # The JAX reference misses the 3e-3 motion bar in this mode (it takes
    # the head of each orientation bin's raster-order segment; ROADMAP
    # section 3): its worst twist error on pairs like these is ~2e-2 (CPU).
    # So the CUDA run is held to the identity bar, to the same code on CPU
    # within the JAX parity bar, and to 5e-2 against the truth.
    ns_cfg = cfg._replace(sample_mode="normal_space")
    reset_counts()
    res_ns = batched.register_batch(src, dst, intr, ns_cfg)
    check_counts(read_counts(), "register normal_space", 2 * num_levels, rounds, 2)
    acc_ns = check_twists(res_ns, truth, torch.tensor([0]), "normal_space B=64", motion_bar=5e-2)
    n_cpu = 8
    ref_ns = batched.register_batch(src[:n_cpu].cpu(), dst[:n_cpu].cpu(), intr, ns_cfg)
    vs_cpu = (se3.log(res_ns.transform[:n_cpu].cpu()) - se3.log(ref_ns.transform)).abs().max().item()
    check(vs_cpu <= TWIST_BAR_CPU, f"normal_space: CUDA vs CPU twist {vs_cpu} > {TWIST_BAR_CPU}")
    emit("register_normal_space", pairs=64, accuracy=acc_ns, cpu_pairs=n_cpu, twist_vs_cpu_max=vs_cpu,
         bars={"identity": TWIST_BAR_IDENTITY, "vs_cpu": TWIST_BAR_CPU, "motion": 5e-2})

    # ---- 6b. device kernels and busy share of one projective_icp_sampled -
    def icp_inputs(src_d, dst_d):
        dst_levels, intrs = pyramid.build_pyramid(dst_d, intr, num_levels, cfg.min_depth, cfg.max_depth)
        samples = [projective.sample_depth_points(dl, intrs[li], count, cfg.min_depth, cfg.max_depth)
                   for li, (dl, count) in enumerate(zip(levels_of(src_d), level_samples))]
        return samples, dst_levels, tuple(intrs)

    def profile_icp(samples, dst_levels, intrs):
        """Device kernels of one call (its kernel launches, from the runtime
        API records), gn_round launches and their traced device times (one
        per round, coarse to fine), and the device's busy share: the union
        of the traced kernel and copy intervals over the host time from the
        call to its synchronize, profiler on."""
        run = lambda: projective.projective_icp_sampled(samples, dst_levels, intrs, None, cfg)  # noqa: E731
        run()
        torch.cuda.synchronize()
        launched = gn_step.LAUNCHES["gn_round"]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        launched = gn_step.LAUNCHES["gn_round"] - launched
        check(bool(torch.isfinite(res.transform).all()), "gn_profile: non-finite transforms")
        events = prof.events()
        api = sum(e.name.startswith("cudaLaunchKernel") for e in events)
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels = [e for e in device if not e.name.startswith(("Memcpy", "Memset"))]
        gn_us = [e.time_range.elapsed_us() for e in kernels if "gn_round" in e.name]
        busy, end = 0.0, float("-inf")
        for a, b in sorted((e.time_range.start, e.time_range.end) for e in device):
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        return {"batch": samples[0][0].shape[0], "device_kernels": api, "kernels_traced": len(kernels),
                "copies_traced": len(device) - len(kernels), "gn_round_launches": launched,
                "gn_round_traced": len(gn_us), "gn_round_device_us_per_launch": gn_us,
                "device_busy_ms": busy / 1e3, "host_ms": wall_us / 1e3, "busy_share": busy / wall_us}

    icp_profiles = [profile_icp(*icp_inputs(src_big[:chunk], dst_big[:chunk])),
                    profile_icp(*icp_inputs(src_big[:1], dst_big[:1]))]
    emit("gn_profile", max_kernels=MAX_KERNELS_PER_ICP, calls=icp_profiles, card=card)
    for prof_ in icp_profiles:
        what = f"gn_profile B={prof_['batch']}"
        check(prof_["gn_round_launches"] == rounds, f"{what}: {prof_['gn_round_launches']} gn_round launches")
        check(prof_["kernels_traced"] <= prof_["device_kernels"] <= MAX_KERNELS_PER_ICP,
              f"{what}: {prof_['device_kernels']} device kernels ({prof_['kernels_traced']} traced)")

    # ---- 7. tracker facade (main path) -----------------------------------
    depths, poses_gt = synthetic.render_trajectory(intr, 30, seed=0, device=dev)
    tracker = Tracker(TrackerConfig(intrinsics=intr, method="projective", device="cuda"))
    reset_counts()
    results, frame_ms = [], []
    for i in range(depths.shape[0]):
        t0 = time.perf_counter()
        results.append(tracker.process(depths[i], float(i)))  # ends in a host transfer
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    tracker_launches = read_counts()
    check_counts(tracker_launches, "tracker", num_levels * len(results), rounds * (len(results) - 1), len(results))

    def ate_of(traj, poses):
        gt = trajectory.Trajectory()
        for i, T in enumerate(poses.cpu().numpy()):
            gt.append(float(i), T)
        return trajectory.absolute_trajectory_error(traj, gt)

    ate = ate_of(tracker.trajectory, poses_gt)
    check(all(r.success for r in results), "tracker: a frame failed")
    check(ate["rmse"] < ATE_BAR, f"tracker: ATE rmse {ate['rmse']} >= {ATE_BAR}")
    emit("tracker", frames=len(results), ate_rmse=ate["rmse"], ate_max=ate["max"],
         launches=tracker_launches, host_ms_per_frame_median=statistics.median(frame_ms[1:]),
         host_ms_per_frame_max=max(frame_ms[1:]), card=card)

    # ---- 8. keyframe tracker (main path), the bench.py:37-100 workload ----
    window, n_windows = 8, 11
    total = window * n_windows
    kf_depths, kf_poses = synthetic.render_trajectory(
        intr, total, scene=synthetic.default_scene(seed=5, device=dev), seed=3, step_scale=0.004
    )
    rng = np.random.RandomState(11)
    frames = []  # u16 millimetres with +-2 mm integer noise: every frame's bytes differ
    for d in kf_depths.cpu().numpy():
        mm = np.clip(d * 1000.0, 0, 65000).astype(np.int32)
        frames.append(np.where(mm > 0, mm + rng.randint(-2, 3, size=mm.shape), 0).astype(np.uint16))
    kf_cfg = TrackerConfig(intrinsics=intr, method="keyframe", depth_scale=1e-3, device="cuda")
    warm = Tracker(kf_cfg)  # library initialisation, outside every count and time
    warm.process_window(frames[:window], window=window)
    warm.process(frames[window])

    # The two modes take turns, one window of frames each, so that host
    # noise falls on both alike; every turn starts with the counts at 0.
    per_frame, windowed = Tracker(kf_cfg), Tracker(kf_cfg)
    pf_res, win_res, pf_ms, win_ms = [], [], [], []
    pf_launches, win_launches = dict.fromkeys(KERNELS, 0), dict.fromkeys(KERNELS, 0)
    modes = (  # (run one window of frames, results, ms/frame per turn, launches)
        (lambda fs, ts: [per_frame.process(f, t) for f, t in zip(fs, ts)], pf_res, pf_ms, pf_launches),
        (lambda fs, ts: windowed.process_window(fs, ts, window=window), win_res, win_ms, win_launches),
    )
    for w in range(n_windows):
        chunk_frames = frames[w * window : (w + 1) * window]
        stamps = [float(j) for j in range(w * window, (w + 1) * window)]
        for run, results_, ms, launches in modes:
            reset_counts()
            t0 = time.perf_counter()
            results_ += run(chunk_frames, stamps)  # ends in a host transfer
            ms.append((time.perf_counter() - t0) * 1e3 / len(chunk_frames))
            for k, v in read_counts().items():
                launches[k] = launches.get(k, 0) + v
    check_counts(pf_launches, "keyframe per frame", num_levels * total, rounds * (total - 1), total)
    # The first window call seeds the keyframe with frame 0 and pads frames
    # 1-7 to 8 rows: one batched pyramid per window, one GN round per row.
    check_counts(win_launches, "keyframe windowed", num_levels * (1 + n_windows), rounds * total, 1 + n_windows)

    check(len(pf_res) == len(win_res) == total, "keyframe: a frame is missing")
    pose_diff = max(float(np.abs(a.pose - b.pose).max()) for a, b in zip(pf_res, win_res))
    for a, b in zip(pf_res, win_res):
        check(a.success == b.success and a.is_new_keyframe == b.is_new_keyframe
              and abs(a.rmse - b.rmse) < 1e-5 and abs(a.inlier_fraction - b.inlier_fraction) < 1e-5,
              f"keyframe: frame {a.frame_index} differs between process and process_window")
    check(pose_diff <= 1e-5, f"keyframe: poses differ by {pose_diff} between the modes")
    check(all(r.success for r in pf_res), "keyframe: a frame failed")
    kf_ate = [ate_of(t.trajectory, kf_poses) for t in (per_frame, windowed)]
    check(max(a["rmse"] for a in kf_ate) < ATE_BAR, f"keyframe: ATE {kf_ate}")

    # Device-to-host copies of one more window, from the profiler's trace.
    more = frames[:window]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        windowed.process_window(more, window=window)
        torch.cuda.synchronize()
    copies = {e.key: e.count for e in prof.key_averages() if "Memcpy" in e.key or "Synchronize" in e.key}
    dtoh = sum(n for k, n in copies.items() if "DtoH" in k)
    check(dtoh == 1, f"keyframe: {dtoh} device-to-host copies in one window ({copies})")
    emit("keyframe", frames=total, window=window, promotions=sum(r.is_new_keyframe for r in pf_res[1:]),
         ate_rmse_per_frame=kf_ate[0]["rmse"], ate_rmse_windowed=kf_ate[1]["rmse"],
         pose_diff_max=pose_diff, launches_per_frame=pf_launches, launches_windowed=win_launches,
         copies_and_syncs_per_window=copies,
         ms_per_frame_median=statistics.median(pf_ms[1:]),
         windowed_ms_per_frame_median=statistics.median(win_ms[1:]), card=card)

    # ---- 8b-8d. world map, frame-to-model, cloud ICP (main paths) ---------
    def twist_gap(a, b):
        """Max |twist| of a^-1 b over a stack of host poses."""
        a, b = torch.as_tensor(np.stack(a)), torch.as_tensor(np.stack(b))
        return se3.log(torch.linalg.inv(a) @ b).abs().max().item()

    def trace_calls(run, n):
        """Device-to-host copies and syncs per call over n calls of run(i),
        from a profiler trace, and the device ms per call."""
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                run(i)
            torch.cuda.synchronize()
        events = prof.key_averages()
        copies = {e.key: e.count / n for e in events if "Memcpy" in e.key or "Synchronize" in e.key}
        device_us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
                        for e in events)
        return copies, device_us / 1e3 / n

    def sync_sources(run):
        """The op each host sync and device-to-host copy of one call of run()
        comes from, from a CPU + CUDA trace: {"runtime call <- outermost aten
        op > ... > innermost": count}."""
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        out = {}
        for e in prof.events():
            if e.name not in ("cudaStreamSynchronize", "cudaMemcpyAsync", "cudaMemcpy"):
                continue
            chain, parent = [], e.cpu_parent
            while parent is not None:
                if parent.name.startswith("aten::"):
                    chain.append(parent.name)
                parent = parent.cpu_parent
            key = f"{e.name} <- {' > '.join(reversed(chain[-3:] if len(chain) > 3 else chain))}"
            out[key] = out.get(key, 0) + 1
        return out

    def trace_frame(tracker_, frames_):
        """trace_calls over tracker_.process of each of frames_."""
        return trace_calls(lambda i: tracker_.process(frames_[i]), len(frames_))

    def run_stream(cfg_, frames_):
        """(tracker, results, host ms per frame) with the counts reset just
        before and read just after, peak memory from the first frame on."""
        tracker_ = Tracker(cfg_)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        res_, ms_ = [], []
        for i, f in enumerate(frames_):
            t0 = time.perf_counter()
            res_.append(tracker_.process(f, float(i)))  # ends in a host transfer
            ms_.append((time.perf_counter() - t0) * 1e3)
        return tracker_, res_, ms_, read_counts(), torch.cuda.max_memory_allocated() / 1e9

    # 8b. The world map on the 30 frames of phase 7.
    map_cfg = TrackerConfig(intrinsics=intr, method="projective", map_capacity=65536, device="cuda")
    wm, wm_res, wm_ms, wm_launches, wm_peak = run_stream(map_cfg, depths)
    check_counts(wm_launches, "world_map", num_levels * len(wm_res), rounds * (len(wm_res) - 1), len(wm_res))
    wm_ate = ate_of(wm.trajectory, poses_gt)
    check(all(r.success for r in wm_res), "world_map: a frame failed")
    check(wm_ate["rmse"] < ATE_BAR, f"world_map: ATE rmse {wm_ate['rmse']} >= {ATE_BAR}")
    n_cpu_frames = 10
    wm_gpu10 = Tracker(map_cfg)
    wm_cpu10 = Tracker(TrackerConfig(intrinsics=intr, method="projective", map_capacity=65536, device="cpu"))
    for f in depths[:n_cpu_frames]:
        wm_gpu10.process(f)
        wm_cpu10.process(f.cpu())
    count_gpu, count_cpu = int(wm_gpu10.world_map.count().item()), int(wm_cpu10.world_map.count().item())
    check(abs(count_gpu - count_cpu) <= MAP_COUNT_BAR * count_cpu,
          f"world_map: {count_gpu} points after {n_cpu_frames} frames, the CPU run {count_cpu}")
    wm_copies, wm_dev_ms = trace_frame(wm, depths[:4])
    emit("world_map", frames=len(wm_res), ate_rmse=wm_ate["rmse"], map_points=int(wm.world_map.count().item()),
         map_points_10=count_gpu, map_points_10_cpu=count_cpu, launches=wm_launches,
         host_ms_per_frame_median=statistics.median(wm_ms[1:]), device_ms_per_frame=wm_dev_ms,
         copies_and_syncs_per_frame=wm_copies, peak_mem_GB=wm_peak, card=card)

    # 8c-8e. The cloud trackers: their NN search is a torch.matmul, GICP's
    # whitening a torch.linalg.eigh; no kernel of the port runs on these
    # paths.
    cloud_phases = (
        ("model", 20, lambda d: TrackerConfig(intrinsics=intr, method="model", device=d)),
        ("icp", 10, lambda d: TrackerConfig(intrinsics=intr, method="icp", device=d)),
        ("gicp", 10, lambda d: TrackerConfig(intrinsics=intr, method="gicp", device=d)),
    )
    model_depths, model_poses = synthetic.render_trajectory(intr, 20, seed=0, device=dev)
    for name, n_frames, make_cfg in cloud_phases:
        frames_ = model_depths[:n_frames]
        trk, res_, ms_, launches_, peak_ = run_stream(make_cfg("cuda"), frames_)
        check(all(n == 0 for n in launches_.values()), f"{name}: a kernel launched on a cloud path: {launches_}")
        check(all(r.success for r in res_), f"{name}: a frame failed")
        cpu_trk = Tracker(make_cfg("cpu"))
        cpu_poses = [cpu_trk.process(f.cpu()).pose for f in frames_[:3]]
        vs_cpu = twist_gap(cpu_poses, [r.pose for r in res_[:3]])
        check(vs_cpu <= CLOUD_CPU_BAR, f"{name}: CUDA vs CPU twist {vs_cpu} > {CLOUD_CPU_BAR}")
        fields = {}
        if name == "model":
            truth_gap = twist_gap([model_poses[n_frames - 1].cpu().numpy()], [trk.pose])
            map_points = int(trk.world_map.count().item())
            check(truth_gap < MODEL_TRUTH_BAR, f"model: last pose {truth_gap} from the truth")
            check(map_points > 100, f"model: {map_points} map points")
            fields = {"truth_twist_gap": truth_gap, "map_points": map_points}
        copies_, dev_ms_ = trace_frame(trk, frames_[-2:])
        sync_ops_ = sync_sources(lambda: trk.process(frames_[-1]))
        emit(name, frames=n_frames, twist_vs_cpu_3=vs_cpu, launches=launches_, **fields,
             host_ms_per_frame_median=statistics.median(ms_[1:]), device_ms_per_frame=dev_ms_,
             copies_and_syncs_per_frame=copies_, sync_ops=sync_ops_, peak_mem_GB=peak_, card=card)

    # ---- 8f. the pairwise pipelines (main path) ----------------------------
    # One frame's 8192-point voxel cloud and that cloud moved by a known
    # twist: the bar of tests/test_api_cli.py:97 assumes shared points. Each
    # pipeline runs with its defaults. The FPFH cap of 64 neighbours
    # truncates the 0.5 m ball of 5 cm voxels; on this scene
    # fpfh-kabsch-icp's Kabsch seed then lands far off and ICP settles in
    # another minimum (the CPU alike): its truth bar is held with the cap
    # sized to the densest ball (fpfh_max_neighbors=0, the reference's
    # radiusSearch semantics). robust-global's FPFH matches on this scene's
    # planes and spheres are too poor for its answer to be stable (printed,
    # no bar); it is held to its CPU run and to valid on an 8192-point
    # Gaussian cloud and its moved copy, as tests/test_api_cli.py:86-96
    # builds its pairs. Two frames' own clouds sample the surfaces
    # differently, which biases point-to-point ICP: no bar there either.
    pair_twist = torch.tensor([0.02, -0.01, 0.015, 0.01, -0.015, 0.01], device=dev)
    d_dst, d_src, T_two = synthetic.render_pair(intr, pair_twist, scene)
    T_known = se3.exp(pair_twist)
    src_cloud = frame_cloud(d_src, intr, 0.05, 8192)
    dst_cloud = Cloud(se3.transform_points(T_known, src_cloud.points), src_cloud.mask)
    two_dst = frame_cloud(d_dst, intr, 0.05, 8192)
    blob = 0.8 * torch.randn((8192, 3), generator=torch.Generator().manual_seed(0)).to(dev)
    everywhere = torch.ones(8192, dtype=torch.bool, device=dev)
    blob_pair = (Cloud(blob, everywhere), Cloud(se3.transform_points(T_known, blob), everywhere))
    on_cpu = lambda c: Cloud(c.points.cpu(), c.mask.cpu())  # noqa: E731

    def truth_gap(T, T_true):
        return se3.log(se3.compose(se3.inverse(T_true), T.to(T_true.device))).abs().max().item()

    frame_pair = (src_cloud, dst_cloud)

    def robust_stages(pair_in, device):
        """robust-global's steps on one device, AlignConfig defaults: the
        FPFH features, mutual matches, the max k-core, GNC rounds and pose."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            downs = [voxel.downsample_voxel(Cloud(c.points.to(device), c.mask.to(device)), 0.05) for c in pair_in]
            feats = [fpfh.compute_fpfh(c, torch.zeros(3, device=device)) for c in downs]
        match_idx, keep = robust_global.mutual_matches(feats[0], feats[1], downs[0].mask, downs[1].mask)
        p, q = downs[0].points, downs[1].points[match_idx]
        compat = (robust_global._pairwise_dist(p) - robust_global._pairwise_dist(q)).abs() <= 0.5
        core = robust_global.max_kcore(compat & keep[:, None] & keep[None, :], keep)
        robust_global.ITERATIONS.update(peel=0, gnc=0)
        rr = robust_global.register_robust(*downs, *feats)
        return {"downs": downs, "feats": [f.cpu() for f in feats], "match_idx": match_idx.cpu(), "keep": keep.cpu(),
                "core": core.cpu(), "gnc": robust_global.ITERATIONS["gnc"], "T": rr.transform.cpu()}

    def robust_stages_vs_cpu(pair_in):
        """Where the card's robust-global parts from the same code on the
        CPU: features, then (on the card's own features, on the CPU) the
        mutual matches, the k-core, the GNC rounds and the pose."""
        card_, cpu_ = robust_stages(pair_in, dev), robust_stages(pair_in, "cpu")
        fd = [(a - b).abs().amax(-1) for a, b in zip(card_["feats"], cpu_["feats"])]
        d_cpu = [Cloud(c.points.cpu(), c.mask.cpu()) for c in card_["downs"]]
        idx_same, keep_same = robust_global.mutual_matches(*card_["feats"], d_cpu[0].mask, d_cpu[1].mask)
        k_card, k_cpu = card_["keep"], cpu_["keep"]
        return {
            "fpfh_rows_over_1e-3": [int((x > 1e-3).sum()) for x in fd], "fpfh_max_abs": [x.max().item() for x in fd],
            "mutual_kept": [int(k_card.sum()), int(k_cpu.sum())], "kept_equal": bool(torch.equal(k_card, k_cpu)),
            "kept_equal_on_card_features": bool(torch.equal(keep_same, k_card)
                                                and torch.equal(idx_same[k_card], card_["match_idx"][k_card])),
            "kcore": [int(card_["core"].sum()), int(cpu_["core"].sum())],
            "kcore_equal": bool(torch.equal(card_["core"], cpu_["core"])), "gnc_rounds": [card_["gnc"], cpu_["gnc"]],
            "truth_gap": [truth_gap(card_["T"], T_known.cpu()), truth_gap(cpu_["T"], T_known.cpu())],
        }
    pipelines = (  # (label, registry name, factory overrides, inputs, truth bar, CPU bar; None: no run or bar)
        ("gicp", "gicp", {}, frame_pair, PIPELINE_TRUTH_BAR, CLOUD_CPU_BAR),
        ("fpfh-kabsch-icp", "fpfh-kabsch-icp", {}, frame_pair, None, CLOUD_CPU_BAR),
        ("fpfh-kabsch-icp auto-cap", "fpfh-kabsch-icp", {"cfg": AlignConfig(fpfh_max_neighbors=0)}, frame_pair,
         PIPELINE_TRUTH_BAR, None),
        ("robust-global", "robust-global", {}, frame_pair, None, None),
        ("robust-global blob", "robust-global", {}, blob_pair, None, CLOUD_CPU_BAR),
    )
    pipe_rows, failures = {}, []
    for label, name, overrides, pair_in, truth_bar, cpu_bar in pipelines:
        run_pipe = get_pipeline(name, **overrides)  # on the card: no device argument
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run_pipe(*pair_in)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            robust_global.ITERATIONS.update(peel=0, gnc=0)
            t0 = time.perf_counter()
            out = run_pipe(*pair_in)
            torch.cuda.synchronize()
            pair_ms = (time.perf_counter() - t0) * 1e3
            rounds_ = dict(robust_global.ITERATIONS)
            launches_ = read_counts()
            peak_ = torch.cuda.max_memory_allocated() / 1e9
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            vs_cpu = None
            if cpu_bar is not None:
                cpu_out = get_pipeline(name, device="cpu", **overrides)(*map(on_cpu, pair_in))
                vs_cpu = truth_gap(out.transform, cpu_out.transform.to(dev))
            copies_, dev_ms_ = trace_calls(lambda i: run_pipe(*pair_in), 1)
            two_gap = None
            if pair_in is frame_pair and name != "robust-global":
                two_gap = truth_gap(run_pipe(src_cloud, two_dst).transform, T_two)
        gap = truth_gap(out.transform, T_known)
        row = {"truth_twist_gap": gap, "twist_vs_cpu": vs_cpu, "bars": {"truth": truth_bar, "vs_cpu": cpu_bar},
               "two_frame_truth_gap": two_gap, "ms_per_pair": pair_ms, "device_ms_per_pair": dev_ms_,
               "copies_and_syncs_per_pair": copies_, "launches": launches_, "peak_mem_GB": peak_,
               "fpfh_truncated": any("truncates" in str(w.message) for w in caught)}
        if name != "gicp":
            row["num_matches"] = int(out.num_matches)
        if name == "robust-global":
            # register_robust's own result, which align_pair keeps only as
            # its transform: the same steps with the AlignConfig defaults.
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                downs = [voxel.downsample_voxel(c, 0.05) for c in pair_in]
                rr = robust_global.register_robust(*downs, *(fpfh.compute_fpfh(c, torch.zeros(3, device=dev))
                                                             for c in downs))
            row.update(gnc_rounds=rounds_["gnc"], peel_rounds=rounds_["peel"], valid=bool(rr.valid),
                       num_correspondences=int(rr.num_correspondences), num_inliers=int(rr.num_inliers),
                       rotation_inlier_fraction=float(rr.rotation_inlier_fraction))
            failures += [] if rr.valid else [f"align_pair {label}: not valid"]
            if pair_in is frame_pair:
                row["stages_vs_cpu"] = robust_stages_vs_cpu(pair_in)
        failures += [f"align_pair {label}: {what}" for bad, what in (
            (any(n != 0 for n in launches_.values()), f"a kernel launched: {launches_}"),
            (not bool(torch.isfinite(out.transform).all()), "non-finite transform"),
            (not (bool(torch.isfinite(out.cost)) if name == "gicp" else out.success), "not a success"),
            (truth_bar is not None and not gap < truth_bar, f"truth gap {gap} >= {truth_bar}"),
            (cpu_bar is not None and not vs_cpu <= cpu_bar, f"CUDA vs CPU twist {vs_cpu} > {cpu_bar}"),
        ) if bad]
        pipe_rows[label] = row
    emit("align_pair", points=int(src_cloud.mask.sum().item()), pipelines=pipe_rows, card=card)
    check(not failures, "; ".join(failures))

    # ---- 8g. RGB-D tracking (main path) ------------------------------------
    # Tracker(method="rgbd") with the default RgbdIcpConfig, fitted to three
    # levels at 640x480: per tracked frame one target pyramid (one
    # downsample launch, a level-kernel launch per level), one source
    # depth chain (one downsample launch) and sum(iters) + 1 joint steps of
    # one gn_system launch each (the last takes the statistics at the
    # returned pose). u8 color goes through the facade's _as_gray.
    rgbd_cfg = projective.fit_levels(RgbdIcpConfig(), intr.height, intr.width)
    rgbd_levels, rgbd_steps = len(rgbd_cfg.iters), sum(rgbd_cfg.iters) + 1
    n_rgbd = 10
    rgbd_depths, rgbd_colors, rgbd_poses = synthetic.render_trajectory_rgbd(intr, n_rgbd, seed=0, device=dev)
    colors8 = [np.clip(c * 255, 0, 255).astype(np.uint8) for c in rgbd_colors.cpu().numpy()]
    rgbd_tcfg = TrackerConfig(intrinsics=intr, method="rgbd", device="cuda")
    warm = Tracker(rgbd_tcfg)  # library initialisation, outside every count and time
    for i in range(2):
        warm.process(rgbd_depths[i], color=colors8[i])
    rgbd_trk = Tracker(rgbd_tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rgbd_res, rgbd_ms = [], []
    for i in range(n_rgbd):
        t0 = time.perf_counter()
        rgbd_res.append(rgbd_trk.process(rgbd_depths[i], float(i), color=colors8[i]))  # ends in a host transfer
        rgbd_ms.append((time.perf_counter() - t0) * 1e3)
    rgbd_launches = read_counts()
    rgbd_peak = torch.cuda.max_memory_allocated() / 1e9
    check_counts(rgbd_launches, "rgbd", rgbd_levels * n_rgbd, 0, 2 * n_rgbd - 1, rgbd_steps * (n_rgbd - 1))
    check(all(r.success for r in rgbd_res), "rgbd: a frame failed")
    rgbd_ate = ate_of(rgbd_trk.trajectory, rgbd_poses)
    check(rgbd_ate["rmse"] < ATE_BAR, f"rgbd: ATE rmse {rgbd_ate['rmse']} >= {ATE_BAR}")
    rgbd_cpu = Tracker(dataclasses.replace(rgbd_tcfg, device="cpu"))
    cpu_poses = [rgbd_cpu.process(rgbd_depths[i].cpu(), color=colors8[i]).pose for i in range(3)]
    rgbd_vs_cpu = twist_gap(cpu_poses, [r.pose for r in rgbd_res[:3]])
    check(rgbd_vs_cpu <= TWIST_BAR_CPU, f"rgbd: CUDA vs CPU twist {rgbd_vs_cpu} > {TWIST_BAR_CPU}")
    # Host copies: the runtime's stream syncs (every blocking copy to or
    # from the host is one), counted from the trace's API records; its
    # device copy records are printed beside them, but CUPTI can drop some
    # of those in a long trace (19 of a window's 2,817 copies in one call).
    # The traced frames take their color on the card, so the only copy is
    # the stats read.
    colors8_dev = [torch.from_numpy(c).to(dev) for c in colors8[-2:]]
    rgbd_copies, rgbd_dev_ms = trace_calls(lambda i: rgbd_trk.process(rgbd_depths[n_rgbd - 2 + i],
                                                                       color=colors8_dev[i]), 2)
    rgbd_syncs = rgbd_copies.get("cudaStreamSynchronize", 0)
    rgbd_dtoh = sum(n for k, n in rgbd_copies.items() if "DtoH" in k)
    check(rgbd_syncs == 1 and rgbd_dtoh <= 1, f"rgbd: {rgbd_syncs} host copies per frame ({rgbd_copies})")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        rgbd_trk.process(rgbd_depths[-1], color=colors8[-1])
        torch.cuda.synchronize()
    rgbd_kernels = sum(e.name.startswith("cudaLaunchKernel") for e in prof.events())

    # RgbdKeyframeTracker: per frame against process_window(window=8) over
    # the same 9 frames (frame 0 seeds the keyframe), the two in turns.
    rgbd_grays = synthetic.intensity_from_rgb(rgbd_colors)
    kf_pf, kf_win = RgbdKeyframeTracker(intr, device=dev), RgbdKeyframeTracker(intr, device=dev)
    kf_cfg_fit = kf_pf.cfg
    kf_steps = sum(kf_cfg_fit.iters) + 1
    reset_counts()
    t0 = time.perf_counter()
    kpf = [kf_pf.process(rgbd_depths[i], rgbd_grays[i], float(i)) for i in range(9)]
    kpf_ms = (time.perf_counter() - t0) * 1e3 / 9
    check_counts(read_counts(), "rgbd keyframe per frame", rgbd_levels * 9, 0, 1 + 2 * 8, kf_steps * 8)
    reset_counts()
    t0 = time.perf_counter()
    kwin = [kf_win.process(rgbd_depths[0], rgbd_grays[0], 0.0)]
    kwin += kf_win.process_window(list(rgbd_depths[1:9]), list(rgbd_grays[1:9]), [float(i) for i in range(1, 9)],
                                  pad_to=8, truncate_at_events=False)
    kwin_ms = (time.perf_counter() - t0) * 1e3 / 9
    check_counts(read_counts(), "rgbd keyframe windowed", rgbd_levels * 2, 0, 1 + 2, kf_steps * 8)
    check(len(kwin) == len(kpf) == 9, "rgbd keyframe: a frame is missing")
    kf_pose_diff = max(float(np.abs(a.pose - b.pose).max()) for a, b in zip(kpf, kwin))
    for a, b in zip(kpf, kwin):
        check(a.success == b.success and a.is_new_keyframe == b.is_new_keyframe
              and abs(a.rmse - b.rmse) < 1e-5 and abs(a.inlier_fraction - b.inlier_fraction) < 1e-5,
              f"rgbd keyframe: frame {a.frame_index} differs between process and process_window")
    check(kf_pose_diff <= 1e-5, f"rgbd keyframe: poses differ by {kf_pose_diff} between the modes")
    check(all(r.success for r in kpf), "rgbd keyframe: a frame failed")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        kf_win.process_window(list(rgbd_depths[1:9]), list(rgbd_grays[1:9]), pad_to=8, truncate_at_events=False)
        torch.cuda.synchronize()
    win_copies = {e.key: e.count for e in prof.key_averages() if "Memcpy" in e.key or "Synchronize" in e.key}
    win_syncs = win_copies.get("cudaStreamSynchronize", 0)
    win_dtoh = sum(n for k, n in win_copies.items() if "DtoH" in k)
    check(win_syncs == 1 and win_dtoh <= 1, f"rgbd keyframe: {win_syncs} host copies in one window ({win_copies})")
    emit("rgbd", frames=n_rgbd, config={"iters": list(rgbd_cfg.iters), "samples": rgbd_cfg.samples},
         ate_rmse=rgbd_ate["rmse"], twist_vs_cpu_3=rgbd_vs_cpu, launches=rgbd_launches,
         launches_per_frame={"gn_system": rgbd_steps, "build_level_packed": rgbd_levels, "downsample_levels": 2},
         device_kernels_per_frame=rgbd_kernels, host_copies_per_frame=rgbd_syncs,
         copies_and_syncs_per_frame=rgbd_copies,
         host_ms_per_frame_median=statistics.median(rgbd_ms[1:]), host_ms_per_frame_max=max(rgbd_ms[1:]),
         device_ms_per_frame=rgbd_dev_ms, peak_mem_GB=rgbd_peak,
         keyframe={"frames": 9, "window": 8, "promotions": sum(r.is_new_keyframe for r in kpf[1:]),
                   "pose_diff_max": kf_pose_diff, "ms_per_frame": kpf_ms, "windowed_ms_per_frame": kwin_ms,
                   "host_copies_per_window": win_syncs, "copies_and_syncs_per_window": win_copies},
         card=card)

    # ---- 9. timing (CUDA events, after warm-up) --------------------------
    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def turns(run_p, run_k, reps_p, reps_k):
        """Plain, kernel, kernel, plain within one call: (kernel ms, plain ms)."""
        p1, k1, k2, p2 = time_ms(run_p, reps_p), time_ms(run_k, reps_k), time_ms(run_k, reps_k), time_ms(run_p, reps_p)
        return (k1 + k2) / 2, (p1 + p2) / 2

    def graph_ms(fn, reps):
        """Device ms per call of fn: reps calls captured in one CUDA graph and
        replayed between two events (no host time: a small kernel's
        launches would set its events' pace)."""
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    # The downsample at B=512, 640x480, L=4: one launch for the chunk.
    d512 = levels_of(dst_big[:chunk])[0]
    compare_downsample(d512, num_levels)
    ds_k, ds_p = turns(lambda: downsample.downsample_levels_reference(d512, num_levels),
                       lambda: downsample.downsample_levels(d512, num_levels, cfg.min_depth), 3, 20)
    coarse_px = sum(h * w for h, w in downsample.level_shapes(*d512.shape[1:], num_levels)) * chunk
    ds_bytes = d512.numel() * 4 + coarse_px * 5  # depth in; depth + bool validity out
    ds_bound = bound(ds_bytes, coarse_px * 8)  # 4 adds, 4 compares, a divide per output
    emit("timing_downsample", batch=chunk, shape=list(d512.shape), levels=num_levels, kernel_ms=ds_k,
         plain_ms=ds_p, bytes=ds_bytes, bound_ms=ds_bound[0], kernel_GBps=ds_bytes / ds_k / 1e6, card=card)

    def gn_work(T, pts, ok, packed, li):
        """(bytes, f32 operations) one round needs for these inputs: T in and
        out (64 B each per pair), 12 B of stats per pair, 13 B per point
        (xyz + flag), 16 B of plane row per valid point; ~40 operations to
        associate a valid point, ~105 per matched point and inner iteration
        (transform, residual, weight, J, 27 products and sums), ~400 per
        pair and inner iteration for the 6x6 LU, se3.exp and compose."""
        b, _, p = pts.shape
        level = pyramid.PyramidLevel(None, None, None, None, packed)
        _, _, aok = projective.associate_planes_t(T, pts, ok, level, li, cfg)
        n_ok, n_aok, inner = int(ok.sum().item()), int(aok.sum().item()), max(cfg.inner_iters, 1)
        return b * (64 + 64 + 12) + b * p * 13 + n_ok * 16, n_ok * 40 + inner * (n_aok * 105 + b * 400)

    def time_gn(T, pts, ok, packed, li, reps_p, reps_k):
        k, p = turns(lambda: gn_step.gn_round_reference(T, pts, ok, packed, li, cfg),
                     lambda: gn_step.gn_round(T, pts, ok, packed, li, cfg), reps_p, reps_k)
        nbytes, flops = gn_work(T, pts, ok, packed, li)
        b_ms, b_by = bound(nbytes, flops)
        return {"shape": [T.shape[0], *packed.shape[-2:]], "points": pts.shape[-1], "kernel_ms": k,
                "plain_ms": p, "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops}

    kernel_ms, plain_ms, per_level = 0.0, 0.0, []
    level_bytes, level_flops = 0, 0
    gn_levels, gn_b1 = [], None
    gn_ms, gn_plain_ms, gn_bytes, gn_flops = 0.0, 0.0, 0, 0
    T512 = truth_big[:chunk].contiguous()
    for d, ds, li, count in zip(levels_of(dst_big[:chunk]), levels_of(src_big[:chunk]), level_intrs, level_samples):
        compare(d, li)
        k, p = turns(lambda d=d, li=li: level_kernel.build_level_packed_reference(d, li),
                     lambda d=d, li=li: level_kernel.build_level_packed(d, li), 3, 20)
        kernel_ms, plain_ms = kernel_ms + k, plain_ms + p
        bytes_moved = d.numel() * 4 * 5  # 4 B of depth in, 16 B of plane table out
        level_bytes, level_flops = level_bytes + bytes_moved, level_flops + d.numel() * 60
        per_level.append({"shape": list(d.shape), "kernel_ms": k, "plain_ms": p,
                          "kernel_GBps": bytes_moved / k / 1e6})

        packed = level_kernel.build_level_packed(d, li)
        pts, ok = projective.sample_depth_points(ds, li, count)
        pts, ok = pts.transpose(1, 2).contiguous(), ok.contiguous()
        row = time_gn(T512, pts, ok, packed, li, 5, 50)
        gn_levels.append(row)
        gn_ms, gn_plain_ms = gn_ms + row["kernel_ms"], gn_plain_ms + row["plain_ms"]
        gn_bytes, gn_flops = gn_bytes + row["bytes"], gn_flops + row["flops"]
        if gn_b1 is None:  # level 0 at B=1: the trackers' launch
            gn_b1 = time_gn(T512[:1].contiguous(), pts[:1], ok[:1], packed[:1], li, 20, 200)
    gn_bound = bound(gn_bytes, gn_flops)
    # The streamed path: level 0 at 16384 points a pair, and at 8192 (the
    # register path) beside it.
    d0_, ds0_ = levels_of(dst_big[:chunk])[0], levels_of(src_big[:chunk])[0]
    packed0 = level_kernel.build_level_packed(d0_, intr)
    gn_by_points = []
    for p_ in (gn_step.REGISTER_POINTS, 2 * gn_step.REGISTER_POINTS):
        pts_, ok_ = projective.sample_depth_points(ds0_, intr, p_)
        gn_by_points.append(time_gn(T512, pts_.transpose(1, 2).contiguous(), ok_.contiguous(), packed0, intr, 2, 10))
    emit("timing_kernel", batch=chunk, levels=per_level, kernel_ms_total=kernel_ms,
         plain_ms_total=plain_ms, card=card)
    emit("timing_gn", batch=chunk, levels=gn_levels, b1_level0=gn_b1, level0_register_and_streamed=gn_by_points,
         total={"kernel_ms": gn_ms, "plain_ms": gn_plain_ms, "bound_ms": gn_bound[0], "bound_by": gn_bound[1]},
         card=card)

    # gn_system: one association and the system at T, against its plain
    # version (build_normal_equations' torch composition) at B=512 and B=1;
    # then with an association pose (the point-sharded inner step: planes
    # fixed at T, the system at a pose an inner step away), and T_assoc=T
    # bit-identical to the entry without one.
    sys_err = 0.0
    inner_step = se3.exp(torch.tensor([0.003, -0.002, 0.004, 0.002, -0.001, 0.002], device=dev))

    def system_gap(got, ref, what):
        trace = ref[0].diagonal(dim1=-2, dim2=-1).sum(-1).clamp_min(1e-30)[:, None]
        h_rel = ((got[0] - ref[0]).abs().flatten(1) / trace).max().item()
        b_rel = ((got[1] - ref[1]).abs() / trace).max().item()
        w_rel = max(((g - r).abs() / r.abs().clamp_min(1e-30)).max().item() for g, r in zip(got[2:4], ref[2:4]))
        check(h_rel <= SYSTEM_BAR and b_rel <= SYSTEM_BAR, f"{what}: H {h_rel}, b {b_rel} of trace(H)")
        check(torch.equal(got[4], ref[4]), f"{what}: ok_count differs")
        check(w_rel <= SYSTEM_BAR, f"{what}: wsse / wsum {w_rel} relative")
        err = max((got[0] - ref[0]).abs().max().item(), (got[1] - ref[1]).abs().max().item())
        return {"h_of_trace": h_rel, "b_of_trace": b_rel, "wsse_wsum_rel": w_rel, "max_abs_err": err}

    def compare_system(T, pts, ok, packed, li):
        nonlocal sys_err
        flat = lambda r: (r[0], r[1], *r[2])  # noqa: E731
        got = flat(gn_step.gn_system(T, pts, ok, packed, li, cfg))
        again = flat(gn_step.gn_system(T, pts, ok, packed, li, cfg))
        ref = flat(gn_step.gn_system_reference(T, pts, ok, packed, li, cfg))
        torch.cuda.synchronize()
        what = f"gn_system at B={T.shape[0]} {packed.shape[-2]}x{packed.shape[-1]} P={pts.shape[-1]}"
        check(all(torch.equal(a, b) for a, b in zip(got, again)), f"{what}: a second launch differs")
        if T.shape[0] > 1:
            alone = flat(gn_step.gn_system(T[1:2], pts[1:2], ok[1:2], packed[1:2], li, cfg))
            check(all(torch.equal(a[0], b[1]) for a, b in zip(alone, got)), f"{what}: pair 1 depends on B")
        row = system_gap(got, ref, what)
        same = flat(gn_step.gn_system(T, pts, ok, packed, li, cfg, T_assoc=T.clone()))
        check(all(torch.equal(a, b) for a, b in zip(got, same)), f"{what}: T_assoc=T differs from no T_assoc")
        T_in = (inner_step @ T).contiguous()
        got_a = flat(gn_step.gn_system(T_in, pts, ok, packed, li, cfg, T_assoc=T))
        again_a = flat(gn_step.gn_system(T_in, pts, ok, packed, li, cfg, T_assoc=T))
        ref_a = flat(gn_step.gn_system_reference(T_in, pts, ok, packed, li, cfg, T_assoc=T))
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got_a, again_a)), f"{what} T_assoc: a second launch differs")
        row["t_assoc"] = system_gap(got_a, ref_a, f"{what} T_assoc")
        sys_err = max(sys_err, row["max_abs_err"], row["t_assoc"]["max_abs_err"])
        return row

    def time_system(T, pts, ok, packed, li, reps_p, reps_k):
        """(row, bytes, operations): 64 B of pose and 180 B of system per
        pair, 13 B per point, 16 B of plane row per valid point; ~40
        operations to associate a valid point, ~105 per matched one."""
        row = compare_system(T, pts, ok, packed, li)
        k, p = turns(lambda: gn_step.gn_system_reference(T, pts, ok, packed, li, cfg),
                     lambda: gn_step.gn_system(T, pts, ok, packed, li, cfg), reps_p, reps_k)
        b, _, n = pts.shape
        n_ok, n_match = int(ok.sum().item()), int(gn_step.gn_system(T, pts, ok, packed, li, cfg)[2][2].sum().item())
        nbytes, flops = b * (64 + 180) + b * n * 13 + n_ok * 16, n_ok * 40 + n_match * 105
        b_ms, b_by = bound(nbytes, flops)
        row.update(shape=[b, *packed.shape[-2:]], points=n, kernel_ms=k, plain_ms=p, bound_ms=b_ms, bound_by=b_by)
        return row, nbytes, flops

    sys_levels, sys_b1 = [], []
    sys_ms, sys_plain_ms, sys_bytes, sys_flops = 0.0, 0.0, 0, 0
    for d, ds, li, count in zip(levels_of(dst_big[:chunk]), levels_of(src_big[:chunk]), level_intrs, level_samples):
        packed = level_kernel.build_level_packed(d, li)
        pts, ok = projective.sample_depth_points(ds, li, count)
        pts, ok = pts.transpose(1, 2).contiguous(), ok.contiguous()
        row, nbytes, flops = time_system(T512, pts, ok, packed, li, 5, 50)
        sys_levels.append(row)
        sys_ms, sys_plain_ms = sys_ms + row["kernel_ms"], sys_plain_ms + row["plain_ms"]
        sys_bytes, sys_flops = sys_bytes + nbytes, sys_flops + flops
        sys_b1.append(time_system(T512[:1].contiguous(), pts[:1], ok[:1], packed[:1], li, 20, 200)[0])
    sys_bound = bound(sys_bytes, sys_flops)
    emit("gn_system", batch=chunk, bars={"of_trace": SYSTEM_BAR, "wsse_wsum_rel": SYSTEM_BAR}, levels=sys_levels,
         b1=sys_b1, total={"kernel_ms": sys_ms, "plain_ms": sys_plain_ms, "bound_ms": sys_bound[0],
                           "bound_by": sys_bound[1]}, card=card)

    base0, base1, _ = synthetic.render_pair(
        intr, torch.tensor([0.01, -0.005, 0.01, 0.005, -0.01, 0.005]), scene
    )
    del src_big, dst_big, res_big
    batch = 2048
    noise = lambda b: b + 0.001 * torch.randn((batch,) + b.shape, generator=gen, device=dev)  # noqa: E731
    bench_src, bench_dst = noise(base1), noise(base0)
    batched.register_batch_chunked(bench_src[:chunk], bench_dst[:chunk], intr, cfg, chunk=chunk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_iters = 3
    t0 = time.perf_counter()
    for _ in range(n_iters):
        out = batched.register_batch_chunked(bench_src, bench_dst, intr, cfg, chunk=chunk)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(bool(torch.isfinite(out.transform).all()), "bench workload: non-finite transforms")
    timing_register_pairs_per_s = batch * n_iters / dt
    emit("timing_register", pairs=batch, chunk=chunk, iters=n_iters,
         pairs_per_s=timing_register_pairs_per_s, seconds=dt,
         peak_mem_GB=torch.cuda.max_memory_allocated() / 1e9, card=card)

    # The tie-stable k-NN: k_smallest (topk over value-bits|index keys)
    # against a stable sort of each row, on one 1024-query chunk of the
    # 8192-point cloud, at the k of the normals (16), of GICP's covariances
    # (32) and of the FPFH neighbourhoods (65).
    d_chunk = correspond._masked_sqdist(src_cloud.points[:1024], src_cloud)
    knn_rows = []
    for k in (16, 32, 65):
        i_key, _ = correspond.k_smallest(d_chunk, k)
        i_sort = torch.sort(d_chunk, dim=-1, stable=True).indices[:, :k]
        check(torch.equal(i_key, i_sort), f"k_smallest at k={k} differs from a stable sort")
        key_ms, sort_ms = turns(lambda k=k: torch.sort(d_chunk, dim=-1, stable=True).indices[:, :k],
                                lambda k=k: correspond.k_smallest(d_chunk, k), 20, 20)
        knn_rows.append({"k": k, "k_smallest_ms": key_ms, "stable_sort_ms": sort_ms})
    emit("timing_knn", queries=d_chunk.shape[0], points=d_chunk.shape[1], rows=knn_rows, card=card)

    # ---- 10-12. backbone kernel, pose graph, SLAM at 640x480 -------------
    bb = backbone_and_slam_phases(types.SimpleNamespace(
        dev=dev, card=card, reset_counts=reset_counts, read_counts=read_counts, check_counts=check_counts,
        bound=bound, turns=turns, time_ms=time_ms, ate_of=ate_of, slam_intr=camera.TUM_DEFAULT,
    ))

    # ---- 13-17. TSDF kernels, dense tracking, mesh, submap atlas ---------
    dense = dense_phases(types.SimpleNamespace(
        dev=dev, card=card, reset_counts=reset_counts, read_counts=read_counts, check_counts=check_counts,
        bound=bound, turns=turns, time_ms=time_ms, ate_of=ate_of, twist_gap=twist_gap,
        trace_calls=trace_calls, intr=intr,
    ))
    atlas_for_mesh = dense.pop("atlas")

    # ---- 18-23. serving: batched sessions, windows, RGB-D, dense, rs_serve -
    serving_phases(types.SimpleNamespace(
        dev=dev, card=card, intr=intr, reset_counts=reset_counts, read_counts=read_counts,
        check_counts=check_counts, ate_of=ate_of, twist_gap=twist_gap,
    ))

    # ---- 24. replay: TUM and .rsc files through rs_replay ----------------
    replay_phase(types.SimpleNamespace(
        dev=dev, card=card, reset_counts=reset_counts, read_counts=read_counts, check_counts=check_counts,
    ))

    # ---- 25. cli: rs_benchmark, rs_streams, rs_align, capture, rs_viewer -
    cli_phase(types.SimpleNamespace(
        dev=dev, card=card, reset_counts=reset_counts, read_counts=read_counts, check_counts=check_counts,
        timing_register_pairs_per_s=timing_register_pairs_per_s,
    ))

    # ---- 26. multidevice: the sharded paths on one NCCL rank --------------
    multidevice_phase(types.SimpleNamespace(
        dev=dev, card=card, reset_counts=reset_counts, read_counts=read_counts, check_counts=check_counts,
        time_ms=time_ms, atlas=atlas_for_mesh,
    ))

    # ---- 27. kernel_alone: the backbone and the raycast in CUDA graphs ----
    alone = kernel_alone_phase(types.SimpleNamespace(dev=dev, card=card, graph_ms=graph_ms, intr=intr))
    # The integrate's first two kernels alone at 128^3 (CUDA graphs): the
    # tile map, and the cull as the tile map and the cull less the tile map.
    dense["tsdf_depth_tiles"]["ms"] = alone["integrate_128"]["tile_map"]
    dense["tsdf_cull"]["ms"] = alone["integrate_128"]["tile_map_and_cull"] - alone["integrate_128"]["tile_map"]

    for name, n in main_launches.items():
        check(n > 0, f"the main paths never launched {name}")
    errs = {"downsample_levels": ds_worst["abs"], "build_level_packed": max_err, "gn_round": gn_err,
            "gn_system": sys_err, "backbone": bb["max_abs_err"],
            **{k: v["max_abs_err"] for k, v in dense.items()}}
    times = {"downsample_levels": (ds_k, ds_p), "build_level_packed": (kernel_ms, plain_ms),
             "gn_round": (gn_ms, gn_plain_ms), "gn_system": (sys_ms, sys_plain_ms),
             "backbone": (bb["ms"], bb["plain_ms"]), **{k: (v["ms"], v["plain_ms"]) for k, v in dense.items()}}
    bounds = {"downsample_levels": ds_bound, "build_level_packed": bound(level_bytes, level_flops),
              "gn_round": gn_bound, "gn_system": sys_bound, "backbone": (bb["bound_ms"], bb["bound_by"]),
              **{k: (v["bound_ms"], v["bound_by"]) for k, v in dense.items()}}
    # No single PyTorch call computes any of these functions (a
    # validity-aware mean over several levels, a plane table, a round of
    # gated GNC Gauss-Newton with its 6x6 solves, a projective gather with
    # its gated GNC system, a block cyclic reduction of 6x6 blocks), so
    # library_ms is null throughout. The backbone row is its factor and one
    # apply at n = 1000, its bound over f64's peak, with the previous
    # design's time (a chain of n + 2n dependent 6x6 steps), measured in
    # turns in this run, beside it. No PyTorch call computes a gated TSDF
    # running average, a valid-depth maximum per tile, a frustum and depth
    # cull of bricks or a ray march either; their rows are one integrate
    # (tile map, cull and the update of the kept bricks, with launches) of a
    # 640x480 frame into the default 128^3 volume, its tile map and cull
    # alone (CUDA graphs, phase 27), and one full 640x480 raycast of it,
    # the march's gather count beside its bound.
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": main_launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None,
         **({"previous_ms": bb["previous_ms"]} if name == "backbone" else {}),
         **({"gathers": dense[name]["gathers"]} if name == "tsdf_raycast" else {})}
        for name, (source, replaces) in KERNELS.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    if len(args) == 2 and args[0] == "--tree-ms":
        print(json.dumps(tree_host_ms(args[1])), flush=True)
    elif args[:1] == ["--against"] and (len(args) == 2 or (len(args) == 4 and args[2] == "--rounds")):
        against(args[1], int(args[3]) if len(args) == 4 else 1)
    elif args:
        raise SystemExit(f"chip_smoke: unknown arguments {args}")
    else:
        if any(os.environ.get(k) != v for k, v in MALLOC_ENV.items()):
            os.execve(sys.executable, sys.orig_argv, {**os.environ, **MALLOC_ENV})
        sys.exit(main())
