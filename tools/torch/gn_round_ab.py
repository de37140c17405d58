"""gn_round of two checkouts on the same card: poses and times.

    python tools/torch/gn_round_ab.py ROOT OUT.npz [REF.npz]

imports realsensetracker_tpu_torch from the checkout at ROOT (which builds
its own csrc/gn_step.cu), runs gn_round at B=512 on 640x480 plane tables
for P = 2048, 4096, 6144 and 8192 (one, two, three and four points a
thread on the register path) with the default config, times each by CUDA
events (20 launches after a warm-up), and saves the poses, counts and
times to OUT.npz. With REF.npz (another checkout's output) it prints
whether the poses and counts are bit-identical and both checkouts' times.
Run parent, change, change, parent within one call to compare times.
"""

import json
import os
import subprocess
import sys

import numpy as np

ROOT, OUT = sys.argv[1], sys.argv[2]
REF = sys.argv[3] if len(sys.argv) > 3 else None
sys.path.insert(0, os.path.abspath(ROOT))

import torch  # noqa: E402

from realsensetracker_tpu_torch.align import projective  # noqa: E402
from realsensetracker_tpu_torch.data import synthetic  # noqa: E402
from realsensetracker_tpu_torch.geometry import camera, se3  # noqa: E402
from realsensetracker_tpu_torch.kernels import gn_step, level_kernel  # noqa: E402

dev = torch.device("cuda")
intr = camera.TUM_FR1
cfg = projective.ProjectiveIcpConfig()
gen = torch.Generator(device=dev).manual_seed(0)
scene = synthetic.default_scene(seed=0, device=dev)
tw = 0.02 * torch.randn((8, 6), generator=gen, device=dev)
dst = torch.stack([synthetic.render_depth(intr, se3.exp(t), scene) for t in tw])
src = torch.stack([synthetic.render_depth(intr, se3.exp(t + 0.004), scene) for t in tw])
rows = torch.arange(512, device=dev) % 8
packed = level_kernel.build_level_packed(torch.where(dst > 0.05, dst, 0.0)[rows].contiguous(), intr)
T = se3.exp(0.01 * torch.randn((512, 6), generator=gen, device=dev)).contiguous()
out = {}
for p in (2048, 4096, 6144, 8192):
    pts, ok = projective.sample_depth_points(torch.where(src > 0.05, src, 0.0)[rows], intr, p)
    args = (T, pts.transpose(1, 2).contiguous(), ok.contiguous(), packed, intr, cfg)
    T_new, (rmse, _, count) = gn_step.gn_round(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        gn_step.gn_round(*args)
    end.record()
    end.synchronize()
    out[f"T{p}"], out[f"count{p}"] = T_new.cpu().numpy(), count.cpu().numpy()
    out[f"ms{p}"] = np.float64(start.elapsed_time(end) / 20)
np.savez(OUT, **out)
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip()
report = {"root": ROOT, "card": smi, "ms": {p: float(out[f"ms{p}"]) for p in (2048, 4096, 6144, 8192)}}
if REF:
    ref = np.load(REF)
    report["identical"] = {p: bool(np.array_equal(out[f"T{p}"], ref[f"T{p}"])
                                   and np.array_equal(out[f"count{p}"], ref[f"count{p}"]))
                           for p in (2048, 4096, 6144, 8192)}
    report["ref_ms"] = {p: float(ref[f"ms{p}"]) for p in (2048, 4096, 6144, 8192)}
print(json.dumps(report))
