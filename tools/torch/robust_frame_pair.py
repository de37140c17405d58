"""robust-global and fpfh-kabsch-icp on chip_smoke.py's frame pair, the
port's CPU run against the JAX package's, stage by stage.

The pair is phase align_pair's: the 8192-point voxel cloud of one 640x480
TUM_FR1 frame of default_scene(seed=0) and that cloud moved by a known
twist. Runs on the CPU in a few minutes and ~3 GB:

    JAX_PLATFORMS=cpu python tools/torch/robust_frame_pair.py stages
    JAX_PLATFORMS=cpu python tools/torch/robust_frame_pair.py pipelines

"stages" prints, for robust-global's AlignConfig defaults, where the two
part: the voxel clouds, the FPFH features, the mutual matches and the max
k-core, first each on its own features, then the port on JAX's features;
then each side's register_robust. "pipelines" runs both registries'
robust-global and fpfh-kabsch-icp end to end and prints the truth gaps.
"""
import os
import sys
import time
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from realsensetracker_tpu.align import robust_global as jrg  # noqa: E402
from realsensetracker_tpu.models import get_pipeline as jget  # noqa: E402
from realsensetracker_tpu.ops import cloud as jcloud  # noqa: E402
from realsensetracker_tpu.ops import fpfh as jfpfh  # noqa: E402
from realsensetracker_tpu.ops import voxel as jvoxel  # noqa: E402
from realsensetracker_tpu_torch.align import robust_global as rg  # noqa: E402
from realsensetracker_tpu_torch.models import get_pipeline  # noqa: E402
from realsensetracker_tpu_torch.ops import fpfh, voxel  # noqa: E402
from realsensetracker_tpu_torch.ops.cloud import Cloud  # noqa: E402
from realsensetracker_tpu_torch.data import synthetic  # noqa: E402
from realsensetracker_tpu_torch.geometry import camera, se3  # noqa: E402
from realsensetracker_tpu_torch.tracking.frame_to_model import frame_cloud  # noqa: E402

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(4)
warnings.simplefilter("ignore")

intr = camera.TUM_FR1
scene = synthetic.default_scene(seed=0)
pair_twist = torch.tensor([0.02, -0.01, 0.015, 0.01, -0.015, 0.01])
d_dst, d_src, _ = synthetic.render_pair(intr, pair_twist, scene)
T_known = se3.exp(pair_twist)
src = frame_cloud(d_src, intr, 0.05, 8192)
dst = Cloud(se3.transform_points(T_known, src.points), src.mask)
jsrc = jcloud.Cloud(jnp.asarray(src.points.numpy()), jnp.asarray(src.mask.numpy()))
jdst = jcloud.Cloud(jnp.asarray(dst.points.numpy()), jnp.asarray(dst.mask.numpy()))
print("points", int(src.mask.sum()))

def gap(T, Tt=T_known):
    T = torch.as_tensor(np.asarray(T), dtype=torch.float32)
    return se3.log(se3.compose(se3.inverse(Tt), T)).abs().max().item()

which = sys.argv[1] if len(sys.argv) > 1 else "stages"
if which == "pipelines":
    for name in ("robust-global", "fpfh-kabsch-icp"):
        t = time.time(); out = get_pipeline(name, device="cpu")(src, dst); tp = time.time() - t
        t = time.time(); jout = jget(name)(jsrc, jdst); tj = time.time() - t
        print(name, "port truth gap", gap(out.transform), "jax truth gap", gap(jout.transform),
              "port-jax", gap(out.transform, torch.as_tensor(np.asarray(jout.transform))), f"{tp:.0f}s {tj:.0f}s")
    sys.exit()

# Stages of robust-global (AlignConfig defaults: voxel 0.05, k 16, radius 0.5, cap 64, noise 0.25)
vs = torch.zeros(3)
sd, dd = voxel.downsample_voxel(src, 0.05), voxel.downsample_voxel(dst, 0.05)
jsd, jdd = jvoxel.downsample_voxel(jsrc, 0.05), jvoxel.downsample_voxel(jdst, 0.05)
for a, b, n in ((sd, jsd, "src"), (dd, jdd, "dst")):
    print("voxel", n, a.capacity, b.capacity, np.array_equal(a.mask.numpy(), np.asarray(b.mask)),
          np.abs(a.points.numpy() - np.asarray(b.points)).max())
sf, _ = fpfh.compute_fpfh_checked(sd, vs, 16, 0.5, 64)
df, _ = fpfh.compute_fpfh_checked(dd, vs, 16, 0.5, 64)
jsf, _ = jfpfh.compute_fpfh_checked(jsd, jnp.zeros(3), 16, 0.5, 64)
jdf, _ = jfpfh.compute_fpfh_checked(jdd, jnp.zeros(3), 16, 0.5, 64)
for a, b, n in ((sf, jsf, "src"), (df, jdf, "dst")):
    d = np.abs(a.numpy() - np.asarray(b)).max(1)
    print("fpfh", n, "max", d.max(), "rows > 1e-3:", int((d > 1e-3).sum()), "of", d.shape[0])
# Continue each side on ITS OWN features, then on the JAX features for the port.
for label, (psf, pdf) in (("own", (sf, df)), ("jax-feats", (torch.from_numpy(np.asarray(jsf)), torch.from_numpy(np.asarray(jdf))))):
    mi, keep = rg.mutual_matches(psf, pdf, sd.mask, dd.mask)
    jmi, jkeep = jrg.mutual_matches(jsf, jdf, jsd.mask, jdd.mask)
    print(label, "matches: keep", int(keep.sum()), int(np.asarray(jkeep).sum()), "keep equal", np.array_equal(keep.numpy(), np.asarray(jkeep)),
          "idx equal on keep", np.array_equal(mi.numpy()[keep.numpy()], np.asarray(jmi)[keep.numpy()]))
    p, q = sd.points, dd.points[mi]
    compat = (rg._pairwise_dist(p) - rg._pairwise_dist(q)).abs() <= 0.5
    compat = compat & keep[:, None] & keep[None, :]
    scr = rg.max_kcore(compat, keep)
    jp, jq = jsd.points, jdd.points[jmi]
    jdp = jnp.linalg.norm(jp[:, None, :] - jp[None, :, :], axis=-1)
    jdq = jnp.linalg.norm(jq[:, None, :] - jq[None, :, :], axis=-1)
    jcompat = (jnp.abs(jdp - jdq) <= 0.5) & jkeep[:, None] & jkeep[None, :]
    jscr = jrg.max_kcore(jcompat, jkeep)
    print(label, "compat edges", int(compat.sum()), int(jnp.sum(jcompat)), "kcore", int(scr.sum()), int(np.asarray(jscr).sum()),
          "kcore equal", np.array_equal(scr.numpy(), np.asarray(jscr)))
    out = rg.register_robust(sd, dd, psf, pdf, 0.25)
    rg.ITERATIONS.update(peel=0, gnc=0)
    out = rg.register_robust(sd, dd, psf, pdf, 0.25)
    its = dict(rg.ITERATIONS)
    jout = jrg.register_robust(jsd, jdd, jsf, jdf, 0.25)
    print(label, "register_robust port", gap(out.transform), "jax", gap(jout.transform), "port-jax",
          gap(out.transform, torch.as_tensor(np.asarray(jout.transform))), "inliers", int(out.num_inliers), int(jout.num_inliers),
          "rot frac", float(out.rotation_inlier_fraction), float(jout.rotation_inlier_fraction), its)
