"""Parity of the port's pipeline registry and rs_align_app pipeline
(models/) with the JAX package.

Every pipeline runs with device="cpu" on inputs numpy makes from a seed,
pinned to f32: the depth pipelines on a 120x90 rendered pair, the cloud
pipelines on Gaussian clouds moved by a known twist. Bars: the transform
within 1e-4 (twist of the difference) of JAX's, and,
as tests/test_api_cli.py:97 asks, within 5e-3 of the truth where the
pipeline recovers it. FPFH match counts may differ by 1 in 1000: compiled
JAX decides an FPFH origin-switch near tie by its own rounding
(tests/test_torch_fpfh.py).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realsensetracker_tpu.align import projective as jproj
from realsensetracker_tpu.api.config import AlignConfig as JAlignConfig
from realsensetracker_tpu.api.config import GicpConfig as JGicpConfig
from realsensetracker_tpu.models import align_pair as jalign_pair
from realsensetracker_tpu.models import get_pipeline as jget_pipeline
from realsensetracker_tpu.models import list_pipelines as jlist_pipelines
from realsensetracker_tpu.ops import cloud as jcloud
from realsensetracker_tpu_torch import interop
from realsensetracker_tpu_torch.align import projective
from realsensetracker_tpu_torch.api.config import AlignConfig, GicpConfig
from realsensetracker_tpu_torch.geometry import se3
from realsensetracker_tpu_torch.models import align_pair, get_pipeline, list_pipelines
from realsensetracker_tpu_torch.ops import cloud
from tests.torch_parity import intrinsics, pair, twist_gap

BAR = 1e-4
JINTR, INTR = intrinsics(90, 120, 120.0)
PCFG = projective.ProjectiveIcpConfig(iters=(4, 4, 6), samples=1024)
JPCFG = jproj.ProjectiveIcpConfig(iters=(4, 4, 6), samples=1024)
# A 1500-point Gaussian cloud at 2048 capacity (tests/test_api_cli.py:86-96).
ALIGN = dict(voxel_size=0.05, icp_max_iter=48, cloud_capacity=2048, fpfh_max_neighbors=32)


@pytest.fixture(scope="module")
def clouds():
    """(src points (1500, 3), dst points, T_true) and both packages' clouds."""
    pts = (0.8 * np.random.RandomState(0).randn(1500, 3)).astype(np.float32)
    T_true = se3.exp(torch.tensor([0.04, -0.02, 0.03, 0.03, 0.02, -0.04])).numpy()
    dst = (pts.astype(np.float64) @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)
    port = [cloud.pad_to_capacity(p, 2048, device="cpu") for p in (pts, dst)]
    jax_ = [jcloud.pad_to_capacity(p, 2048) for p in (pts, dst)]
    return port, jax_, T_true


def test_registry_lists_the_jax_pipelines():
    assert list_pipelines() == jlist_pipelines()
    assert set(list_pipelines()) == {"projective-icp", "keyframe", "gnc-icp", "gicp", "fpfh-kabsch-icp",
                                     "robust-global"}
    with pytest.raises(KeyError, match="unknown pipeline"):
        get_pipeline("teaser", device="cpu")


@pytest.mark.parametrize("name", ["projective-icp", "keyframe"])
def test_depth_pipelines_match_jax(name):
    src, dst, T_true = pair(INTR, [0.01, -0.005, 0.008, 0.004, -0.006, 0.005])
    out = get_pipeline(name, intr=INTR, cfg=PCFG, device="cpu")(src, dst)
    jout = jget_pipeline(name, intr=JINTR, cfg=JPCFG)(jnp.asarray(src), jnp.asarray(dst))
    assert out.transform.shape == (4, 4)
    assert twist_gap(jout.transform, out.transform) < BAR
    assert twist_gap(T_true, out.transform) < 5e-3
    assert abs(float(out.rmse) - float(jout.rmse)) < BAR


@pytest.mark.parametrize("name,kw,jkw", [
    ("gnc-icp", {"max_iter": 32}, {"max_iter": 32}),
    ("gicp", {"cfg": GicpConfig(max_outer=6, inner_iters=4, cov_k=8)},
     {"cfg": JGicpConfig(max_outer=6, inner_iters=4, cov_k=8)}),
])
def test_cloud_pipelines_match_jax(clouds, name, kw, jkw):
    """The first 300 points, moved by the true twist."""
    (src, dst), (jsrc, jdst), T_true = clouds
    cut = [cloud.Cloud(c.points[:300], c.mask[:300]) for c in (src, dst)]
    jcut = [jcloud.Cloud(c.points[:300], c.mask[:300]) for c in (jsrc, jdst)]
    out = get_pipeline(name, device="cpu", **kw)(*cut)
    jout = jget_pipeline(name, **jkw)(*jcut)
    assert twist_gap(jout.transform, out.transform) < BAR
    assert twist_gap(T_true, out.transform) < 5e-3


@pytest.mark.parametrize("name", ["fpfh-kabsch-icp", "robust-global"])
def test_align_pair_pipelines_match_jax(clouds, name):
    (src, dst), (jsrc, jdst), T_true = clouds
    if name == "fpfh-kabsch-icp":
        cfg, jcfg = AlignConfig(**ALIGN), JAlignConfig(**ALIGN)
    else:
        flags = dict(init_with_fpfh=False, refine_with_icp=False, use_robust=True, noise_bound=0.05)
        cfg, jcfg = AlignConfig(**ALIGN, **flags), JAlignConfig(**ALIGN, **flags)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the cap of 32 truncates some balls, on both sides
        out = get_pipeline(name, cfg=cfg, device="cpu")(src, dst)
        jout = jget_pipeline(name, cfg=jcfg)(jsrc, jdst)
    assert out.success and jout.success
    assert twist_gap(jout.transform, out.transform) < BAR
    assert twist_gap(T_true, out.transform) < 5e-3
    # An FPFH switch near tie (tests/test_torch_fpfh.py) can move a Lowe decision.
    assert abs(int(out.num_matches) - int(jout.num_matches)) <= 1e-3 * int(jout.num_matches)
    assert out.src_down.capacity == 2048 and out.src_feats.shape == (2048, 33)


def test_align_pair_warns_on_a_truncating_cap_and_auto_sizes(clouds):
    """A cap below the densest ball warns, as JAX's does; cap 0 sizes it."""
    (src, dst), _, _ = clouds
    cfg = AlignConfig(**{**ALIGN, "icp_max_iter": 4, "fpfh_max_neighbors": 16})
    with pytest.warns(UserWarning, match="fpfh_max_neighbors=16"):
        align_pair(src, dst, cfg)
    small = [cloud.Cloud(c.points[:256], c.mask[:256]) for c in (src, dst)]
    auto = AlignConfig(voxel_size=0.05, icp_max_iter=4, cloud_capacity=256, fpfh_max_neighbors=0, feature_radius=0.3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = align_pair(*small, auto)
    assert res.success and res.src_down.capacity == 256


def test_align_pair_without_features(clouds):
    """init_with_fpfh=False, use_robust=False: ICP from the identity; no
    features are computed."""
    (src, dst), (jsrc, jdst), _ = clouds
    kw = {**ALIGN, "init_with_fpfh": False, "icp_max_iter": 16}
    out = align_pair(src, dst, AlignConfig(**kw))
    jout = jalign_pair(jsrc, jdst, JAlignConfig(**kw))
    assert out.src_feats is None and int(out.num_matches) == 0
    assert twist_gap(jout.transform, out.transform) < BAR
    assert abs(float(out.icp_mean_cost) - float(jout.icp_mean_cost)) < BAR


def test_configs_match_jax_defaults():
    assert AlignConfig() == interop.align_config_from_jax(JAlignConfig())
    assert GicpConfig() == interop.gicp_config_from_jax(JGicpConfig())


def test_pipelines_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in list_pipelines():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_pipeline(name)
