"""Tests of the port's CUDA kernels: they need a card and nvcc, and skip
elsewhere. This file imports neither JAX nor the JAX package, so it runs on
a machine with a card and no JAX, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The kernel is held against its plain torch version at atol 2e-5 with the
validity pattern exact, and the CUDA paths against the same code on CPU.
"""

import numpy as np
import pytest
import torch

from realsensetracker_tpu_torch.align import projective
from realsensetracker_tpu_torch.api import Tracker, TrackerConfig
from realsensetracker_tpu_torch.data import synthetic
from realsensetracker_tpu_torch.geometry import camera, se3
from realsensetracker_tpu_torch.kernels import level_kernel
from realsensetracker_tpu_torch.ops import pyramid
from realsensetracker_tpu_torch.parallel import batched

pytestmark = pytest.mark.cuda

ATOL = 2e-5
# (height, width): the level shapes of a 640x480 frame, the odd heights of
# tests/test_kernels.py, and odd dims.
SHAPES = [(480, 640), (240, 320), (120, 160), (60, 80), (482, 64), (36, 128), (61, 83)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the level kernel is CUDA-only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _intr(h, w):
    return camera.Intrinsics(fx=0.8 * w, fy=0.8 * w, cx=(w - 1) / 2, cy=(h - 1) / 2, width=w, height=h)


def _depths(intr, n, device):
    """n masked frames (0 = invalid) from small camera motions, with holes."""
    sc = synthetic.default_scene(seed=3, device=device)
    tw = 0.02 * torch.randn((n, 6), generator=torch.Generator().manual_seed(0))
    d = torch.stack([synthetic.render_depth(intr, se3.exp(t).to(device), sc) for t in tw])
    holes = torch.rand(d.shape, generator=torch.Generator().manual_seed(1)).to(device) < 0.05
    d = torch.where(holes, 0.0, d)
    return torch.where((d > 0.05) & (d < 10.0), d, 0.0).contiguous()


def _assert_plane_tables(got, ref):
    torch.testing.assert_close(got, ref, rtol=0, atol=ATOL)
    assert torch.equal(got[:, :3].abs().sum(1) > 0, ref[:, :3].abs().sum(1) > 0)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernel_matches_reference(cuda, shape):
    intr = _intr(*shape)
    d = _depths(intr, 3, cuda)
    before = level_kernel.LAUNCHES
    got = level_kernel.build_level_packed(d, intr)
    torch.cuda.synchronize()
    assert level_kernel.LAUNCHES == before + 1
    _assert_plane_tables(got, level_kernel.build_level_packed_reference(d, intr))


def test_pyramid_auto_uses_kernel(cuda):
    intr = _intr(120, 160)
    d = _depths(intr, 2, cuda)
    before = level_kernel.LAUNCHES
    got, _ = pyramid.build_pyramid(d, intr, 3)
    assert level_kernel.LAUNCHES == before + 3
    ref, _ = pyramid.build_pyramid(d, intr, 3, use_kernel=False)
    for g, r in zip(got, ref):
        _assert_plane_tables(g.packed, r.packed)
        assert torch.equal(g.valid, r.valid)


def test_register_batch_on_cuda_matches_cpu(cuda):
    intr = _intr(120, 160)
    sc = synthetic.default_scene(seed=1)
    tw = torch.tensor([[0.02, -0.01, 0.015, 0.01, -0.015, 0.01], [0.0, 0.01, 0.0, 0.0, 0.0, 0.02]])
    dst = synthetic.render_depth(intr, se3.identity(), sc)[None].expand(2, -1, -1)
    src = torch.stack([synthetic.render_depth(intr, se3.exp(t), sc) for t in tw])
    cfg = projective.ProjectiveIcpConfig()
    ref = batched.register_batch(src, dst.contiguous(), intr, cfg)
    before = level_kernel.LAUNCHES
    got = batched.register_batch(src.to(cuda), dst.to(cuda), intr, cfg)
    assert level_kernel.LAUNCHES == before + len(projective.fit_levels(cfg, 120, 160).iters)
    np.testing.assert_allclose(
        se3.log(got.transform.cpu()).numpy(), se3.log(ref.transform).numpy(), atol=1e-4
    )


def test_tracker_on_cuda_matches_cpu(cuda):
    intr = _intr(90, 120)
    depths, _ = synthetic.render_trajectory(intr, 5, seed=2)
    poses = []
    for device in ("cpu", cuda):
        tracker = Tracker(TrackerConfig(intrinsics=intr, device=str(device)))
        poses.append(np.stack([tracker.process(d).pose for d in depths]))
    np.testing.assert_allclose(poses[1], poses[0], atol=1e-4)
