"""The frozen generators: deterministic for a seed, fr1/desk's motion."""

import math

import torch

from h100bench import manifest as mf
from h100bench import scene
from h100bench.runners import kinfu, pairs

from h100bench.tests.tiny import TINY


def _pool(seed):
    cfg = {**mf.config("tum_fr1_pairs"), **TINY["pairs.fr1.b512"][0]}
    return pairs.make_pool(cfg, seed, torch.device("cpu"))


def test_pair_pool_is_a_function_of_the_seed():
    a, b = _pool(2**31 + 12345), _pool(2**31 + 12345)
    c = _pool(7)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    src, dst, motion = a
    assert src.shape == dst.shape == (8, 60, 80) and (src > 0).float().mean() > 0.9


def test_pair_motion_matches_fr1_desk():
    cfg = mf.config("tum_fr1_pairs")
    g = torch.Generator().manual_seed(99)
    _, M = scene.pair_poses(g, 4096, cfg["start"], cfg["motion"], "cpu")
    t = M[:, :3, 3].double().norm(dim=-1)
    cos = ((M[:, 0, 0] + M[:, 1, 1] + M[:, 2, 2] - 1) / 2).double().clamp(-1, 1)
    angle = torch.rad2deg(torch.acos(cos))
    assert torch.allclose(t, torch.full_like(t, 0.413 / 30), rtol=1e-5)
    assert torch.allclose(angle, torch.full_like(angle, 23.3 / 30), rtol=2e-3)
    dirs = M[:, :3, 3] / M[:, :3, 3].norm(dim=-1, keepdim=True)
    assert dirs.mean(0).norm() < 0.05  # uniform directions


def test_out_and_back_cycles_at_fr1_speed():
    cfg = mf.config("kinfu512_multicam")
    d = torch.tensor([1.0, 0.0, 0.0])
    ax = torch.tensor([0.0, 1.0, 0.0])
    P = scene.out_and_back(150, 151, d, ax, cfg["motion"])
    assert torch.allclose(P[0], torch.eye(4), atol=1e-6) and torch.allclose(P[150], P[0], atol=1e-6)
    steps = (P[1:, :3, 3] - P[:-1, :3, 3]).norm(dim=-1)
    moving = steps > 1e-9
    assert torch.allclose(steps[moving], torch.full_like(steps[moving], 0.413 / 30), rtol=1e-4)
    assert moving.float().mean() > 0.97


def test_kinfu_seed_orders_the_same_cameras():
    cfg = {**mf.config("kinfu512_multicam"), **TINY["kinfu512.16cam.live"][0]}
    order_a, checked_a = kinfu.draw(5 * 2**31, 2, 2)
    assert kinfu.draw(5 * 2**31, 2, 2) == (order_a, checked_a)
    a = kinfu.make_frames(cfg, order_a, 6, torch.device("cpu"))
    b = kinfu.make_frames(cfg, order_a[::-1], 6, torch.device("cpu"))
    assert a[0].dtype == torch.uint16 and a[0].shape == (6, 2, 60, 80)
    assert torch.equal(a[0], b[0].flip(1)) and torch.equal(a[1], b[1].flip(0))
    assert not torch.equal(a[0][:, 0], a[0][:, 1])  # each camera its own scene and walk
    orders = {tuple(kinfu.draw(seed, 16, 6)[0]) for seed in range(8)}
    assert len(orders) == 8


def test_z16_rounds_to_millimetres():
    z = scene.to_z16(torch.tensor([0.0, 1.2344, 1.2346, 70.0]), 0.001)
    assert z.to(torch.int32).tolist() == [0, 1234, 1235, 0]


def test_scene_matches_the_port_draws():
    from realsensetracker_tpu_torch.data import synthetic

    ours = scene.sphere_scene(3)
    theirs = synthetic.default_scene(seed=3)
    assert torch.equal(ours.centers, theirs.sphere_centers) and torch.equal(ours.radii, theirs.sphere_radii)
    pose = torch.eye(4)
    pose[0, 3] = 0.1
    cam = scene.Camera(**TINY["pairs.fr1.b512"][0]["camera"])
    from realsensetracker_tpu_torch.geometry import camera

    ref = synthetic.render_depth(camera.Intrinsics(*cam), pose, theirs)
    assert torch.allclose(scene.render_depths(cam, pose[None], ours)[0], ref, atol=1e-5)
    assert math.isclose(float((ref > 0).float().mean()), 1.0, abs_tol=0.05)
