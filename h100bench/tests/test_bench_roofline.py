"""The roofline arithmetic reproduces the port's kernel table (PERF.md)."""

import pytest

from h100bench import roofline


def ms(work):
    return roofline.bound_s(*work) * 1e3


def test_level_kernel_bound_at_b512():
    shapes = [(480, 640), (240, 320), (120, 160), (60, 80)]
    assert ms(roofline.level_work(512, shapes)) == pytest.approx(1.247, abs=5e-4)


def test_downsample_bound_at_b512():
    nbytes, _ = roofline.downsample_work(512, 480, 640, [(240, 320), (120, 160), (60, 80)])
    assert nbytes == pytest.approx(887e6, rel=2e-3)
    assert ms(roofline.downsample_work(512, 480, 640, [(240, 320), (120, 160), (60, 80)])) == pytest.approx(
        0.265, abs=1e-3)


@pytest.mark.parametrize("voxels,updated,bound_ms", [(128**3, 260_347, 0.00161), (512**3, 16_700_000, 0.0800)])
def test_integrate_bound_128_and_512(voxels, updated, bound_ms):
    assert ms(roofline.integrate_work(640 * 480, updated)) == pytest.approx(bound_ms, rel=0.01)


@pytest.mark.parametrize("v,bound_ms", [(128, 0.0093), (512, 0.025)])
def test_raycast_bound_128_and_512(v, bound_ms):
    assert ms(roofline.march_work(20_700_000, 640 * 480, v ** 3)) == pytest.approx(bound_ms, rel=0.02)


def test_march_gathers_counts_steps_hits_and_gates():
    import torch

    out = torch.tensor([[0.0, 0.32], [0.151, 0.0]])
    gate = torch.tensor([[True, True], [True, False]])
    # Step 0.05 from 0.05, 10 steps: a miss takes all 10, the hits at 0.32
    # and 0.151 take 6 and 3; each ray one start sample, each hit 16 more.
    assert roofline.march_gathers(out, 0.05, None, 10, 0.05, 1) == 11 + 23 + 20 + 11
    assert roofline.march_gathers(out, 0.05, gate, 10, 0.05, 1) == 11 + 23 + 20
