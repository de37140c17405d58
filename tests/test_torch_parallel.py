"""The port's multi-device registration (realsensetracker_tpu_torch/parallel/
{mesh,multihost,sharded,batched,dryrun}.py) on 4 gloo ranks, against the
JAX package on the conftest's 8-device CPU mesh.

One module-scoped group of 4 spawned ranks (tests/torch_ranks.py) runs
every scenario; JAX runs in this process through its own sharded
functions, on the same numpy frames (8 pairs of 80x60 depth rendered by
the port, tests/test_parallel.py's shapes and configs). Bars, JAX's own
(tests/test_parallel.py:85-114): point-sharded poses and rmse within 1e-4
of JAX's point-sharded run and of the unsharded run (the all-reduce sums
the partial systems in another order); data-parallel poses within 1e-2 in
twist of the truth. Against the port's own unsharded path, where no sum is
reordered (pairs split over data ranks, point size 1), the sharded results
are exact.
"""

import jax
import numpy as np
import pytest

from realsensetracker_tpu.align import projective as jproj
from realsensetracker_tpu.parallel import batched as jbatched
from realsensetracker_tpu.parallel import mesh as jmesh
from realsensetracker_tpu.parallel import sharded as jsharded
from tests import torch_ranks
from tests.torch_parity import intrinsics, j32, pair, twist_gap

JINTR, INTR = intrinsics(60, 80, 80.0)
B = 8
CFGS = {
    "default": dict(iters=(6, 6, 8), samples=1024),  # tests/test_parallel.py:14
    "inner2": dict(iters=(3, 3, 4), inner_iters=2, samples=1024),  # :86
    "inner1": dict(iters=(3, 3, 4), inner_iters=1, samples=1024),
}
ATOL = 1e-4


@pytest.fixture(scope="module")
def batch():
    """(src (B,H,W), dst, truth (B,4,4)): pair i moved by a seeded twist."""
    rng = np.random.RandomState(1)
    out = [pair(INTR, 0.02 * rng.randn(6), seed=i) for i in range(B)]
    return tuple(np.stack(x).astype(np.float32) for x in zip(*out))


@pytest.fixture(scope="module")
def ranks(batch):
    src, dst, _ = batch
    return torch_ranks.run_ranks(4, torch_ranks.parallel_scenario, src, dst, INTR._asdict(), CFGS)


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        for a, b in zip(ranks[0][key], r[key]):
            np.testing.assert_array_equal(a, b)
    return ranks[0][key]


def test_eight_jax_devices_available():
    assert jax.device_count() >= 8


@pytest.mark.parametrize("pp", [1, 2, 4])
def test_mesh_shapes(ranks, pp):
    assert ranks[0]["shapes"][pp] == (4 // pp, pp)
    assert jmesh.make_mesh(8, point_parallelism=pp).shape["point"] == pp


def test_mesh_errors_and_balanced_mesh(ranks):
    errors = ranks[0]["errors"]
    assert errors["too_many"].startswith("ValueError: requested 8 devices, have 4")
    assert errors["pp"] == "ValueError: point_parallelism must divide n_devices"
    assert ranks[0]["balanced"] == (2, 2)


@pytest.mark.parametrize("name", ["default", "inner2", "inner1"])
@pytest.mark.parametrize("pp", [2, 4])
def test_point_sharded_matches_jax_and_unsharded(ranks, batch, name, pp):
    src, dst, _ = batch
    jcfg = jproj.ProjectiveIcpConfig(**CFGS[name])
    jT, jrmse = jsharded.register_batch_point_sharded(
        jmesh.make_mesh(8, point_parallelism=4), j32(src[:2]), j32(dst[:2]), JINTR, jcfg)
    T, rmse = _same_on_every_rank(ranks, f"point_{name}_pp{pp}")
    np.testing.assert_allclose(T, np.asarray(jT), rtol=0, atol=ATOL)
    np.testing.assert_allclose(rmse, np.asarray(jrmse), rtol=0, atol=ATOL)
    T_plain, rmse_plain = ranks[0][f"plain_{name}"]
    np.testing.assert_allclose(T, T_plain, rtol=0, atol=ATOL)
    np.testing.assert_allclose(rmse, rmse_plain, rtol=0, atol=ATOL)


def test_point_sharded_over_data_ranks_alone_is_exact(ranks):
    """Point size 1: each rank's pairs see the unsharded sums, bit for bit."""
    T, rmse = _same_on_every_rank(ranks, "point_data4")
    np.testing.assert_array_equal(T, ranks[0]["plain_all"][0])
    np.testing.assert_array_equal(rmse, ranks[0]["plain_all"][1])


def test_register_batch_sharded_data_parallel(ranks, batch):
    src, dst, truth = batch
    res = _same_on_every_rank(ranks, "data_parallel")
    assert res[0].shape == (B, 4, 4) and res[3].dtype == np.int32
    for got, want in zip(res, ranks[0]["plain_all"]):
        np.testing.assert_array_equal(got, want)
    for i in range(B):
        assert twist_gap(res[0][i], truth[i]) < 1e-2
    jres = jbatched.register_batch_sharded(jmesh.make_mesh(8), j32(src), j32(dst), JINTR,
                                           jproj.ProjectiveIcpConfig(**CFGS["default"]))
    np.testing.assert_allclose(res[0], np.asarray(jres.transform), rtol=0, atol=ATOL)
    # Each rank loading only its own pairs (global_frame_batch) is the same run.
    for r in ranks:
        np.testing.assert_array_equal(r["data_parallel_from_local"], res[0])


def test_multihost_helpers(ranks):
    for rank, r in enumerate(ranks):
        m = r["multihost"]
        assert m["slice"] == slice(2 * rank, 2 * rank + 2)
        assert m["uneven"].startswith("ValueError: num_streams=6 must be a multiple of process_count=4")
        assert m["global_shape"] == (8, 12, 16) and m["local_shape"] == (2, 12, 16)


def test_dryrun_checks_hold_on_four_ranks(ranks):
    """parallel.dryrun's checks (flagship registration at 640x480 within
    1e-5, 64^3 slab integrate and raycast, serving steps exact, atlas
    verify) on a 2x2 mesh of 4 ranks."""
    for r in ranks:
        d = r["dryrun"]
        assert d["mesh"] == [2, 2] and d["register_max_abs_err"] <= 1e-5
        assert d["integrate_max_abs_err"] == 0.0 and d["raycast_hit_share"] > 0.3


def test_dryrun_multichip_runs_two_cpu_ranks_and_refuses_missing_cards():
    import torch

    from realsensetracker_tpu_torch.parallel.dryrun import dryrun_multichip

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dryrun_multichip(2)
    d = dryrun_multichip(2, device="cpu")
    assert d["world"] == 2 and d["mesh"] == [1, 2] and d["register_max_abs_err"] <= 1e-5
