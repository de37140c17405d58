"""Parity of the port's loop-closure detector with the JAX package.

The keyframes of tests/test_posegraph_loops.py:227-330 (Gaussian clouds,
uniform features, drawn by jax.random and handed to both packages as
numpy): descriptors within 1e-6, query hits identical (ids in the same
order, similarities within 1e-6), the 200-keyframe store through its
capacity doublings; geometric verification of the revisit pair (a cloud
and its copy under a known transform, shared features): T within 1e-4
and ok equal, single and batched, pad_to's truncation as JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realsensetracker_tpu.geometry import se3 as jse3
from realsensetracker_tpu.loop_closure import KeyframeDatabase as JKeyframeDatabase
from realsensetracker_tpu.loop_closure import global_descriptor as jglobal_descriptor
from realsensetracker_tpu.ops import cloud as jcloud
from realsensetracker_tpu_torch.loop_closure import KeyframeDatabase, global_descriptor
from realsensetracker_tpu_torch.loop_closure.detector import DESCRIPTOR_DIM
from realsensetracker_tpu_torch.ops.cloud import Cloud

# pytest-xdist runs 6 workers on 8 cores: keep each one to a few threads.
torch.set_num_threads(2)


def _keyframe(seed, n=256):
    """(points (n,3), features (n,33)) as numpy f32, as the JAX test draws them."""
    pts = jax.random.normal(jax.random.PRNGKey(seed), (n, 3), jnp.float32)
    feats = jax.random.uniform(jax.random.PRNGKey(seed + 100), (n, 33), jnp.float32)
    return np.asarray(pts), np.asarray(feats)


def _port(pts, feats, mask=None):
    mask = np.ones(len(pts), bool) if mask is None else mask
    return Cloud(torch.from_numpy(pts), torch.from_numpy(mask)), torch.from_numpy(feats)


def _jax(pts, feats, mask=None):
    mask = np.ones(len(pts), bool) if mask is None else mask
    return jcloud.Cloud(points=jnp.asarray(pts), mask=jnp.asarray(mask)), jnp.asarray(feats)


@pytest.mark.parametrize("masked", ["all", "half", "none"])
def test_global_descriptor_matches_jax(masked):
    pts, feats = _keyframe(0)
    mask = {"all": np.ones(256, bool), "half": np.arange(256) % 2 == 0, "none": np.zeros(256, bool)}[masked]
    got = global_descriptor(torch.from_numpy(feats), torch.from_numpy(mask)).numpy()
    ref = np.asarray(jglobal_descriptor(jnp.asarray(feats), jnp.asarray(mask)))
    assert got.shape == (DESCRIPTOR_DIM,)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    if masked != "none":
        assert abs(np.linalg.norm(got) - 1.0) < 1e-5


@pytest.fixture(scope="module")
def stores():
    """The 200-keyframe store (capacity 64, so it doubles twice) in both
    packages."""
    kfs = [_keyframe(s, n=128) for s in range(200)]
    db = KeyframeDatabase(min_separation=5, similarity_threshold=0.9, capacity=64)
    jdb = JKeyframeDatabase(min_separation=5, similarity_threshold=0.9, capacity=64)
    for i, (p, f) in enumerate(kfs):
        db.add(i, *_port(p, f))
        jdb.add(i, *_jax(p, f))
    return kfs, db, jdb


def test_store_grows_and_matches_jax(stores):
    kfs, db, jdb = stores
    assert len(db) == len(jdb) == 200
    assert db._desc.shape[0] == jdb._desc.shape[0] == 256
    np.testing.assert_allclose(db._desc.numpy(), np.asarray(jdb._desc), atol=1e-6)
    np.testing.assert_array_equal(db._pts.numpy(), np.asarray(jdb._pts))
    np.testing.assert_array_equal(db._feats.numpy(), np.asarray(jdb._feats))


@pytest.mark.parametrize("query", [(0, 500, 3), (17, 500, 5), (3, 5, 3), (42, 1 << 30, 3)],
                         ids=["revisit", "top5", "nearby", "far_id"])
def test_query_hits_match_jax(stores, query):
    """Hits in the same order with the same ids; similarities within 1e-6."""
    kfs, db, jdb = stores
    k, frame_id, top_k = query
    got = db.query(frame_id, *_port(*kfs[k]), top_k=top_k)
    ref = jdb.query(frame_id, *_jax(*kfs[k]), top_k=top_k)
    assert [c for c, _ in got] == [c for c, _ in ref]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in ref], atol=1e-6)
    if query[0] == 0:
        assert got and got[0][0] == 0 and got[0][1] > 0.99


def test_query_with_precomputed_descriptor_and_empty_store():
    pts, feats = _keyframe(1)
    db = KeyframeDatabase(min_separation=10)
    cloud, f = _port(pts, feats)
    assert db.query(5, cloud, f) == []
    db.add(0, cloud, f)
    assert db.query(5, cloud, f) == []  # too close in time
    desc = global_descriptor(f, cloud.mask)
    assert db.query(50, cloud, f) == db.query(50, cloud, f, desc=desc)


def _revisit_pair():
    """tests/test_posegraph_loops.py:256-270: a cloud, its copy under a known
    transform, shared Gaussian features."""
    pts = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (256, 3), jnp.float32))
    feats = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (256, 33), jnp.float32))
    T_true = np.asarray(jse3.exp(jnp.asarray([0.3, -0.2, 0.1, 0.5, 0.4, -0.3], jnp.float32)))
    moved = (pts.astype(np.float64) @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)
    return pts, moved, feats, T_true


@pytest.fixture(scope="module")
def revisit():
    pts, moved, feats, T_true = _revisit_pair()
    db, jdb = KeyframeDatabase(min_separation=1), JKeyframeDatabase(min_separation=1)
    db.add(0, *_port(pts, feats))
    jdb.add(0, *_jax(pts, feats))
    return pts, moved, feats, T_true, db, jdb


def test_verify_matches_jax_on_the_revisit_pair(revisit):
    pts, moved, feats, T_true, db, jdb = revisit
    T, ok = db.verify(30, *_port(moved, feats), 0, noise_bound=0.1)
    jT, jok = jdb.verify(30, *_jax(moved, feats), 0, noise_bound=0.1)
    assert ok == jok and ok
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=1e-4)
    np.testing.assert_allclose(T.numpy() @ T_true, np.eye(4), atol=2e-2)


def test_verify_batch_matches_single_and_truncates_to_pad_to(revisit):
    pts, moved, feats, T_true, db, jdb = revisit
    db.add(1, *_port(*_keyframe(7)))
    jdb.add(1, *_jax(*_keyframe(7)))
    q, jq = _port(moved, feats), _jax(moved, feats)
    batch = db.verify_batch(30, *q, [0, 1], noise_bound=0.1)
    jbatch = jdb.verify_batch(30, *jq, [0, 1], noise_bound=0.1)
    assert [ok for _, ok in batch] == [ok for _, ok in jbatch] == [True, False]
    np.testing.assert_allclose(batch[0][0], jbatch[0][0], atol=1e-4)
    single = db.verify(30, *q, 0, noise_bound=0.1)
    np.testing.assert_allclose(single[0].numpy(), batch[0][0], atol=1e-6)
    capped = db.verify_batch(30, *q, [0, 1, 0, 1], noise_bound=0.1, pad_to=2)
    assert len(capped) == 2 and [ok for _, ok in capped] == [True, False]
    assert db.verify_batch_async(30, *q, []) is None and db.verify_batch(30, *q, []) == []


def test_verify_batch_on_the_200_keyframe_store(stores):
    """tests/test_posegraph_loops.py:272-320 on the port: the batch's
    verdicts equal one-at-a-time verification (T within 1e-6 where
    accepted) and JAX's; keyframe 0 against its own content verifies as
    identity."""
    kfs, db, jdb = stores
    q, jq = _port(*kfs[0]), _jax(*kfs[0])
    cands = [0, 3, 17]
    batch = db.verify_batch(500, *q, cands, noise_bound=0.1)
    jbatch = jdb.verify_batch(500, *jq, cands, noise_bound=0.1)
    assert [ok for _, ok in batch] == [ok for _, ok in jbatch]
    for cid, (T_b, ok_b) in zip(cands, batch):
        T_s, ok_s = db.verify(500, *q, cid, noise_bound=0.1)
        assert ok_b == ok_s
        if ok_b:
            np.testing.assert_allclose(T_s.numpy(), T_b, atol=1e-6)
    T0, ok0 = batch[0]
    assert ok0 and np.abs(T0 - np.eye(4)).max() < 1e-2
