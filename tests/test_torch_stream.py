"""The port's FrameStream (realsensetracker_tpu_torch/data/stream.py) on
the CPU: the cases of tests/test_data.py:74-128 on ``device="cpu"``
(order, stream_clip, a producer error re-raised in the consumer, a second
pass raising, close() unblocking the producer), poll() and the context
manager, the staging policy (raw uint16 stays uint16, tuple frames with
None entries), a caller's transfer, stream_tum against the JAX package's on
the same sequence, and the default device raising without CUDA. The card's
path (pinned staging, a side stream, events) is held in
tests/test_torch_cuda.py.
"""

import threading
import time

import numpy as np
import pytest
import torch

from realsensetracker_tpu.data import stream as jstream
from realsensetracker_tpu.data import tum as jtum
from realsensetracker_tpu_torch.data import recorded, stream, tum
from tests.torch_parity import block_jax_native


@pytest.fixture(scope="module", autouse=True)
def _jax_without_native():
    mp = pytest.MonkeyPatch()
    block_jax_native(mp)
    yield
    mp.undo()


def test_prefetch_order_preserved():
    src = [(float(i), np.full((4, 4), i, np.float32)) for i in range(10)]
    fs = stream.FrameStream(iter(src), prefetch=3, device="cpu")
    got = [(ts, float(d[0, 0])) for ts, d in fs]
    assert got == [(float(i), float(i)) for i in range(10)]


def test_stream_clip(tmp_path):
    path = str(tmp_path / "c.rsc")
    clip = recorded.record_synthetic_clip(path, num_frames=3, width=32, height=24)
    frames = list(stream.stream_clip(clip, device="cpu"))
    assert len(frames) == 3
    for (ts, d), i in zip(frames, range(3)):
        assert ts == clip.timestamps[i]
        assert isinstance(d, torch.Tensor) and d.dtype == torch.float32
        np.testing.assert_array_equal(d.numpy(), clip.depths[i])


def test_producer_error_propagates():
    """A corrupt frame mid-sequence must not look like a clean end of
    stream (a replay would otherwise 'complete' on a truncated sequence)."""

    def src():
        yield 0.0, np.zeros((4, 4), np.float32)
        yield 1.0, np.zeros((4, 4), np.float32)
        raise IOError("corrupt frame 2")

    fs = stream.FrameStream(src(), prefetch=2, device="cpu")
    got = []
    with pytest.raises(RuntimeError, match="producer failed") as info:
        for ts, _ in fs:
            got.append(ts)
    assert got == [0.0, 1.0]
    assert isinstance(info.value.__cause__, IOError)


def test_reiteration_raises_instead_of_hanging():
    src = [(float(i), np.zeros((2, 2), np.float32)) for i in range(3)]
    fs = stream.FrameStream(iter(src), device="cpu")
    assert len(list(fs)) == 3
    assert fs.exhausted
    with pytest.raises(RuntimeError, match="single-pass"):
        list(fs)


def test_close_unblocks_producer():
    src = ((float(i), np.zeros((2, 2), np.float32)) for i in range(100))
    with stream.FrameStream(src, prefetch=1, device="cpu") as fs:
        it = iter(fs)
        next(it)  # start the producer; the queue fills and put() blocks
        time.sleep(0.1)
    fs._thread.join(timeout=5.0)
    assert not fs._thread.is_alive()
    assert fs.exhausted
    assert threading.active_count() < 50


def test_poll_returns_frames_then_none():
    src = [(float(i), np.full((2, 2), i, np.float32)) for i in range(3)]
    fs = stream.FrameStream(iter(src), prefetch=4, device="cpu")
    got, deadline = [], time.time() + 10.0
    while not fs.exhausted and time.time() < deadline:
        item = fs.poll()
        if item is None:
            time.sleep(0.01)
            continue
        got.append(item[0])
    assert got == [0.0, 1.0, 2.0] and fs.exhausted
    assert fs.poll() is None  # nothing more after the end
    fs.close()


def test_min_interval_paces_the_producer():
    src = [(float(i), np.zeros((2, 2), np.float32)) for i in range(4)]
    t0 = time.monotonic()
    assert len(list(stream.FrameStream(iter(src), min_interval_s=0.05, device="cpu"))) == 4
    assert time.monotonic() - t0 >= 0.14  # three waits of 50 ms between four frames


def test_staging_keeps_raw_u16_and_tuple_frames():
    depth = np.arange(12, dtype=np.uint16).reshape(3, 4)
    wide = np.array([[0, 70000]], np.int32)  # raw as it comes: the tracker owns the unit
    meters = np.array([[0.25, 1.5]], np.float64)  # float64 becomes f32, as a JAX device_put
    gray = np.full((3, 4), 0.5, np.float32)
    src = [(0.0, depth), (1.0, (depth, gray)), (2.0, (depth, None)), (3.0, wide), (4.0, meters)]
    out = list(stream.FrameStream(iter(src), device="cpu"))
    assert out[0][1].dtype == torch.uint16 and torch.equal(out[0][1].to(torch.int32),
                                                            torch.from_numpy(depth.astype(np.int32)))
    d, g = out[1][1]
    assert d.dtype == torch.uint16 and g.dtype == torch.float32 and torch.equal(g, torch.from_numpy(gray))
    assert out[2][1][1] is None
    assert out[3][1].dtype == torch.int32
    np.testing.assert_array_equal(out[3][1].numpy(), wide)
    assert out[4][1].dtype == torch.float32
    np.testing.assert_array_equal(out[4][1].numpy(), meters.astype(np.float32))


def test_caller_transfer_wins():
    src = [(float(i), np.full((2, 2), i, np.float32)) for i in range(3)]
    out = list(stream.FrameStream(iter(src), transfer=lambda f: ("staged", f.sum()), device="cpu"))
    assert [f for _, f in out] == [("staged", 0.0), ("staged", 4.0), ("staged", 8.0)]


@pytest.mark.parametrize("raw", [False, True])
def test_stream_tum_matches_jax(tmp_path, raw):
    root = tum.synthesize_tum_sequence(str(tmp_path / "seq"), num_frames=5, width=32, height=24)
    seq, jseq = tum.TumSequence.open(root), jtum.TumSequence.open(root)
    got = list(stream.stream_tum(seq, start=1, stop=4, raw=raw, device="cpu"))
    ref = list(jstream.FrameStream(jseq.frames(start=1, stop=4, raw=raw), transfer=lambda x: x))
    assert [t for t, _ in got] == [t for t, _ in ref] == [seq.timestamp(i) for i in (1, 2, 3)]
    for (_, a), (_, b) in zip(got, ref):
        assert a.dtype == (torch.uint16 if raw else torch.float32)
        np.testing.assert_array_equal(a.numpy(), b)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves")
    src = [(0.0, np.zeros((2, 2), np.float32))]
    with pytest.raises(RuntimeError, match="needs CUDA"):
        stream.FrameStream(iter(src))
    clip = recorded.Clip(depths=np.zeros((1, 2, 2), np.float32), timestamps=np.zeros(1), intrinsics=None)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        stream.stream_clip(clip)
