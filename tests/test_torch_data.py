"""The port's data layer on the CPU, against the JAX package on the same
files: .rsc clips (realsensetracker_tpu_torch/data/recorded.py), TUM
sequences and the numpy + zlib PNG codec (data/tum.py), the protobuf cloud
reader (data/pb_interop.py) and the random sources (data/random_source.py).

Files are written once and both packages read them. The JAX package reads
clips through read_clip_py and PNGs through PIL (its native library stays
unbuilt: torch_parity.block_jax_native). Readers are held bit for bit in
both directions; the u16 millimeter quantization of a clip as in
tests/test_rgbd.py:79 (5.1e-4 m); ground-truth poses, whose rotation the
two packages rebuild from quaternions in their own f32 arithmetic, to
1e-6. Each PNG row filter (0-4) is held on a crafted file at 16-bit gray
and 8-bit RGB; every color type at every bit depth PIL reads, plain and
Adam7-interlaced, reads bit for bit as JAX's PIL paths read it, and files
PIL refuses raise.
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from realsensetracker_tpu.data import pb_interop as jpb
from realsensetracker_tpu.data import recorded as jrecorded
from realsensetracker_tpu.data import tum as jtum
from realsensetracker_tpu.geometry import camera as jcam
from realsensetracker_tpu_torch import interop
from realsensetracker_tpu_torch.data import pb_interop, random_source, recorded, synthetic, tum
from realsensetracker_tpu_torch.geometry import camera
from tests.torch_parity import block_jax_native

W, H = 64, 48


@pytest.fixture(scope="module", autouse=True)
def _jax_without_native():
    mp = pytest.MonkeyPatch()
    block_jax_native(mp)
    yield
    mp.undo()


def _same_clip(a, b):
    np.testing.assert_array_equal(a.depths, b.depths)
    np.testing.assert_array_equal(a.timestamps, b.timestamps)
    assert tuple(a.intrinsics) == tuple(b.intrinsics)
    assert (a.colors is None) == (b.colors is None)
    if a.colors is not None:
        np.testing.assert_array_equal(a.colors, b.colors)


def _arrays(seed, f=3, h=24, w=32):
    rng = np.random.default_rng(seed)
    depths = rng.uniform(0.5, 3.0, (f, h, w)).astype(np.float32)
    depths[:, 0, :4] = 0.0
    colors = rng.integers(0, 256, (f, h, w, 3), dtype=np.uint8)
    stamps = np.arange(f, dtype=np.float64) * 0.1
    args = dict(fx=30.0, fy=30.5, cx=15.5, cy=11.5, width=w, height=h)
    return depths, colors, stamps, jcam.Intrinsics(**args), camera.Intrinsics(**args)


# --- clips -----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [recorded.DTYPE_U16_MM, recorded.DTYPE_F32_M], ids=["u16mm", "f32m"])
@pytest.mark.parametrize("color", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_clip_files_cross_read(tmp_path, writer, color, dtype):
    """Either package's writer; both packages' readers agree bit for bit,
    and the two writers write the same bytes."""
    depths, colors, stamps, jintr, intr = _arrays(0)
    cols = colors if color else None
    pj, pp = str(tmp_path / "j.rsc"), str(tmp_path / "p.rsc")
    jrecorded.write_clip(pj, depths, stamps, jintr, dtype=dtype, colors=cols)
    recorded.write_clip(pp, depths, stamps, intr, dtype=dtype, colors=cols)
    assert open(pj, "rb").read() == open(pp, "rb").read()
    path = pj if writer == "jax" else pp
    ref = jrecorded.read_clip_py(path)
    _same_clip(recorded.read_clip(path), ref)
    _same_clip(recorded.read_clip_py(path), ref)
    assert recorded.read_clip(path).has_color == color
    if dtype == recorded.DTYPE_U16_MM:
        assert np.abs(ref.depths - depths).max() <= 5.1e-4  # u16 mm quantization
    else:
        np.testing.assert_array_equal(ref.depths, depths)


def test_clip_float_colors_scale_like_jax(tmp_path):
    depths, colors, stamps, jintr, intr = _arrays(1)
    pj, pp = str(tmp_path / "j.rsc"), str(tmp_path / "p.rsc")
    jrecorded.write_clip(pj, depths, stamps, jintr, colors=colors / 255.0)
    recorded.write_clip(pp, depths, stamps, intr, colors=colors / 255.0)
    assert open(pj, "rb").read() == open(pp, "rb").read()


def test_clip_gray_matches_jax(tmp_path):
    depths, colors, stamps, jintr, _ = _arrays(2)
    path = str(tmp_path / "c.rsc")
    jrecorded.write_clip(path, depths, stamps, jintr, colors=colors)
    for i in range(len(stamps)):
        np.testing.assert_array_equal(recorded.read_clip(path).gray(i), jrecorded.read_clip_py(path).gray(i))


def test_clip_bad_magic_raises(tmp_path):
    path = str(tmp_path / "bad.rsc")
    with open(path, "wb") as f:
        f.write(b"NOTACLIP" + b"\0" * 64)
    with pytest.raises(ValueError):
        recorded.read_clip_py(path)
    with pytest.raises(ValueError):
        recorded.read_clip(path)


@pytest.mark.parametrize("with_color", [False, True])
def test_record_synthetic_clip_read_by_jax(tmp_path, with_color):
    path = str(tmp_path / "syn.rsc")
    clip = recorded.record_synthetic_clip(path, num_frames=3, width=W, height=H, with_color=with_color)
    assert clip.depths.shape == (3, H, W) and np.isfinite(clip.depths).all() and clip.depths.max() > 0.5
    assert clip.has_color == with_color
    _same_clip(clip, jrecorded.read_clip_py(path))


@pytest.mark.parametrize("with_color", [False, True])
def test_record_synthetic_clip_returns_its_poses(tmp_path, with_color):
    path = str(tmp_path / "syn.rsc")
    clip, poses = recorded.record_synthetic_clip(path, num_frames=3, width=W, height=H, seed=4,
                                                 with_color=with_color, return_poses=True)
    intr = clip.intrinsics
    render = synthetic.render_trajectory_rgbd if with_color else synthetic.render_trajectory
    rendered = render(intr, 3, seed=4)
    assert poses.shape == (3, 4, 4) and torch.equal(poses, rendered[-1])
    # The clip stores u16 millimetres: half a step of quantization.
    np.testing.assert_allclose(clip.depths, rendered[0].numpy(), rtol=0, atol=5e-4 + 1e-6)


def test_clip_from_jax(tmp_path):
    depths, colors, stamps, jintr, _ = _arrays(3)
    path = str(tmp_path / "c.rsc")
    jrecorded.write_clip(path, depths, stamps, jintr, colors=colors)
    jclip = jrecorded.read_clip_py(path)
    clip = interop.clip_from_jax(jclip)
    assert isinstance(clip.intrinsics, camera.Intrinsics)
    _same_clip(clip, jclip)


# --- TUM sequences ---------------------------------------------------------------


@pytest.fixture(scope="module")
def port_seq(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_seq") / "seq")
    return tum.synthesize_tum_sequence(root, num_frames=4, width=W, height=H, with_color=True)


@pytest.fixture(scope="module")
def jax_seq(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jax_seq") / "seq")
    return jtum.synthesize_tum_sequence(root, num_frames=3, width=W, height=H, with_color=True)


def test_tum_index_association_and_groundtruth_match_jax(port_seq):
    seq, jseq = tum.TumSequence.open(port_seq), jtum.TumSequence.open(port_seq)
    assert seq.depth_index == jseq.depth_index and seq.rgb_index == jseq.rgb_index
    assert len(seq) == len(jseq) == 4
    for (t, v), (jt, jv) in zip(seq.groundtruth, jseq.groundtruth):
        assert t == jt
        np.testing.assert_array_equal(v, jv)
    for i in range(len(seq)):
        assert seq.timestamp(i) == jseq.timestamp(i)
        for dt in (0.05, 0.001):
            assert seq.associate_rgb(i, dt) == jseq.associate_rgb(i, dt)
    gt, jgt = seq.groundtruth_trajectory(), jseq.groundtruth_trajectory()
    assert gt.timestamps == jgt.timestamps
    np.testing.assert_allclose(np.stack(gt.poses), np.stack(jgt.poses), atol=1e-6)


def test_tum_association_edges(tmp_path):
    """Nearest rgb within max_dt, ties to the earlier stamp, none beyond."""
    root = tmp_path / "s"
    root.mkdir()
    (root / "depth.txt").write_text("# depth\n1.00 d/a.png\n1.10 d/b.png\n2.00 d/c.png\n")
    (root / "rgb.txt").write_text("0.98 r/a.png\n1.05 r/b.png\n1.15 r/c.png\n")
    seq, jseq = tum.TumSequence.open(str(root)), jtum.TumSequence.open(str(root))
    got = [seq.associate_rgb(i) for i in range(3)]
    assert got == [jseq.associate_rgb(i) for i in range(3)]
    assert got[2] is None and seq.groundtruth == []


def test_port_written_pngs_read_by_jax_pil_path(port_seq):
    seq, jseq = tum.TumSequence.open(port_seq), jtum.TumSequence.open(port_seq)
    for i in range(len(seq)):
        np.testing.assert_array_equal(seq.depth_raw(i), jseq.depth_raw(i))  # JAX: PIL
        np.testing.assert_array_equal(seq.depth(i), jseq.depth(i))
        np.testing.assert_array_equal(seq.rgb(i), jseq.rgb(i))
        path = os.path.join(port_seq, seq.depth_index[i][1])
        np.testing.assert_array_equal(tum.read_png(path), np.asarray(Image.open(path)).astype(np.uint16))


def test_jax_written_pngs_read_by_port(jax_seq):
    seq, jseq = tum.TumSequence.open(jax_seq), jtum.TumSequence.open(jax_seq)
    for i in range(len(seq)):
        path = os.path.join(jax_seq, seq.depth_index[i][1])
        ref = np.asarray(Image.open(path)).astype(np.uint16)
        np.testing.assert_array_equal(seq.depth_raw(i), ref)  # native
        np.testing.assert_array_equal(tum.read_png(path), ref)  # numpy
        np.testing.assert_array_equal(seq.depth(i), jseq.depth(i))
        np.testing.assert_array_equal(seq.rgb(i), jseq.rgb(i))
        np.testing.assert_array_equal(tum.rgb_to_gray(seq.rgb(i)), jtum.rgb_to_gray(jseq.rgb(i)))


@pytest.mark.parametrize("raw", [False, True])
def test_tum_batches_and_frames_match_jax(port_seq, raw):
    seq, jseq = tum.TumSequence.open(port_seq), jtum.TumSequence.open(port_seq)
    np.testing.assert_array_equal(seq.load_depth_batch(range(4), raw=raw), jseq.load_depth_batch(range(4), raw=raw))
    for batch in (1, 3):
        got = list(seq.frames(start=1, stop=4, batch_decode=batch, raw=raw))
        ref = list(jseq.frames(start=1, stop=4, batch_decode=batch, raw=raw))
        assert [t for t, _ in got] == [t for t, _ in ref]
        for (_, a), (_, b) in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    rgbd, jrgbd = list(seq.frames_rgbd(stop=3)), list(jseq.frames_rgbd(stop=3))
    for (t, d, g), (jt, jd, jg) in zip(rgbd, jrgbd):
        assert t == jt
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(g, jg)


def test_tum_depth_png_scale(tmp_path):
    p = str(tmp_path / "d.png")
    tum.write_png(p, np.full((8, 8), 5000, np.uint16))  # 1 meter
    np.testing.assert_allclose(tum.load_depth_png(p), 1.0)
    np.testing.assert_array_equal(tum.load_depth_png(p), jtum.load_depth_png(p))


# --- the PNG codec, one row filter at a time ---------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _crafted_png(image: np.ndarray, filt: int) -> bytes:
    """A PNG whose every row uses row filter ``filt``: 16-bit gray for a
    uint16 image, 8-bit RGB for an (H, W, 3) uint8 one."""
    if image.dtype == np.uint16:
        depth, color, bpp = 16, 0, 2
        rows = image.astype(">u2").view(np.uint8).reshape(image.shape[0], -1).astype(np.int64)
    else:
        depth, color, bpp = 8, 2, 3
        rows = image.reshape(image.shape[0], -1).astype(np.int64)
    h, stride = rows.shape
    up = np.vstack([np.zeros((1, stride), np.int64), rows[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int64), rows[:, :-bpp]])
    upleft = np.hstack([np.zeros((h, bpp), np.int64), up[:, :-bpp]])
    pred = {0: 0, 1: left, 2: up, 3: (left + up) // 2, 4: _paeth(left, up, upleft)}[filt]
    filtered = np.hstack([np.full((h, 1), filt), (rows - pred) % 256]).astype(np.uint8)

    def chunk(kind, payload):
        return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", zlib.crc32(kind + payload))

    ihdr = struct.pack(">IIBBBBB", image.shape[1], h, depth, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(filtered.tobytes()))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("fmt", ["gray16", "rgb8"])
def test_png_row_filter(tmp_path, fmt, filt):
    rng = np.random.default_rng(10 + filt)
    if fmt == "gray16":
        image = rng.integers(0, 65536, (13, 21), dtype=np.uint16)
        image[4:8] = np.round(rng.uniform(0.5, 4.0, (4, 21)) * 5000).astype(np.uint16)  # smooth rows too
    else:
        image = rng.integers(0, 256, (11, 17, 3), dtype=np.uint8)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_crafted_png(image, filt))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), image)  # the crafted file is valid
    np.testing.assert_array_equal(tum.read_png(path), image)
    if fmt == "gray16":
        np.testing.assert_array_equal(tum.load_depth_png_raw(path), image)  # native
    else:
        np.testing.assert_array_equal(tum.load_rgb_png(path), image)


@pytest.mark.parametrize("fmt", ["gray16", "rgb8"])
def test_png_writer_read_by_pil(tmp_path, fmt):
    rng = np.random.default_rng(20)
    image = {"gray16": lambda: rng.integers(0, 65536, (9, 14), dtype=np.uint16),
             "rgb8": lambda: rng.integers(0, 256, (9, 14, 3), dtype=np.uint8)}[fmt]()
    path = str(tmp_path / "w.png")
    tum.write_png(path, image)
    np.testing.assert_array_equal(np.asarray(Image.open(path)).astype(image.dtype), image)
    np.testing.assert_array_equal(tum.read_png(path), image)


def test_png_decoder_rejects_bad_input(tmp_path):
    good = tum.encode_png(np.zeros((4, 4), np.uint16))
    with pytest.raises(ValueError, match="signature"):
        tum.decode_png(b"nonsense" + good[8:])
    with pytest.raises(ValueError, match="CRC"):
        tum.decode_png(good[:20] + bytes([good[20] ^ 1]) + good[21:])
    with pytest.raises(ValueError, match="unsupported"):
        tum.decode_png(_with_ihdr(good, depth=16, color=3))  # palette at 16 bits


def _with_ihdr(png: bytes, depth: int, color: int) -> bytes:
    ihdr = struct.pack(">IIBBBBB", 4, 4, depth, color, 0, 0, 0)
    chunk = struct.pack(">I", 13) + b"IHDR" + ihdr + struct.pack(">I", zlib.crc32(b"IHDR" + ihdr))
    return png[:8] + chunk + png[8 + 25:]


# --- every PNG format PIL reads (color type, bit depth, Adam7) -----------------------

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_FORMATS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4), (3, 8),
            (4, 8), (4, 16), (6, 8), (6, 16)]


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, n) samples -> (h, stride) scanline bytes, sub-byte samples
    packed most significant bits first."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(samples.shape[0], -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    s = np.pad(samples, ((0, 0), (0, -samples.shape[1] % per))).reshape(samples.shape[0], -1, per)
    return (s << (8 - depth * (np.arange(per) + 1))).sum(-1).astype(np.uint8)


def _filtered(rows: np.ndarray, bpp: int, rng) -> bytes:
    """Scanlines with a random row filter (0-4) each, as an encoder may pick."""
    rows = rows.astype(np.int64)
    h, stride = rows.shape
    up = np.vstack([np.zeros((1, stride), np.int64), rows[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int64), rows[:, :-bpp]])
    upleft = np.hstack([np.zeros((h, bpp), np.int64), up[:, :-bpp]])
    preds = [np.zeros_like(rows), left, up, (left + up) // 2, _paeth(left, up, upleft)]
    kinds = rng.integers(0, 5, h)
    out = np.stack([np.concatenate([[k], (rows[y] - preds[k][y]) % 256]) for y, k in enumerate(kinds)])
    return out.astype(np.uint8).tobytes()


def _png_bytes(samples, depth, color, rng, interlace=0, plte=None, trns=None) -> bytes:
    """A PNG of (H, W, C) samples written by hand (zlib + CRC), plain or
    Adam7, with optional PLTE and tRNS chunks."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    lattices = _ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b"".join(_filtered(_pack(sub.reshape(sub.shape[0], -1), depth), bpp, rng)
                   for sub in (samples[y0::dy, x0::dx] for x0, y0, dx, dy in lattices) if sub.size)

    def chunk(kind, payload):
        return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", zlib.crc32(kind + payload))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    out += chunk(b"PLTE", plte) if plte is not None else b""
    out += chunk(b"tRNS", trns) if trns is not None else b""
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def _reads_like_jax(path, gray):
    """The port's loaders against JAX's PIL paths, bit for bit (dtype too)."""
    ref = jtum.load_rgb_png(path)
    got = tum.load_rgb_png(path)
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    if gray:
        ref = jtum.load_depth_png_raw(path)
        got = tum.load_depth_png_raw(path)
        assert got.dtype == ref.dtype == np.uint16
        np.testing.assert_array_equal(got, ref)
    else:
        with pytest.raises(ValueError, match="not a depth frame"):
            tum.load_depth_png_raw(path)


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("color,depth", _FORMATS, ids=[f"type{c}-{d}bit" for c, d in _FORMATS])
def test_png_format_reads_like_jax(tmp_path, color, depth, interlace):
    """Every color type at every bit depth PIL reads, plain and Adam7, on a
    13x11 image (odd sizes leave Adam7 passes partial and sub-byte rows
    padded), random row filters; the palette is short (missing entries
    read black) and carries a tRNS chunk that convert("RGB") ignores."""
    rng = np.random.default_rng(100 * color + depth + 7 * interlace)
    samples = rng.integers(0, 2**depth, (13, 11, _CHANNELS[color]))
    if color == 0 and depth == 16:
        samples[0, :4, 0] = [0, 255, 256, 1000]  # around convert("RGB")'s clip
    plte = trns = None
    if color == 3:
        n = max(1, 2**depth * 3 // 4)
        plte = rng.integers(0, 256, 3 * n).astype(np.uint8).tobytes()
        trns = bytes([0, 128])
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png_bytes(samples, depth, color, rng, interlace, plte, trns))
    _reads_like_jax(path, gray=color == 0)


@pytest.mark.parametrize("mode", ["1", "L", "P", "LA", "RGBA", "I;16"])
def test_pil_written_png_reads_like_jax(tmp_path, mode):
    """Files PIL writes itself in each of its PNG modes (P with a
    transparent index)."""
    rng = np.random.default_rng(30)
    if mode == "I;16":
        img = Image.fromarray(rng.integers(0, 65536, (15, 19), dtype=np.uint16))
    elif mode == "1":
        img = Image.fromarray(rng.integers(0, 2, (15, 19), dtype=np.uint8) * 255).convert("1")
    else:
        img = Image.fromarray(rng.integers(0, 256, (15, 19, 3), dtype=np.uint8)).convert(mode)
    path = str(tmp_path / "p.png")
    img.save(path, **({"transparency": 3} if mode == "P" else {}))
    assert Image.open(path).mode == mode
    _reads_like_jax(path, gray=mode in ("1", "L", "I;16"))


_BAD_HEADERS = {"palette-16bit": (16, 3), "rgb-4bit": (4, 2), "rgba-2bit": (2, 6), "color-type-5": (8, 5)}


def _refused(case: str) -> bytes:
    rng = np.random.default_rng(40)
    good = _png_bytes(rng.integers(0, 256, (4, 4, 1)), 8, 0, rng)
    if case in _BAD_HEADERS:
        return _with_ihdr(good, *_BAD_HEADERS[case])
    i = good.index(b"IDAT") - 4
    (n,) = struct.unpack(">I", good[i:i + 4])
    if case == "corrupt-stream":
        return good[:i + 10] + bytes([good[i + 10] ^ 0xFF]) + good[i + 11:]
    payload = zlib.compress(zlib.decompress(good[i + 8:i + 8 + n])[:-3])  # "truncated-data"
    chunk = struct.pack(">I", len(payload)) + b"IDAT" + payload + struct.pack(">I", zlib.crc32(b"IDAT" + payload))
    return good[:i] + chunk + good[i + 12 + n:]


@pytest.mark.parametrize("case", ["palette-16bit", "rgb-4bit", "rgba-2bit", "color-type-5", "truncated-data",
                                  "corrupt-stream"])
def test_png_that_pil_refuses_raises(tmp_path, case):
    path = str(tmp_path / "bad.png")
    with open(path, "wb") as f:
        f.write(_refused(case))
    with pytest.raises(Exception):
        jtum.load_rgb_png(path)
    with pytest.raises(ValueError):
        tum.load_rgb_png(path)
    with pytest.raises(ValueError):
        tum.load_depth_png_raw(path)


# --- protobuf clouds ---------------------------------------------------------------


@pytest.mark.parametrize("with_colors", [False, True])
def test_pb_cloud_same_bytes_and_parse(tmp_path, with_colors):
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    cols = rng.uniform(size=(50, 3)).astype(np.float32) if with_colors else None
    pj, pp = str(tmp_path / "j.pb"), str(tmp_path / "p.pb")
    jpb.write_pb_cloud(pj, pts, cols)
    pb_interop.write_pb_cloud(pp, pts, cols)
    assert open(pj, "rb").read() == open(pp, "rb").read()
    got, jgot = pb_interop.read_pb_cloud(pj), jpb.read_pb_cloud(pj)
    np.testing.assert_array_equal(got[0], jgot[0])
    np.testing.assert_array_equal(got[0], pts)
    assert (got[1] is None) == (jgot[1] is None) == (not with_colors)
    if with_colors:
        np.testing.assert_array_equal(got[1], jgot[1])


def test_pb_cloud_rejects_garbage():
    for data in (b"\xff\xff\xff", b"\x0a\x02\x01\x02"):
        with pytest.raises(ValueError):
            jpb.parse_pb_cloud(data)
        with pytest.raises(ValueError):
            pb_interop.parse_pb_cloud(data)


# --- random sources (tests/test_data.py:131-149) -------------------------------------


def test_random_cloud_source():
    src = random_source.RandomCloudSource(size=64, timestep=0.5, device="cpu")
    c, ts = src.get_cloud(1.0)
    assert ts == 1.5
    assert c.capacity == 64 and bool(c.mask.all())
    assert c.points.min().item() >= -1.0 and c.points.max().item() <= 1.0
    again = random_source.RandomCloudSource(size=64, timestep=0.5, device="cpu").get_cloud(1.0)[0]
    assert torch.equal(again.points, c.points)  # seeded
    assert not torch.equal(src.get_cloud(ts)[0].points, c.points)  # advances


def test_random_depth_source():
    src = random_source.RandomDepthSource(intr=camera.Intrinsics(30.0, 30.0, 15.5, 11.5, 32, 32), device="cpu")
    d, ts = src.get_depth(0.0)
    assert d.shape == (32, 32) and d.dtype == torch.float32
    assert d.min().item() >= 0.9 and d.max().item() <= 3.0
    assert ts == pytest.approx(1.0 / 30.0)


def test_random_sources_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves")
    with pytest.raises(RuntimeError, match="needs CUDA"):
        random_source.RandomCloudSource()
    with pytest.raises(RuntimeError, match="needs CUDA"):
        random_source.RandomDepthSource()


def test_gray8_png_reads_like_pil(tmp_path):
    """An 8-bit gray PNG (PIL's adaptive filters): the numpy decoder and
    the native one widen it as the JAX package's readers do, and an RGB
    frame read from it replicates the gray plane (PIL's convert("RGB"))."""
    arr = np.random.default_rng(21).integers(0, 256, (19, 27), dtype=np.uint8)
    path = str(tmp_path / "g.png")
    Image.fromarray(arr).save(path)
    np.testing.assert_array_equal(tum.read_png(path), arr)
    np.testing.assert_array_equal(tum.load_depth_png_raw(path), jtum.load_depth_png_raw(path))
    np.testing.assert_array_equal(tum.load_rgb_png(path), jtum.load_rgb_png(path))
