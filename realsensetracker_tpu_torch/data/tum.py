"""TUM RGB-D dataset loader (fr1/desk is the BASELINE parity dataset).

Port of realsensetracker_tpu/data/tum.py. TUM format: a per-sequence
directory with depth/ (16-bit PNG, meters = value / 5000), rgb/ (8-bit RGB
PNG) and the timestamped index files depth.txt, rgb.txt and
groundtruth.txt.

Depth PNGs decode through the native thread-pooled decoder
(native/src/png16.cpp) when the port's native library loads. Where the JAX
package calls PIL (depth the native decoder refuses, every RGB frame, and
writing synthetic sequences), this module has its own numpy + zlib PNG
codec: the reader takes every format PIL reads (gray at 1, 2, 4, 8 and 16
bits, RGB at 8 and 16, palette at 1 to 8, gray+alpha and RGBA at 8 and
16, each plain or Adam7-interlaced, all five row filters) and gives what
PIL gives; the writer writes 16-bit gray and 8-bit RGB with the Up filter.
"""

from __future__ import annotations

import bisect
import ctypes
import os
import struct
import zlib
from dataclasses import dataclass

import numpy as np

DEPTH_SCALE = 5000.0  # TUM convention: png_value / 5000 = meters

# --- PNG codec (numpy + zlib) ---------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> (samples per pixel, the bit depths PIL reads it at):
# gray, RGB, palette, gray+alpha, RGBA (PIL's PngImagePlugin._MODES).
_PNG_FORMATS = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)),
                6: (4, (8, 16))}
# Adam7 passes: (x0, y0, dx, dy) of each pass's pixel lattice.
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_chunks(data: bytes):
    """Yield (type, payload) of each chunk, CRC-checked."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        if pos + 12 + length > len(data):
            raise ValueError(f"PNG chunk {kind!r}: truncated")
        payload = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends without an IEND chunk")


def _unfilter_row_sequential(kind: int, row: np.ndarray, up: np.ndarray, bpp: int) -> np.ndarray:
    """Average (3) and Paeth (4) rows: each byte depends on the one bpp to
    its left, so they decode byte by byte."""
    x, b_row, out = row.tolist(), up.tolist(), [0] * len(row)
    for i in range(len(x)):
        a = out[i - bpp] if i >= bpp else 0
        b = b_row[i]
        if kind == 3:
            out[i] = (x[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = b_row[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (x[i] + pred) & 0xFF
    return np.asarray(out, np.uint8)


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters: (height, stride) uint8 scanlines."""
    need = height * (stride + 1)
    if len(raw) < need:
        raise ValueError(f"PNG image data holds {len(raw)} bytes, expected {need}")
    rows = np.frombuffer(raw, np.uint8, count=need).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    up = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, x = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:  # None
            cur = x
        elif kind == 1:  # Sub: a running sum along each byte lane, mod 256
            cur = np.cumsum(x.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = x + up
        elif kind in (3, 4):  # Average, Paeth
            cur = _unfilter_row_sequential(kind, x, up, bpp)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = cur
        up = out[y]
    return out


def _samples(rows: np.ndarray, depth: int, count: int) -> np.ndarray:
    """(h, stride) scanlines -> (h, count) samples at their stored depth:
    big-endian uint16 at 16 bits, uint8 otherwise (sub-byte samples packed
    most significant bits first)."""
    if depth == 16:
        return rows.view(">u2")[:, :count].astype(np.uint16)
    if depth == 8:
        return rows[:, :count]
    bits = np.unpackbits(rows, axis=1)[:, : count * depth].reshape(rows.shape[0], count, depth)
    return (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(-1, dtype=np.uint8)


def _decode_samples(raw: bytes, width: int, height: int, depth: int, channels: int, interlace: int) -> np.ndarray:
    """Filtered image data -> (H, W, channels) samples; any nonzero
    interlace method reads as Adam7, as PIL reads it."""
    bpp = max(1, channels * depth // 8)
    if not interlace:
        stride = (width * channels * depth + 7) // 8
        rows = _unfilter(raw, height, stride, bpp)
        return _samples(rows, depth, width * channels).reshape(height, width, channels)
    out = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    raw, pos = memoryview(raw), 0
    for x0, y0, dx, dy in _ADAM7:
        w, h = (width - x0 + dx - 1) // dx, (height - y0 + dy - 1) // dy
        if w <= 0 or h <= 0:
            continue  # an empty pass stores no scanlines at all
        stride = (w * channels * depth + 7) // 8
        rows = _unfilter(raw[pos:], h, stride, bpp)
        pos += h * (stride + 1)
        out[y0::dy, x0::dx] = _samples(rows, depth, w * channels).reshape(h, w, channels)
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> the image as PIL reads it. A gray file comes back
    (H, W) in the dtype of ``np.asarray(Image.open(...))``: bool at 1 bit,
    uint8 at 2, 4 and 8 bits (2- and 4-bit samples scaled to 0-255),
    uint16 at 16 bits. Every other file comes back (H, W, 3) uint8, as
    PIL's ``convert("RGB")`` gives it: the palette looked up (missing
    entries black, tRNS ignored), alpha dropped, 16-bit samples cut to
    their high byte. Raises ValueError on a format PIL does not read and
    on damaged data."""
    header, idat, plte = None, [], b""
    for kind, payload in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            plte = payload
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG file without an IHDR chunk")
    width, height, depth, color, _compression, _filter, interlace = header
    channels, depths = _PNG_FORMATS.get(color, (0, ()))
    if depth not in depths:
        raise ValueError(f"unsupported PNG format: bit depth {depth}, color type {color}")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from None
    s = _decode_samples(raw, width, height, depth, channels, interlace)
    if color == 0:
        g = s[..., 0]
        if depth == 1:
            return g.astype(bool)
        return g * np.uint8(255 // (2**depth - 1)) if depth in (2, 4) else g
    if color == 3:
        n = len(plte) // 3
        palette = np.zeros((256, 3), np.uint8)
        palette[: min(n, 256)] = np.frombuffer(plte, np.uint8, count=3 * n).reshape(n, 3)[:256]
        return palette[s[..., 0]]
    if depth == 16:
        s = (s >> 8).astype(np.uint8)
    return np.repeat(s[..., :1], 3, axis=-1) if color == 4 else np.ascontiguousarray(s[..., :3])


def encode_png(image: np.ndarray) -> bytes:
    """(H, W) uint16 (depth) or (H, W, 3) uint8 (RGB) -> PNG bytes, every
    row with the Up filter."""
    a = np.asarray(image)
    if a.dtype == np.uint16 and a.ndim == 2:
        depth, color, rows = 16, 0, a.astype(">u2").view(np.uint8).reshape(a.shape[0], -1)
    elif a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] == 3:
        depth, color, rows = 8, 2, a.reshape(a.shape[0], -1)
    else:
        raise ValueError(f"cannot encode a {a.dtype} array of shape {a.shape} as PNG")
    height, width = a.shape[:2]
    up = np.diff(rows, axis=0, prepend=np.zeros((1, rows.shape[1]), np.uint8))  # wraps mod 256
    filtered = np.concatenate([np.full((height, 1), 2, np.uint8), up], axis=1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", zlib.crc32(kind + payload))

    ihdr = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, 0)
    return (_PNG_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(filtered.tobytes()))
            + chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))


# --- native decoder selection ---------------------------------------------

_NATIVE_PNG = ()  # unset sentinel (None means "checked, unavailable")
_NATIVE_ERROR = ""


def _native_png_io():
    """The native PNG16 module, or None if the library cannot load (checked once)."""
    global _NATIVE_PNG, _NATIVE_ERROR
    if _NATIVE_PNG == ():
        try:
            from realsensetracker_tpu_torch.native import load, png_io

            load()
            _NATIVE_PNG = png_io
        except OSError as e:
            _NATIVE_PNG, _NATIVE_ERROR = None, str(e)
    return _NATIVE_PNG


def png_backend() -> tuple[str, str]:
    """("native", "") when depth PNGs decode natively, else ("numpy", why)."""
    return ("native", "") if _native_png_io() is not None else ("numpy", _NATIVE_ERROR)


# --- the sequence ---------------------------------------------------------


def _read_index(path: str) -> list[tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def _read_groundtruth(path: str) -> list[tuple[float, np.ndarray]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            out.append((v[0], np.asarray(v[1:8])))  # tx ty tz qx qy qz qw
    return out


@dataclass
class TumSequence:
    """Lazy TUM sequence: depth frames decoded on demand."""

    root: str
    depth_index: list
    rgb_index: list
    groundtruth: list

    @staticmethod
    def open(root: str) -> "TumSequence":
        depth = _read_index(os.path.join(root, "depth.txt"))
        rgb_path = os.path.join(root, "rgb.txt")
        rgb = _read_index(rgb_path) if os.path.exists(rgb_path) else []
        gt_path = os.path.join(root, "groundtruth.txt")
        gt = _read_groundtruth(gt_path) if os.path.exists(gt_path) else []
        return TumSequence(root=root, depth_index=depth, rgb_index=rgb, groundtruth=gt)

    def __len__(self) -> int:
        return len(self.depth_index)

    def timestamp(self, i: int) -> float:
        return self.depth_index[i][0]

    def depth(self, i: int) -> np.ndarray:
        """Depth frame i as float32 meters (0 = invalid)."""
        return load_depth_png(os.path.join(self.root, self.depth_index[i][1]))

    def depth_raw(self, i: int) -> np.ndarray:
        """Depth frame i as raw uint16 (meters = value / DEPTH_SCALE): half
        the host-to-device upload bytes of f32, converted on the device."""
        return load_depth_png_raw(os.path.join(self.root, self.depth_index[i][1]))

    def rgb(self, i: int) -> np.ndarray:
        """RGB frame i (by rgb.txt index) as (H, W, 3) uint8."""
        return load_rgb_png(os.path.join(self.root, self.rgb_index[i][1]))

    def rgb_for_depth(self, i: int, max_dt: float = 0.05) -> np.ndarray | None:
        """RGB frame time-associated with depth frame i (TUM association
        rule: nearest rgb timestamp within max_dt), or None."""
        j = self.associate_rgb(i, max_dt)
        return None if j is None else self.rgb(j)

    def associate_rgb(self, i: int, max_dt: float = 0.05) -> int | None:
        """Index into rgb_index nearest in time to depth frame i, or None."""
        if not self.rgb_index:
            return None
        ts = self.depth_index[i][0]
        # The stamp list is cached: rebuilding it per call made frames_rgbd
        # O(frames x rgb entries).
        stamps = getattr(self, "_rgb_stamps", None)
        if stamps is None or len(stamps) != len(self.rgb_index):
            stamps = [t for t, _ in self.rgb_index]
            object.__setattr__(self, "_rgb_stamps", stamps)
        j = bisect.bisect_left(stamps, ts)
        best, best_dt = None, max_dt
        for k in (j - 1, j):
            if 0 <= k < len(stamps) and abs(stamps[k] - ts) <= best_dt:
                best, best_dt = k, abs(stamps[k] - ts)
        return best

    def load_depth_batch(self, indices, raw: bool = False) -> np.ndarray:
        """Decode many depth frames at once -> (N, H, W) float32 meters, or
        raw uint16 counts with ``raw=True``.

        Uses the native thread-pooled batch decoder (png16_decode_batch)
        when the library loads, so ingest scales across host cores; decodes
        frame by frame otherwise, or when the batch decoder refuses a file.
        """
        indices = list(indices)
        if not indices:
            return np.zeros((0, 0, 0), np.uint16 if raw else np.float32)
        png_io = _native_png_io()
        if png_io is not None:
            paths = [os.path.join(self.root, self.depth_index[i][1]) for i in indices]
            dims = np.zeros(4, np.int32)
            if png_io.load().png16_read_header(paths[0].encode(), dims.ctypes.data_as(ctypes.c_void_p)) == 0:
                try:
                    return png_io.read_png16_batch(paths, int(dims[1]), int(dims[0]),
                                                   scale=None if raw else DEPTH_SCALE)
                except ValueError:
                    pass
        get = self.depth_raw if raw else self.depth
        return np.stack([get(i) for i in indices])

    def frames(self, start: int = 0, stop: int | None = None,
               batch_decode: int = 8, raw: bool = False):
        """Yield (timestamp, depth) decoding `batch_decode` frames ahead
        through the native thread pool (1 disables batching). ``raw=True``
        yields uint16 counts instead of f32 meters (see depth_raw)."""
        stop = len(self) if stop is None else min(stop, len(self))
        if batch_decode <= 1:
            get = self.depth_raw if raw else self.depth
            for i in range(start, stop):
                yield self.timestamp(i), get(i)
            return
        for b in range(start, stop, batch_decode):
            idx = range(b, min(b + batch_decode, stop))
            block = self.load_depth_batch(idx, raw=raw)
            for off, i in enumerate(idx):
                yield self.timestamp(i), block[off]

    def frames_rgbd(self, start: int = 0, stop: int | None = None,
                    batch_decode: int = 8):
        """Yield (timestamp, depth, gray | None): gray is the associated RGB
        frame's [0,1] float32 luma (the photometric term's input). Depth
        decodes `batch_decode` frames ahead, as frames() does; RGB decodes
        frame by frame."""
        stop = len(self) if stop is None else min(stop, len(self))
        for b in range(start, stop, max(batch_decode, 1)):
            idx = range(b, min(b + max(batch_decode, 1), stop))
            block = self.load_depth_batch(idx) if batch_decode > 1 else None
            for off, i in enumerate(idx):
                rgb = self.rgb_for_depth(i)
                gray = None if rgb is None else rgb_to_gray(rgb)
                depth = block[off] if block is not None else self.depth(i)
                yield self.timestamp(i), depth, gray

    def groundtruth_trajectory(self):
        import torch

        from realsensetracker_tpu_torch.geometry import se3
        from realsensetracker_tpu_torch.tracking.trajectory import Trajectory

        traj = Trajectory()
        for ts, v in self.groundtruth:
            T = np.eye(4)
            T[:3, :3] = se3.matrix_from_quaternion(torch.tensor(v[3:7], dtype=torch.float32)).numpy()
            T[:3, 3] = v[:3]
            traj.append(ts, T)
        return traj


def load_depth_png_raw(path: str) -> np.ndarray:
    """16-bit depth PNG -> raw uint16 counts: the native decoder when the
    library loads (the numpy one when it refuses the file), else numpy.
    Any gray PNG reads as ``np.asarray(Image.open(path), dtype=np.uint16)``
    does; a color one raises ValueError."""
    png_io = _native_png_io()
    if png_io is not None:
        try:
            return png_io.read_png16(path)
        except ValueError:
            pass
    img = read_png(path)
    if img.ndim != 2:
        raise ValueError(f"{path}: a color PNG is not a depth frame")
    return img.astype(np.uint16, copy=False)


def load_depth_png(path: str) -> np.ndarray:
    """16-bit depth PNG -> float32 meters."""
    return load_depth_png_raw(path).astype(np.float32) / DEPTH_SCALE


def load_rgb_png(path: str) -> np.ndarray:
    """Any PNG -> (H, W, 3) uint8 (TUM rgb/ frames), as PIL's
    ``convert("RGB")`` gives it: gray replicated (1 bit as 0/255, 16 bits
    clipped at 255)."""
    img = read_png(path)
    if img.ndim == 2:
        if img.dtype == bool:
            img = img.astype(np.uint8) * np.uint8(255)
        elif img.dtype == np.uint16:
            img = np.minimum(img, 255).astype(np.uint8)
        img = np.repeat(img[..., None], 3, axis=-1)
    return img


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> float32 [0,1] BT.601 luma."""
    return (rgb.astype(np.float32) / 255.0) @ np.asarray([0.299, 0.587, 0.114], np.float32)


def synthesize_tum_sequence(root: str, num_frames: int = 10, seed: int = 0,
                            width: int = 640, height: int = 480,
                            with_color: bool = False, poses=None,
                            scene=None) -> str:
    """Write a synthetic TUM-format sequence (tests, offline demos, the
    card's replay check).

    Renders the port's raycast scene (on the CPU) along a random-walk
    trajectory and saves 16-bit depth PNGs + depth.txt + groundtruth.txt;
    with_color also writes 8-bit rgb/ frames + rgb.txt. ``scene``
    overrides the default scene, ``poses`` (F, 4, 4) the walk.
    """
    import torch

    from realsensetracker_tpu_torch.data import synthetic
    from realsensetracker_tpu_torch.geometry import camera, se3

    intr = camera.Intrinsics(
        fx=width * 0.8, fy=width * 0.8, cx=(width - 1) / 2, cy=(height - 1) / 2,
        width=width, height=height,
    )
    if poses is not None:
        poses = torch.as_tensor(np.asarray(poses, np.float32))
    if with_color:
        depths, colors, poses = synthetic.render_trajectory_rgbd(intr, num_frames, scene=scene, seed=seed,
                                                                 poses=poses)
        colors = colors.cpu().numpy()
        os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    else:
        depths, poses = synthetic.render_trajectory(intr, num_frames, scene=scene, seed=seed, poses=poses)
        colors = None
    depths, poses = depths.cpu().numpy(), poses.cpu().numpy()
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    index_lines, rgb_lines, gt_lines = [], [], []
    for i in range(num_frames):
        ts = i / 30.0
        # Round, don't truncate: truncation biases every depth by -0.1 mm.
        d16 = np.clip(np.round(depths[i] * DEPTH_SCALE), 0, 65535).astype(np.uint16)
        rel = f"depth/{ts:.6f}.png"
        write_png(os.path.join(root, rel), d16)
        index_lines.append(f"{ts:.6f} {rel}")
        if colors is not None:
            c8 = np.clip(np.round(colors[i] * 255.0), 0, 255).astype(np.uint8)
            rel_rgb = f"rgb/{ts:.6f}.png"
            write_png(os.path.join(root, rel_rgb), c8)
            rgb_lines.append(f"{ts:.6f} {rel_rgb}")
        T = poses[i]
        q = se3.quaternion_from_matrix(torch.from_numpy(np.ascontiguousarray(T[:3, :3]))).numpy()
        t = T[:3, 3]
        gt_lines.append(
            f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
            f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}"
        )
    with open(os.path.join(root, "depth.txt"), "w") as f:
        f.write("\n".join(index_lines) + "\n")
    if rgb_lines:
        with open(os.path.join(root, "rgb.txt"), "w") as f:
            f.write("\n".join(rgb_lines) + "\n")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("\n".join(gt_lines) + "\n")
    return root
