"""Recorded-clip format (.rsc): the record/replay path.

Port of realsensetracker_tpu/data/recorded.py; the two packages read and
write the same files. A clip is one binary .rsc file holding all frames,
so replay is a single sequential read that feeds the device.

Layout v1 (depth-only, little-endian):
  magic  'RSCLIP01'                      8 bytes
  header int32[4]: num_frames, height, width, dtype(0=u16mm,1=f32m)
  intr   float32[4]: fx, fy, cx, cy
  stamps float64[num_frames]
  frames num_frames * H * W * (2 or 4) bytes

Layout v2 (optional color plane -- the RGB-D record path):
  magic  'RSCLIP02'
  header int32[4] as v1, then int32[2]: has_color, reserved
  intr / stamps / depth frames as v1
  colors num_frames * H * W * 3 uint8   (only if has_color)

When the native C++ codec (realsensetracker_tpu_torch.native.clip_io)
loads it handles the reading; this module is the format owner and the
Python fallback. Clips are host numpy arrays: a FrameStream
(data/stream.py) takes them to the device.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from realsensetracker_tpu_torch.geometry import camera

MAGIC = b"RSCLIP01"
MAGIC2 = b"RSCLIP02"
DTYPE_U16_MM = 0  # uint16 millimeters (compact, RealSense/TUM-style)
DTYPE_F32_M = 1  # float32 meters


@dataclass
class Clip:
    depths: np.ndarray  # (F, H, W) float32 meters
    timestamps: np.ndarray  # (F,) float64 seconds
    intrinsics: camera.Intrinsics
    colors: np.ndarray | None = None  # (F, H, W, 3) uint8, or None

    def __len__(self) -> int:
        return self.depths.shape[0]

    @property
    def has_color(self) -> bool:
        return self.colors is not None

    def gray(self, i: int) -> np.ndarray:
        """Frame i's BT.601 luma in [0,1] float32 (requires color)."""
        from realsensetracker_tpu_torch.data.tum import rgb_to_gray

        return rgb_to_gray(self.colors[i])


def write_clip(path: str, depths, timestamps, intr: camera.Intrinsics,
               dtype: int = DTYPE_U16_MM, colors=None) -> None:
    """Write a clip; v1 when colors is None, v2 with a color plane otherwise."""
    depths = np.asarray(depths, np.float32)
    timestamps = np.asarray(timestamps, np.float64)
    f_count, h, w = depths.shape
    if timestamps.shape != (f_count,):
        raise ValueError(f"{f_count} frames but timestamps of shape {timestamps.shape}")
    if colors is not None:
        colors = _as_u8_colors(colors)
        if colors.shape != (f_count, h, w, 3):
            raise ValueError(f"colors of shape {colors.shape}, expected {(f_count, h, w, 3)}")
    with open(path, "wb") as f:
        if colors is None:
            f.write(MAGIC)
            f.write(struct.pack("<iiii", f_count, h, w, dtype))
        else:
            f.write(MAGIC2)
            f.write(struct.pack("<iiiiii", f_count, h, w, dtype, 1, 0))
        f.write(struct.pack("<ffff", intr.fx, intr.fy, intr.cx, intr.cy))
        f.write(timestamps.tobytes())
        if dtype == DTYPE_U16_MM:
            mm = np.clip(np.round(depths * 1000.0), 0, 65535).astype("<u2")
            f.write(mm.tobytes())
        else:
            f.write(depths.astype("<f4").tobytes())
        if colors is not None:
            f.write(colors.tobytes())


def _as_u8_colors(colors) -> np.ndarray:
    """uint8 colors as given; float colors in [0, 1] scaled by 255."""
    colors = np.asarray(colors)
    if colors.dtype != np.uint8:
        colors = np.clip(np.round(colors * 255.0), 0, 255).astype(np.uint8)
    return np.ascontiguousarray(colors)


def read_clip(path: str) -> Clip:
    """Read a clip: the native codec when its library loads, else the
    Python fallback. Only the library's absence selects the fallback: a
    real read error (a truncated file, a bad magic) propagates from
    whichever path ran."""
    native = _native_clip_io()
    if native is not None:
        return native.read_clip(path)
    return read_clip_py(path)


_NATIVE_CLIP_IO = ()  # unset sentinel (None means "checked, unavailable")
_NATIVE_ERROR = ""  # why the library did not load, when it did not


def _native_clip_io():
    """The native codec module, or None if its library cannot load.
    Checked once: a failed build is not retried on every read."""
    global _NATIVE_CLIP_IO, _NATIVE_ERROR
    if _NATIVE_CLIP_IO == ():
        try:
            from realsensetracker_tpu_torch.native import clip_io, load

            load()
            _NATIVE_CLIP_IO = clip_io
        except OSError as e:
            _NATIVE_CLIP_IO, _NATIVE_ERROR = None, str(e)
    return _NATIVE_CLIP_IO


def backend() -> tuple[str, str]:
    """("native", "") when read_clip decodes natively, else ("python", why)."""
    return ("native", "") if _native_clip_io() is not None else ("python", _NATIVE_ERROR)


def read_clip_py(path: str) -> Clip:
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic not in (MAGIC, MAGIC2):
            raise ValueError(f"{path}: not an RSC clip (magic={magic!r})")
        f_count, h, w, dtype = struct.unpack("<iiii", f.read(16))
        has_color = 0
        if magic == MAGIC2:
            has_color, _reserved = struct.unpack("<ii", f.read(8))
        fx, fy, cx, cy = struct.unpack("<ffff", f.read(16))
        stamps = np.frombuffer(f.read(8 * f_count), dtype="<f8").copy()
        if dtype == DTYPE_U16_MM:
            raw = np.frombuffer(f.read(f_count * h * w * 2), dtype="<u2")
            depths = raw.reshape(f_count, h, w).astype(np.float32) / 1000.0
        elif dtype == DTYPE_F32_M:
            raw = np.frombuffer(f.read(f_count * h * w * 4), dtype="<f4")
            depths = raw.reshape(f_count, h, w).astype(np.float32)
        else:
            raise ValueError(f"unknown clip dtype {dtype}")
        colors = None
        if has_color:
            raw = np.frombuffer(f.read(f_count * h * w * 3), dtype=np.uint8)
            colors = raw.reshape(f_count, h, w, 3).copy()
    intr = camera.Intrinsics(fx=fx, fy=fy, cx=cx, cy=cy, width=w, height=h)
    return Clip(depths=depths, timestamps=stamps, intrinsics=intr, colors=colors)


def record_synthetic_clip(path: str, num_frames: int = 30, seed: int = 0,
                          width: int = 640, height: int = 480,
                          with_color: bool = False, return_poses: bool = False):
    """Produce a clip from the port's raycast scene (dataset-free record
    path), rendered on the CPU. The port's scene for a seed is not JAX's
    (synthetic.default_scene), so the two packages' clips for one seed
    differ; each package reads the other's files.

    Returns the Clip read back, or (Clip, poses_wc (F, 4, 4)) with
    ``return_poses``: the camera poses the frames were rendered at, the
    ground truth to score a replay of the clip against."""
    from realsensetracker_tpu_torch.data import synthetic

    intr = camera.Intrinsics(
        fx=width * 0.8, fy=width * 0.8, cx=(width - 1) / 2, cy=(height - 1) / 2,
        width=width, height=height,
    )
    stamps = np.arange(num_frames, dtype=np.float64) / 30.0
    if with_color:
        depths, colors, poses = synthetic.render_trajectory_rgbd(intr, num_frames, seed=seed)
        write_clip(path, depths.numpy(), stamps, intr, colors=colors.numpy())
    else:
        depths, poses = synthetic.render_trajectory(intr, num_frames, seed=seed)
        write_clip(path, depths.numpy(), stamps, intr)
    clip = read_clip(path)
    return (clip, poses) if return_poses else clip
