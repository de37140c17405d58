"""Best-effort reader for the reference's recorded protobuf clouds.

A copy of realsensetracker_tpu/data/pb_interop.py (pure numpy).

The reference viewer records `cho::proto::core::geometry::PointCloud`
messages one-per-file (rs_viewer.cpp:105-112) that rs_replay_app replays
(rs_replay_app.cpp:219-225). The .proto schema lives in the author's
external cho_util library, which is not vendored in the reference tree, so
exact field descriptors are unavailable -- but protobuf's wire format is
self-describing enough for a schema-free reader:

1. parse the tag/wire-type stream (varint, fixed64, length-delimited,
   fixed32);
2. recurse into every length-delimited payload that itself parses cleanly
   as a message, AND keep it as a raw-bytes candidate;
3. among candidates whose byte length is a multiple of 4 and whose
   float32 interpretation is finite and sanely bounded, pick the largest
   with element count divisible by 3 as the point data --
   `cho::core::PointCloud<float, 3>` wraps a column-major
   Eigen::Matrix<float, 3, N>, so the payload is [x0 y0 z0 x1 y1 z1 ...]
   and reshape(-1, 3) recovers the points;
4. a second sane float payload with the same element count is returned as
   per-point colors (the recorded clouds carry RGB, rs_viewer.cpp:96-100).

This is interop for the reference's data files, not a general protobuf
implementation; anything unrecognizable raises ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

_MAX_SANE_FIELD = 10_000  # field numbers above this mean "not a message"
_MAX_DEPTH = 6


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf) or shift > 63:
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) or raise ValueError."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if field == 0 or field > _MAX_SANE_FIELD:
            raise ValueError(f"implausible field number {field}")
        if wt == 0:  # varint
            value, pos = _read_varint(buf, pos)
        elif wt == 1:  # fixed64
            if pos + 8 > len(buf):
                raise ValueError("truncated fixed64")
            value = buf[pos : pos + 8]
            pos += 8
        elif wt == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            if length < 0 or pos + length > len(buf):
                raise ValueError("truncated bytes field")
            value = buf[pos : pos + length]
            pos += length
        elif wt == 5:  # fixed32
            if pos + 4 > len(buf):
                raise ValueError("truncated fixed32")
            value = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, value


def _collect_blobs(buf: bytes, depth: int = 0) -> list[bytes]:
    """All length-delimited payloads in the message tree (pre-order)."""
    blobs: list[bytes] = []
    for _field, wt, value in _iter_fields(buf):
        if wt != 2:
            continue
        blobs.append(value)
        if depth < _MAX_DEPTH and len(value) >= 2:
            try:
                blobs.extend(_collect_blobs(value, depth + 1))
            except ValueError:
                pass  # raw bytes, not a nested message
    return blobs


def _sane_floats(blob: bytes) -> np.ndarray | None:
    if len(blob) < 12 or len(blob) % 4 != 0:
        return None
    arr = np.frombuffer(blob, dtype="<f4")
    if not np.all(np.isfinite(arr)):
        return None
    if np.abs(arr).max(initial=0.0) > 1e6:
        return None
    return arr


def parse_pb_cloud(data: bytes) -> tuple[np.ndarray, np.ndarray | None]:
    """Recover (points (N, 3) float32, colors (N, 3) | None) from a
    serialized cho-style PointCloud message."""
    try:
        blobs = _collect_blobs(data)
    except ValueError as e:
        raise ValueError(f"not a parseable protobuf message: {e}") from e
    candidates = []
    for blob in blobs:
        arr = _sane_floats(blob)
        if arr is not None and arr.size % 3 == 0:
            candidates.append(arr)
    if not candidates:
        raise ValueError("no plausible packed-float32 point payload found")
    candidates.sort(key=lambda a: a.size, reverse=True)
    points = candidates[0].reshape(-1, 3).astype(np.float32)
    colors = None
    for arr in candidates[1:]:
        if arr.size == candidates[0].size and arr is not candidates[0]:
            c = arr.reshape(-1, 3).astype(np.float32)
            # Colors are bounded; reject obviously-geometric payloads.
            # 255 is the bound the /255 rescale below implies -- accepting
            # (255, 256] would emit colors above 1.0.
            if c.min() >= -1e-3 and c.max() <= 255.0:
                colors = c if c.max() <= 1.0 + 1e-6 else c / 255.0
                break
    return points, colors


def read_pb_cloud(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    """Read one recorded .pb cloud file (rs_viewer.cpp record output)."""
    with open(path, "rb") as f:
        return parse_pb_cloud(f.read())


def write_pb_cloud(path: str, points, colors=None) -> None:
    """Serialize points (N, 3) [+ colors] in a cho-compatible wire shape:
    a nested message (field 1) whose field 2 carries the packed column-
    major float data, with colors as a sibling packed field. Field numbers
    are a guess -- the READER above is schema-free, so round-trips through
    this writer and any same-shape reference file both parse; this writer
    exists for tests and for exporting clouds reference tooling can at
    least attempt to read."""
    points = np.ascontiguousarray(np.asarray(points, np.float32))

    def ld(field: int, payload: bytes) -> bytes:
        out = bytearray()
        tag = (field << 3) | 2
        while True:
            b = tag & 0x7F
            tag >>= 7
            out.append(b | (0x80 if tag else 0))
            if not tag:
                break
        length = len(payload)
        while True:
            b = length & 0x7F
            length >>= 7
            out.append(b | (0x80 if length else 0))
            if not length:
                break
        return bytes(out) + payload

    inner = ld(2, points.reshape(-1).tobytes())
    if colors is not None:
        colors = np.ascontiguousarray(np.asarray(colors, np.float32))
        inner += ld(3, colors.reshape(-1).tobytes())
    inner += (b"\x08" + struct.pack("B", 3))  # field 1 varint: dimension
    with open(path, "wb") as f:
        f.write(ld(1, inner))
