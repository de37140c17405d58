"""Host-to-device frame streaming with background prefetch.

Port of realsensetracker_tpu/data/stream.py: the reference's capture
thread + shared_mutex handoff (rs_driver.cpp:136-225). A producer thread
decodes or loads frames and stages them on the device ahead of the
consumer, so the card does not wait on host I/O; an optional min_interval
mirrors RsDriver's rate limiting (rs_driver.cpp:196).

On a CUDA device the default transfer adds no host sync. In the producer
thread it

* copies each frame into pinned host memory in its own dtype (raw
  uint16 depth stays uint16; float64 becomes f32, as a JAX device_put
  does), from PyTorch's caching host allocator, which hands a pinned block out again only after the copies
  recorded on it have completed (so a reused block is never overwritten
  while its upload runs);
* uploads it with ``non_blocking=True`` on the stream's own
  ``torch.cuda.Stream``, with the device and that stream made current for
  the producer thread (CUDA's current device and stream are per thread);
* records an event after the upload.

When a frame is handed out, the consumer's current stream waits on that
event (on the device, the host does not block) and the frame's memory is
tied to the consumer's stream (``Tensor.record_stream``), so the caching
allocator does not give it to a later upload while the consumer's kernels
still read it. A caller-supplied ``transfer`` replaces all of this.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Iterator, NamedTuple

import numpy as np
import torch

from realsensetracker_tpu_torch import device as device_mod

# Host-to-device copies made by FrameStream's default CUDA transfer: frames
# staged, and arrays uploaded (None entries and tensors already on the card
# are not). Added to on the producer thread, never reset here.
UPLOADS = {"frames": 0, "arrays": 0}


class _Uploaded(NamedTuple):
    """A frame's device tensors (None where the frame had None) and the
    event recorded after their uploads on the stream's side stream."""

    tensors: tuple
    event: torch.cuda.Event
    single: bool  # the frame was one array, not a tuple


def _host_arrays(frame):
    """(arrays, single): the frame's arrays, contiguous, in their own dtype
    but float64 -> f32. Integer depth stays raw: the tracker converts it
    with its own depth_scale. Torch tensors are taken as they lie."""
    single = not isinstance(frame, tuple)
    parts = (frame,) if single else frame
    out = []
    for a in parts:
        if a is None or isinstance(a, torch.Tensor):
            out.append(a)
            continue
        a = np.asarray(a)
        out.append(np.ascontiguousarray(a, np.float32 if a.dtype == np.float64 else None))
    return out, single


class FrameStream:
    """Iterate (timestamp, frame) with lookahead prefetching; a frame is a
    tensor on ``device``, or a tuple of them when the source yields tuples
    (depth, color) -- None entries pass through.

    Error and lifecycle semantics (each one was a silent failure mode):

    * a producer-thread exception (corrupt frame, failed device transfer)
      is re-raised in the CONSUMER at the point of iteration -- a clean
      end-of-stream after frame k of n would otherwise let a replay
      "complete" (and score ATE) on a silently truncated sequence;
    * iterating again after exhaustion raises RuntimeError instead of
      blocking forever on an empty queue whose producer already exited;
    * close() (also a context-manager exit) unblocks and stops the
      producer, so a consumer that stops early does not leak a thread
      pinning prefetched device buffers in a long-lived process.

    ``device`` defaults to the card and raises on a host without CUDA;
    ``device="cpu"`` stages with ``torch.from_numpy``.
    """

    def __init__(
        self,
        source: Iterable,
        prefetch: int = 2,
        transfer: Callable | None = None,
        min_interval_s: float = 0.0,
        device: str | torch.device = device_mod.DEFAULT,
    ):
        self.device = device_mod.resolve(device)
        self._source = source
        self._queue: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._side = None
        if transfer is None:
            if self.device.type == "cuda":
                self._side = torch.cuda.Stream(device=self.device)
                transfer = self._upload
            else:
                transfer = self._to_host_tensors
        self._transfer = transfer
        self._min_interval = min_interval_s
        self._done = object()
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._started = False
        self._exhausted = False

    # -- transfers (producer thread) ---------------------------------------

    def _to_host_tensors(self, frame):
        arrays, single = _host_arrays(frame)
        out = tuple(a if a is None or isinstance(a, torch.Tensor) else torch.from_numpy(a) for a in arrays)
        return out[0] if single else out

    def _upload(self, frame) -> _Uploaded:
        arrays, single = _host_arrays(frame)
        with torch.cuda.device(self.device), torch.cuda.stream(self._side):
            out = []
            for a in arrays:
                if a is None:
                    out.append(None)
                    continue
                host = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
                if not host.is_cuda:
                    pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
                    pinned.copy_(host)
                    host = pinned
                    UPLOADS["arrays"] += 1
                out.append(host.to(self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self._side)
        UPLOADS["frames"] += 1
        return _Uploaded(tuple(out), event, single)

    def _hand_out(self, item):
        """(ts, frame) for the consumer: an upload's tensors ordered after
        their copy on the consumer's current stream and tied to it."""
        ts, staged = item
        if not isinstance(staged, _Uploaded):
            return ts, staged
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(staged.event)
        for t in staged.tensors:
            if t is not None:
                t.record_stream(stream)
        return ts, (staged.tensors[0] if staged.single else staged.tensors)

    # -- producer ------------------------------------------------------------

    def _put(self, item) -> bool:
        """put() that gives up when the stream is closed (a full queue with
        a departed consumer would otherwise block the producer forever)."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self) -> None:
        last = 0.0
        try:
            for item in self._source:
                if self._stop.is_set():
                    return
                ts, frame = item
                if self._min_interval > 0:
                    now = time.monotonic()
                    wait = self._min_interval - (now - last)
                    if wait > 0:
                        time.sleep(wait)
                    last = time.monotonic()
                staged = self._transfer(frame)
                if not self._put((ts, staged)):
                    return
        except BaseException as e:  # surfaced to the consumer, not swallowed
            self._error = e
        finally:
            self._put(self._done)

    def _start(self) -> None:
        if not self._started:
            self._thread.start()
            self._started = True

    def _finish(self):
        """Common end-of-stream handling: propagate producer errors."""
        self._exhausted = True
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("frame stream producer failed mid-sequence") from err

    # -- consumer ------------------------------------------------------------

    def __iter__(self) -> Iterator:
        if self._exhausted:
            raise RuntimeError(
                "FrameStream is single-pass and already exhausted; "
                "create a new stream to re-read the source"
            )
        self._start()
        while True:
            item = self._queue.get()
            if item is self._done:
                self._finish()
                return
            yield self._hand_out(item)

    @property
    def exhausted(self) -> bool:
        return self._exhausted

    def poll(self):
        """Non-blocking GetFrame analog (rs_driver.cpp:233-262): returns
        (ts, frame) when a fresh frame is staged, else None (the caller
        sleeps interval/8 and retries -- rs_viewer.cpp:82-86)."""
        self._start()
        try:
            item = self._queue.get_nowait()
        except queue.Empty:
            return None
        if item is self._done:
            self._finish()
            return None
        return self._hand_out(item)

    def close(self) -> None:
        """Stop the producer and release its staged frames."""
        self._stop.set()
        while True:  # drain so a blocked put() can observe _stop
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        if self._started:
            self._thread.join(timeout=5.0)
        self._exhausted = True

    def __enter__(self) -> "FrameStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def stream_clip(clip, prefetch: int = 2, device: str | torch.device = device_mod.DEFAULT) -> FrameStream:
    """Stream a recorded Clip's depth frames (f32 meters) to ``device``."""
    return FrameStream(
        ((clip.timestamps[i], clip.depths[i]) for i in range(len(clip))),
        prefetch=prefetch, device=device,
    )


def stream_tum(seq, prefetch: int = 2, stop: int | None = None,
               start: int = 0, raw: bool = False,
               device: str | torch.device = device_mod.DEFAULT) -> FrameStream:
    """Stream a TumSequence to ``device``: PNG decode happens on the
    producer thread. ``raw=True`` yields uint16 counts (half the upload
    bytes; pair with depth_scale=1/tum.DEPTH_SCALE)."""
    return FrameStream(seq.frames(start=start, stop=stop, raw=raw), prefetch=prefetch, device=device)
