"""Frame uploads of a profiled replay: FrameStream's own count against the
trace's memcpy records, for one checkout.

    python tools/torch/replay_trace_uploads.py ROOT OUT_DIR [PAIRS]

imports realsensetracker_tpu_torch from the checkout at ROOT, writes a
30-frame 640x480 TUM-layout sequence to OUT_DIR, and PAIRS times (default
4) replays it with cli.rs_replay.main (projective, --max-frames 10, then
30) under utils.profiling.device_trace, as chip_smoke.py's replay_stream
phase does. It counts FrameStream's uploads by wrapping
FrameStream._upload (so it reads a checkout that has no count of its own)
and prints one JSON line per run: frames uploaded, the trace's frame-sized
host-to-device copies, and all of its host-to-device copies; then one line
with each pair's uploads per frame from the trace, differenced as the
phase differences them. Run two checkouts in turns within one call to
compare them.
"""

import contextlib
import io
import json
import os
import sys

ROOT, OUT = sys.argv[1], sys.argv[2]
PAIRS = int(sys.argv[3]) if len(sys.argv) > 3 else 4
sys.path.insert(0, os.path.abspath(ROOT))

import torch  # noqa: E402

from realsensetracker_tpu_torch.cli import rs_replay  # noqa: E402
from realsensetracker_tpu_torch.data import stream, tum  # noqa: E402
from realsensetracker_tpu_torch.utils.profiling import device_trace  # noqa: E402

H, W = 480, 640
seq_dir = os.path.join(OUT, "seq")
if not os.path.isdir(seq_dir):
    tum.synthesize_tum_sequence(seq_dir, num_frames=30, seed=0, width=W, height=H)

calls = [0]
upload = stream.FrameStream._upload


def counted_upload(self, frame):
    calls[0] += 1
    return upload(self, frame)


stream.FrameStream._upload = counted_upload


def run(max_frames):
    calls[0] = 0
    name = f"trace{max_frames}.json"
    with device_trace(OUT, name):
        with contextlib.redirect_stdout(io.StringIO()):
            rc = rs_replay.main(["--tum", seq_dir, "--method", "projective", "--max-frames", str(max_frames)])
        torch.cuda.synchronize()
    with open(os.path.join(OUT, name)) as f:
        trace = json.load(f)["traceEvents"]
    htod = [e for e in trace if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    row = {"root": ROOT, "rc": rc, "max_frames": max_frames, "uploaded": calls[0],
           "trace_frame_uploads": sum(e["args"].get("bytes") == H * W * 2 for e in htod), "trace_htod": len(htod)}
    print(json.dumps(row), flush=True)
    return row


run(10)  # warm-up: builds and loads the kernels
pairs = [(run(10), run(30)) for _ in range(PAIRS)]
print(json.dumps({"root": ROOT, "card": torch.cuda.get_device_name(0),
                  "uploads_per_frame_by_pair": [(b["trace_frame_uploads"] - a["trace_frame_uploads"]) / 20
                                                for a, b in pairs],
                  "uploaded_every_frame": all(r["uploaded"] == r["max_frames"] for p in pairs for r in p)}),
      flush=True)
