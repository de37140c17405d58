"""Host-side utilities: stopwatches, stage timing, device traces, NaN checks."""

from realsensetracker_tpu_torch.utils.profiling import StageTimes, UTimer  # noqa: F401
