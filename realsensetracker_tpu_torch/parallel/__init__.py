"""Batched registration on one device."""

from realsensetracker_tpu_torch.parallel.batched import register_batch, register_batch_chunked  # noqa: F401
