"""The device the port's entry points run on.

Trackers and the ``interop`` helpers run on the CUDA card unless the
caller passes ``device="cpu"``, which runs every kernel's plain torch
version instead (the CPU tests do). A host without CUDA makes the default
raise: it never falls back to the CPU on its own.
"""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device: str | torch.device = DEFAULT) -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA on a host
    where ``torch.cuda.is_available()`` is False."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} needs CUDA, which this host lacks "
            "(torch.cuda.is_available() is False); pass device='cpu' to run on the CPU"
        )
    return dev
