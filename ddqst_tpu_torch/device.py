"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Without
CUDA, a call that did not pass ``device="cpu"`` raises instead of quietly
running on the host.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` (default CUDA) as a ``torch.device`` with an explicit
    index for CUDA, so it compares equal to a tensor's or generator's."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
