"""Device selection for the port's entry points.

Every entry point runs on the CUDA card unless its caller asks for the
CPU. There is no silent fallback: asking for CUDA on a host without a
usable CUDA device raises here, before any work starts.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch.device for `device` ("cuda", "cuda:N" or "cpu"); raises
    RuntimeError when a CUDA device is asked for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: torch.cuda.is_available() is False "
                f"(torch {torch.__version__}); pass device='cpu' "
                "(CLI: --device cpu) to run the plain CPU version")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
