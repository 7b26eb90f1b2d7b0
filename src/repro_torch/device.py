"""Device resolution shared by the entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``"cuda"``/``"cuda:N"``/``"cpu"`` (or a ``torch.device``) -> device.

    Raises when CUDA is asked for and no card is present: nothing moves work
    to the CPU behind the caller's back.
    """
    try:
        dev = torch.device(device)
    except RuntimeError:
        raise ValueError(
            f"device must be 'cpu' or 'cuda[:N]', got {device!r}") from None
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cpu' or 'cuda[:N]', got {device!r}")
    return dev
