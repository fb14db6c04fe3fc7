"""Device policy: the port runs on the card unless told otherwise."""

from __future__ import annotations

import torch

#: the device every entry point uses when the caller names none
DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``. Asking for CUDA on a machine without
    it raises; nothing falls back to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to "
            "run the plain PyTorch path"
        )
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two resolved devices are one: ``cuda`` without an index is
    the current card."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return a == b
    cur = torch.cuda.current_device()
    return ((cur if a.index is None else a.index)
            == (cur if b.index is None else b.index))
