"""Device selection for the port's entry points: explicit, no silent fallback."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card (``"cuda"``). A CUDA device with no GPU present
    raises instead of falling back to the CPU; the CPU is used only when the
    caller asks for it (``device="cpu"``).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev
