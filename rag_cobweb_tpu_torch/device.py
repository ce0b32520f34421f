"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` and defaults to ``"cuda"``.
Without a GPU that default raises: only an explicit ``device="cpu"`` runs
on the host, so a run that meant to use the card can never fall back to
the CPU unnoticed.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``, a card with its index (``"cuda"``
    is the current card), so it compares equal to its tensors' device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def full_f32_matmul() -> None:
    """Keep float32 products in full float32 on the card (TF32 off): the
    counterpart of the JAX package's ``Precision.HIGHEST``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
