"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.

    ``"cuda"`` (the default everywhere) requires a visible CUDA device
    and raises otherwise: the port never continues on the CPU behind the
    caller's back. Only an explicit ``"cpu"`` runs on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kueue_oss_tpu_torch: CUDA device requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to "
            "run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
