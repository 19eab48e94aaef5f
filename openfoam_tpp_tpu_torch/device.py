"""Device selection for the port's entry points.

Every entry point takes ``device`` (default ``"cuda"``). A CUDA request
on a machine without a usable card raises; the CPU runs only when the
caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "openfoam_tpp_tpu_torch: CUDA requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the host")
    return dev
