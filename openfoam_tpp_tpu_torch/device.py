"""Device selection for the port's entry points.

Every entry point takes ``device`` (default ``"cuda"``). A CUDA request
on a machine without a usable card raises; the CPU runs only when the
caller asks for it with ``device="cpu"``.

Runs over a device mesh (``devices=N`` of ``run_case`` and
``run_cases_batched``, parallel/sharding.py) take one device per mesh
position from the same argument (`device_positions`): ``"cuda"`` is the
first N visible cards, an indexed device (``"cuda:0"``) or ``"cpu"``
puts every position on that one device, and a list (or a comma-separated
string) names one device per position.
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


def device_positions(device="cuda", n: int = 1) -> list[torch.device]:
    """One torch.device per mesh position, for `n` positions. Checks
    nothing of the devices but the count of visible cards that "cuda"
    asks for: a mesh of distinct cards raises where it is laid out
    (parallel/sharding.py), before any card is touched."""
    if isinstance(device, str) and "," in device:
        device = [d.strip() for d in device.split(",")]
    if isinstance(device, (list, tuple)):
        devs = [torch.device(d) for d in device]
        if len(devs) != n:
            raise ValueError(f"{len(devs)} devices given ({device}) for {n} "
                             "mesh positions: a list names one device per "
                             "position")
        return devs
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and n > 1:
        resolve_device(dev)
        count = torch.cuda.device_count()
        if count < n:
            raise ValueError(
                f"device='cuda' asks for the first {n} visible cards, and "
                f"{count} are visible; name one card (device='cuda:0') or a "
                "list to put several positions on one card")
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n
