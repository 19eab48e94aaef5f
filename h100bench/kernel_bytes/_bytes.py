"""Bytes of a kernel call counted by the algorithm's operands: each input
tensor read once and each output tensor written once, whatever the
kernel reads again (PERF.md's "Bytes" column)."""

from __future__ import annotations

import torch


def tensor_bytes(obj) -> int:
    """The bytes of every tensor in `obj` (tensors, tuples, lists, dicts)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(tensor_bytes(o) for o in obj)
    if isinstance(obj, dict):
        return sum(tensor_bytes(o) for o in obj.values())
    return 0


def operands_and_result(args, kwargs, out) -> int:
    return tensor_bytes(args) + tensor_bytes(kwargs) + tensor_bytes(out)
