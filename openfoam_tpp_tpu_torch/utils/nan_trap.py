"""NaN trap of the solver (``OFTPP_DEBUG_NANS=1``).

The JAX package turns on ``jax_debug_nans`` for the process, so the
first solver operation whose output holds a NaN raises
``FloatingPointError`` (OpenFOAM's ``sigFpe`` trapping). The port does
the same for the code run inside ``trap_nans()``:

- every PyTorch operation, through a ``TorchDispatchMode`` that looks at
  each floating output. It skips what only allocates, moves or views data
  (``SKIPPED`` and every view op): uninitialized memory may hold NaN bit
  patterns, and the JAX trap does not look at a checkpoint as it is moved
  onto the device;
- every CUDA kernel of ``ops/kernels/``, whose ctypes launches PyTorch's
  dispatch never sees: while the trap is on, ``_build.check`` hands each
  launch's outputs to ``NanTrap.check_kernel``.

The error names the operation or kernel, the port's source line that ran
it and the step of the run (``make_advance`` counts the steps while a
trap is current). Each check reads the result back to the host, a sync per
operation: a debug mode. With the variable unset, ``trap_nans()`` enters
no mode and sets no hook.
"""

from __future__ import annotations

import contextlib
import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from openfoam_tpp_tpu_torch.ops.kernels import _build

ENV_FLAG = "OFTPP_DEBUG_NANS"

#: aten ops that only allocate, copy or move data (views are skipped by
#: their schema).
SKIPPED = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "lift_fresh", "lift_fresh_copy", "_to_copy",
    "copy_", "clone", "detach",
})

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
_KERNELS = os.path.join(_PKG, "ops", "kernels")
_TORCH = os.path.dirname(os.path.abspath(torch.__file__))
_THIS = os.path.abspath(__file__)
_CURRENT: list = []


def current():
    """The trap in force, or None."""
    return _CURRENT[-1] if _CURRENT else None


def _floats(outputs):
    return [t for t in outputs
            if isinstance(t, torch.Tensor) and t.is_floating_point()]


def _site(skip_kernels: bool):
    """(entry point, 'file:line'): the innermost frame of this repository
    outside this module (and outside ops/kernels/ with `skip_kernels`:
    then the entry point is the outermost kernel frame's function and the
    line its caller's); else the innermost frame outside torch."""
    entry = fallback = None
    f = sys._getframe(1)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path == _THIS or path.startswith(_TORCH + os.sep):
            pass
        elif skip_kernels and path.startswith(_KERNELS + os.sep):
            if not f.f_code.co_name.startswith("_"):
                entry = f.f_code.co_name
        elif path.startswith(_ROOT + os.sep):
            return entry, f"{os.path.relpath(path, _ROOT)}:{f.f_lineno}"
        elif fallback is None:
            fallback = f"{path}:{f.f_lineno}"
        f = f.f_back
    return entry, fallback or "?"


class NanTrap(TorchDispatchMode):
    """Raise FloatingPointError on the first NaN an operation outputs."""

    def __init__(self):
        super().__init__()
        self.step = 0     # steps begun inside the trap (make_advance)
        self.checked = 0  # outputs looked at

    def _raise(self, what: str, where: str):
        raise FloatingPointError(
            f"invalid value (nan) encountered in {what} at {where}, step "
            f"{self.step} of the run ({ENV_FLAG}=1)")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.overloadpacket.__name__ in SKIPPED:
            return out
        for t in _floats(tree_leaves(out)):
            self.checked += 1
            if bool(torch.isnan(t).any()):
                self._raise(str(func), _site(False)[1])
        return out

    def check_kernel(self, what: str, outputs):
        """`_build.check`'s hook: the outputs of one kernel launch."""
        for t in _floats(outputs):
            self.checked += 1
            if bool(torch.isnan(t).any()):
                entry, where = _site(True)
                self._raise(f"CUDA kernel {entry or what} ({what})", where)


@contextlib.contextmanager
def trap_nans(enabled: bool | None = None):
    """Yield a NanTrap in force for the body, or None (nothing entered)
    when it is off: `enabled` None reads OFTPP_DEBUG_NANS ('1' = on)."""
    if enabled is None:
        enabled = os.environ.get(ENV_FLAG) == "1"
    if not enabled:
        yield None
        return
    trap = NanTrap()
    hook = _build.nan_hook
    _CURRENT.append(trap)
    _build.nan_hook = trap.check_kernel
    try:
        with trap:
            yield trap
    finally:
        _build.nan_hook = hook
        _CURRENT.pop()
