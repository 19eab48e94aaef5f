"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source has a plain C interface and is compiled at first use with
``nvcc`` into its own shared library for ``sm_90a``, then loaded with
``ctypes``. Nothing here runs at import time. Libraries are named by a
hash of their source and flags, so an edited source is rebuilt and a
stale library is never loaded. ``build_all`` starts one ``nvcc`` per
source, all at once.

Every C entry point returns ``cudaGetLastError()`` after its launches;
``check`` raises if it is not 0 (a refused launch never runs and a later
synchronize would not report it). Each entry point hands ``check`` the
outputs of its launch: while utils/nan_trap.py's trap is on
(``OFTPP_DEBUG_NANS=1``), ``nan_hook`` looks at them for NaN.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "_build"
SOURCES = ("seven_point", "seven_point_batch", "cheb2", "mules_flux",
           "mules_fct", "momentum_rhs", "correction", "mom_finish")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # No FMA contraction: the kernels then round exactly like their plain
    # PyTorch versions (one IEEE op at a time), so the card comparison
    # can hold f32 outputs bitwise. They are bandwidth-bound; FMA would
    # not shorten them.
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME/bin or PATH): the "
                           "CUDA kernels cannot be built on this machine")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=SOURCES, ptxas_verbose=False) -> dict:
    """Compile every missing library in parallel; returns {name: compiler
    output} (ptxas register/spill report when `ptxas_verbose`)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists() and not ptxas_verbose:
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS,
               *(["-Xptxas", "-v"] if ptxas_verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    logs = {}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            target = _target(name)
            if not target.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(target))
            _LIBS[name] = lib
        return lib


#: NanTrap.check_kernel while a NaN trap is on, else None.
nan_hook = None


def check(rc: int, what: str, *outputs) -> None:
    """Raise if a launch was refused; hand its `outputs` to `nan_hook`."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
    if nan_hook is not None:
        nan_hook(what, outputs)


def route(t, what: str) -> str:
    """'cuda' → the kernel, 'cpu' → its plain version; any other device
    raises."""
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"{what} runs on CUDA (kernel) or CPU (plain version), "
                     f"not {t.device}")


def require_f32(what: str, device, *operands) -> None:
    """Raise unless each (tensor, shape) pair is a contiguous f32 tensor of
    that shape on `device`: what a kernel takes."""
    import torch

    for t, shape in operands:
        if (tuple(t.shape) != tuple(shape) or t.dtype != torch.float32
                or t.device != device or not t.is_contiguous()):
            raise ValueError(
                f"{what} kernel: got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous: {t.is_contiguous()}), needs contiguous "
                f"float32 {tuple(shape)} on {device}")


_TICKETS: dict = {}


def ticket(dev, n=1):
    """The one-launch reductions' ticket counters on `dev` (apply-dot and
    its batch form, cheb2 post-dot, correct-divmax): at least `n` int32,
    zeroed when made; each call's last block (the batch apply-dot's, each
    case group's) wraps its counter back to 0. Calls sharing them must not
    overlap, so these kernels run on one stream per device."""
    import torch

    t = _TICKETS.get(dev)
    if t is None or t.numel() < n:
        t = _TICKETS[dev] = torch.zeros(max(n, 1), dtype=torch.int32,
                                        device=dev)
    return t


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
