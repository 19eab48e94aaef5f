"""Dependency check of the port, with opt-in venv self-provisioning.

The port's own copy of openfoam_tpp_tpu/utils/bootstrap.py (it imports
nothing of that package), for the port's runtime: torch and numpy are
required; matplotlib (videos), scipy (the potential-flow oracle's exact
roots and surface shape) and Pillow (MJPEG AVI frames) are optional. By
default it only checks: every dependency imports and meets its minimum
version, one line per problem. ``OFTPP_BOOTSTRAP=1`` (or ``auto=True``)
lets a broken runtime build a venv, install the port's dependencies into
it and re-execute ``python -m openfoam_tpp_tpu_torch`` there, the
reference manager's create / install / exec sequence (main.py:9-95).
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys

#: Runtime requirements (import name -> minimum version). torch is the
#: compute path; numpy the host path.
REQUIRED = {
    "torch": "2.0",
    "numpy": "1.24",
}
OPTIONAL = {
    "matplotlib": "3.5",   # videos / dashboards (post/video.py)
    "scipy": "1.8",        # Bessel functions (utils/potential_flow.py)
    "PIL": "9.0",          # MJPEG AVI frames (post/avi.py)
}

VENV_DIR = ".venv-sloshing"   # reference uses "sloshing/" (main.py:22)
_ENV_FLAG = "OFTPP_BOOTSTRAP"
_REEXEC_GUARD = "OFTPP_BOOTSTRAPPED"


def _version_tuple(v: str) -> tuple:
    out = []
    for part in v.split("."):
        digits = "".join(ch for ch in part if ch.isdigit())
        if not digits:
            break
        out.append(int(digits))
    return tuple(out)


def check_dependencies(include_optional: bool = True) -> list[str]:
    """Return a list of human-readable problems (empty = all good)."""
    problems = []
    groups = [(REQUIRED, "required")]
    if include_optional:
        groups.append((OPTIONAL, "optional"))
    for table, kind in groups:
        for name, min_ver in table.items():
            try:
                mod = importlib.import_module(name)
            except ImportError:
                problems.append(f"{kind} dependency '{name}' is missing "
                                f"(need >= {min_ver})")
                continue
            ver = getattr(mod, "__version__", None)
            if ver and _version_tuple(ver) < _version_tuple(min_ver):
                problems.append(f"{kind} dependency '{name}' is {ver}, "
                                f"need >= {min_ver}")
    return problems


def ensure_dependencies(auto: bool | None = None,
                        base_dir: str = ".") -> bool:
    """Verify the runtime; optionally self-provision a venv and re-exec.

    Returns True when the environment is usable. With ``auto`` unset, the
    ``OFTPP_BOOTSTRAP=1`` env var enables provisioning (reference
    behavior); otherwise problems are reported and required-dependency
    failures return False.
    """
    if auto is None:
        auto = os.environ.get(_ENV_FLAG, "") == "1"
    problems = check_dependencies()
    required_broken = [p for p in problems if p.startswith("required")]
    for p in problems:
        print(f"  ⚠️  {p}", file=sys.stderr)
    if not required_broken:
        return True
    if not auto or os.environ.get(_REEXEC_GUARD):
        print(
            "  ❌ Runtime incomplete. Install the packages above into this "
            f"interpreter, or set {_ENV_FLAG}=1 to let the manager build "
            f"a '{VENV_DIR}' venv and re-exec itself (requires network).",
            file=sys.stderr,
        )
        return False
    return _provision_and_reexec(base_dir)


def _provision_and_reexec(base_dir: str) -> bool:
    """Create the venv, install the port's runtime and the repository (its
    own dependencies left out: they name the JAX package's), re-exec under
    it."""
    venv_path = os.path.join(base_dir, VENV_DIR)
    py = os.path.join(venv_path, "bin", "python")
    if not os.path.exists(py):
        print(f"  🔧 Creating virtual environment at {venv_path} ...")
        subprocess.run([sys.executable, "-m", "venv", venv_path],
                       check=True)
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    print("  📦 Installing torch, numpy and the port into the venv ...")
    subprocess.run([py, "-m", "pip", "install", *REQUIRED], check=True)
    subprocess.run([py, "-m", "pip", "install", "--no-deps", "-e", pkg_root],
                   check=True)
    env = dict(os.environ, **{_REEXEC_GUARD: "1"})
    print("  🔁 Re-executing inside the venv ...")
    os.execve(py, [py, "-m", "openfoam_tpp_tpu_torch"] + sys.argv[1:], env)
    return True  # unreachable
