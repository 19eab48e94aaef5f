"""Case naming codec.

The port's own copy of ``openfoam_tpp_tpu/utils/naming.py`` (it imports
nothing of that package); the MATLAB-style sweep parsing comes with
the menu. Case folder names are the persistent parameter
store, so the encoding round-trips byte-identically with the reference
manager's format:

    case_H{H}_D{D}_{geo}_R{R}_f{freq}_d{duration}_m{mesh}
"""

from __future__ import annotations

import re

from openfoam_tpp_tpu_torch.config import DEFAULTS

_CASE_RE = re.compile(
    r"case_H([\d.]+)_D([\d.]+)_(\w+?)_R([\d.]+)_f([\d.]+)_d([\d.]+)_m([\d.]+)"
)


def get_case_name(params: dict) -> str:
    """Encode a parameter dict into the canonical case folder name."""
    p = params
    return (
        f"case_H{p['H']}_D{p['D']}_{p['geo']}_R{p['R']}"
        f"_f{p['freq']}_d{p['duration']}_m{p['mesh']}"
    )


def parse_case_params(case_name: str) -> dict:
    """Decode a case folder name back into a parameter dict.

    Unknown names fall back to DEFAULTS (reference behavior). The parsed
    *duration* is kept authoritative downstream.
    """
    m = _CASE_RE.match(case_name)
    if not m:
        return dict(DEFAULTS)
    out = dict(DEFAULTS)
    out.update(
        H=float(m.group(1)),
        D=float(m.group(2)),
        geo=m.group(3),
        R=float(m.group(4)),
        freq=float(m.group(5)),
        duration=float(m.group(6)),
        mesh=float(m.group(7)),
    )
    return out
