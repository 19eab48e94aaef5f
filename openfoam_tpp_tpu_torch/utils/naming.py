"""Case naming codec.

The port's own copy of ``openfoam_tpp_tpu/utils/naming.py`` (it imports
nothing of that package), with the menu's MATLAB-style range and
index parsing. Case folder names are the persistent parameter
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


def parse_range(spec: str) -> list[float]:
    """Parse a MATLAB-style range ``start:step:end`` or comma list.

    ``"1:0.5:3"`` -> [1.0, 1.5, 2.0, 2.5, 3.0]; ``"1:3"`` -> [1, 2, 3];
    ``"0.1, 0.2"`` -> [0.1, 0.2]. End-inclusive with 1e-9 float tolerance,
    values rounded to 6 decimals (so folder names stay short), matching the
    reference semantics (main.py:118-142).
    """
    spec = spec.strip()
    if ":" not in spec:
        return [float(tok) for tok in spec.split(",") if tok.strip()]
    parts = [float(tok) for tok in spec.split(":")]
    if len(parts) == 2:
        start, step, end = parts[0], 1.0, parts[1]
    elif len(parts) == 3:
        start, step, end = parts
    else:
        raise ValueError(f"Invalid range format: {spec!r}")
    if step == 0:
        raise ValueError("step must be nonzero")
    vals = []
    v = start
    while v <= end + 1e-9:
        vals.append(round(v, 6))
        v += step
    return vals


def parse_indices(spec: str, max_idx: int) -> list[int]:
    """Parse 1-based selections like ``"1, 3-5, 7"`` or ``"all"``.

    Returns sorted 0-based indices, silently clamping out-of-range entries
    (main.py:144-161 behavior).
    """
    if spec.strip().lower() == "all":
        return list(range(max_idx))
    picked: set[int] = set()
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "-" in tok:
            lo, hi = tok.split("-")
            for i in range(int(lo), int(hi) + 1):
                if 1 <= i <= max_idx:
                    picked.add(i - 1)
        else:
            i = int(tok)
            if 1 <= i <= max_idx:
                picked.add(i - 1)
    return sorted(picked)


def format_float(x: float) -> str:
    """Format a float the way the reference embeds params in names
    (plain str() of the Python float, e.g. 0.1, 2.0, 0.009)."""
    return str(x)
