"""True α=0.5 iso-surface extraction (marching cubes via Kuhn tetrahedra).

Port of openfoam_tpp_tpu/post/isosurface.py (the tables and the host
code are numpy, copied; `surface_stats_mc` runs in PyTorch). The
reference contours the alpha field with VTK (`contour(0.5)`), which is
valid for overturning/breaking waves; the column-height surface in
post/interface.py is exact only for monotone columns. This module
provides the general iso-surface:

  * a 256-entry cube-case triangle table, built at import time by
    decomposing each cube into the 6 Kuhn tetrahedra and marching each
    tetrahedron — correct by construction (no hand-typed MC tables) and
    face-consistent across neighboring cubes (watertight surface);
  * `surface_stats_mc` — on-device max/min/mean/count of the iso-surface
    vertex elevations, with fixed-shape masked reductions (every
    potential edge crossing is computed and masked);
  * `triangulate` — host-side compaction of the triangle soup to a
    (points, triangles) pair for VTP export and 3-D rendering;
  * `columns_monotone` — the fast-path detector: when every fluid column
    is monotone in z, the column-height surface equals this iso-surface
    and is much cheaper.

Scalar lattice: alpha at cell centers; marching cells are the dual cubes
between 2×2×2 neighboring cell centers. Cubes touching solid (non-fluid)
cells are skipped — solid cells carry alpha=0, which would otherwise
fabricate a spurious "surface" along the wetted tank wall (the same
half-cell wall clearance as the reference's r > 0.98 R point filter).
"""

from __future__ import annotations

import numpy as np

ISO = 0.5

# ---------------------------------------------------------------- tables
# Cube vertices: id v in 0..7 with offset bits (vx, vy, vz) = (v&1, v>>1&1,
# v>>2&1). Edges: all ordered pairs (a, b) with a a proper bit-subset of b
# — the union of the Kuhn tetrahedra's edges (19 of them). An edge with
# offsets (a, b) in cube c is the same geometric segment as edge
# (a^a, b^a) = (0, b^a) in cube c+a, so exactly the 7 edges with a == 0
# are "canonical" per cube — used for exact-dedupe point statistics.

_EDGES: list[tuple[int, int]] = [
    (a, b) for a in range(8) for b in range(8) if a != b and (a & b) == a
]
_EDGE_ID = {e: i for i, e in enumerate(_EDGES)}
N_EDGES = len(_EDGES)            # 19
_CANON = [i for i, (a, _) in enumerate(_EDGES) if a == 0]  # 7 canonical

# The 6 Kuhn tetrahedra: chains 0 → … → 7 adding one axis bit at a time,
# one per permutation of (1, 2, 4). Shared faces between neighboring cubes
# split along the same diagonals (translation-invariant), so the surface
# is watertight across cube boundaries.
_TETS: list[tuple[int, int, int, int]] = []
for p in ((1, 2, 4), (1, 4, 2), (2, 1, 4), (2, 4, 1), (4, 1, 2), (4, 2, 1)):
    v0 = 0
    v1 = v0 | p[0]
    v2 = v1 | p[1]
    v3 = v2 | p[2]
    _TETS.append((v0, v1, v2, v3))


def _edge(u, v):
    return _EDGE_ID[(u, v) if (u & v) == u else (v, u)]


def _march_tet(verts, inside):
    """Triangles (as edge-id triples) for one tetrahedron."""
    ins = [v for v in verts if inside[v]]
    outs = [v for v in verts if not inside[v]]
    if len(ins) == 0 or len(outs) == 0:
        return []
    if len(ins) == 1:
        a = ins[0]
        e = [_edge(a, o) for o in outs]
        return [(e[0], e[1], e[2])]
    if len(ins) == 3:
        a = outs[0]
        e = [_edge(a, i) for i in ins]
        return [(e[0], e[2], e[1])]
    # 2 in / 2 out: quad split into two triangles.
    a, b = ins
    c, d = outs
    eac, ead = _edge(a, c), _edge(a, d)
    ebc, ebd = _edge(b, c), _edge(b, d)
    return [(eac, ead, ebd), (eac, ebd, ebc)]


def _build_tables():
    """256-entry case → triangle-edge table, padded with -1."""
    cases = []
    for case in range(256):
        inside = [(case >> v) & 1 == 1 for v in range(8)]
        tris = []
        for tet in _TETS:
            tris.extend(_march_tet(tet, inside))
        cases.append(tris)
    max_t = max(len(t) for t in cases)
    table = np.full((256, max_t, 3), -1, np.int32)
    for case, tris in enumerate(cases):
        for i, tri in enumerate(tris):
            table[case, i] = tri
    return table


TRI_TABLE = _build_tables()          # (256, MAX_TRIS, 3) edge ids, -1 pad
MAX_TRIS = TRI_TABLE.shape[1]
_EDGE_A = np.array([a for a, _ in _EDGES], np.int32)
_EDGE_B = np.array([b for _, b in _EDGES], np.int32)


def _corner_offsets(v):
    return np.array([v & 1, (v >> 1) & 1, (v >> 2) & 1], np.float64)


_OFFS = np.stack([_corner_offsets(v) for v in range(8)])  # (8, 3)


# ------------------------------------------------------------- core math

def _corner_alphas(alpha, xp):
    """The 8 corner scalars of every dual cube; alpha is (..., nx, ny, nz),
    output (..., 8, nx-1, ny-1, nz-1)."""
    sl = {0: slice(0, -1), 1: slice(1, None)}
    parts = []
    for v in range(8):
        parts.append(
            alpha[..., sl[v & 1], sl[(v >> 1) & 1], sl[(v >> 2) & 1]]
        )
    return xp.stack(parts, axis=-4)


def _cube_active_mask(fluid):
    """Cubes whose 8 corner cells are all fluid (numpy, static)."""
    f = fluid
    return (
        f[:-1, :-1, :-1] & f[1:, :-1, :-1] & f[:-1, 1:, :-1] & f[1:, 1:, :-1]
        & f[:-1, :-1, 1:] & f[1:, :-1, 1:] & f[:-1, 1:, 1:] & f[1:, 1:, 1:]
    )


def columns_monotone(alpha, fluid, tol: float = 1e-3) -> bool:
    """True when alpha is non-increasing upward in every fluid column —
    the regime where the column-height surface IS the iso-surface."""
    a = np.asarray(alpha)
    rising = (a[:, :, 1:] - a[:, :, :-1]) > tol
    both_fluid = fluid[:, :, 1:] & fluid[:, :, :-1]
    return not bool(np.any(rising & both_fluid))


def _family_masks(active):
    """Per-family lattice-edge eligibility from the cube-activity mask.

    The 7 edge families are enumerated on the POINT lattice (every
    geometric edge exactly once). An edge is eligible when at least one
    cube containing it is active; the containing cubes of edge
    (p, p + b) are p − m for every m with m & b == 0, which is a
    down-dilation of `active` along the axes not in b."""
    masks = {}
    for e in _CANON:
        b = _EDGES[e][1]
        m = active
        for d in range(3):
            if not (b >> d) & 1:
                # point-axis size = cube-axis size + 1; OR of cubes p-1, p.
                pad_lo = [(0, 0)] * 3
                pad_lo[d] = (1, 0)
                pad_hi = [(0, 0)] * 3
                pad_hi[d] = (0, 1)
                m = np.pad(m, pad_lo) | np.pad(m, pad_hi)
        masks[e] = m
    return masks


def surface_stats_mc(alpha, geom, active=None, iso: float = ISO):
    """(max_z, min_z, mean_z, n_points) over iso-surface vertices, as 0-d
    tensors on alpha's device (`active` is a static numpy mask).

    Vertices are the crossings of the 7 lattice-edge families (each
    geometric edge counted exactly once — the same vertex set
    `triangulate` produces)."""
    import torch

    dev = alpha.device
    if active is None:
        active = _cube_active_mask(geom.fluid)
    masks = _family_masks(np.asarray(active))
    hz = geom.spacing[2]
    z0 = geom.origin[2]
    nx, ny, nz = geom.shape

    big = torch.tensor(1e30, dtype=alpha.dtype, device=dev)
    zmax = -big
    zmin = big
    zsum = torch.zeros((), dtype=alpha.dtype, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    for e in _CANON:
        b = _EDGES[e][1]
        bx, by, bz = b & 1, (b >> 1) & 1, (b >> 2) & 1
        aa = alpha[..., : nx - bx, : ny - by, : nz - bz]
        ab = alpha[..., bx:, by:, bz:]
        crossing = ((aa > iso) != (ab > iso)) & torch.as_tensor(masks[e],
                                                                device=dev)
        diff = ab - aa
        t = (iso - aa) / torch.where(diff.abs() > 1e-12, diff, 1.0)
        t = torch.clamp(t, 0.0, 1.0)
        k = torch.arange(nz - bz, device=dev).reshape(1, 1, -1)
        zc = z0 + (k + 0.5 + t * bz) * hz
        zmax = torch.maximum(zmax, torch.where(crossing, zc, -big).max())
        zmin = torch.minimum(zmin, torch.where(crossing, zc, big).min())
        zsum = zsum + torch.where(crossing, zc, 0.0).sum()
        count = count + crossing.sum().to(torch.int32)
    mean = zsum / torch.clamp(count, min=1)
    return zmax, zmin, mean, count


def triangulate(alpha, geom, active=None, iso: float = ISO):
    """Host-side compacted iso-surface mesh: (points (N,3), tris (M,3)).

    Shared vertices are deduped via canonical (cube, edge) keys, so the
    mesh is watertight. Intended for VTP export and 3-D rendering —
    the on-device path is `surface_stats_mc`. `alpha` is a numpy array."""
    alpha = np.asarray(alpha)
    nx, ny, nz = alpha.shape
    cx, cy, cz = nx - 1, ny - 1, nz - 1
    if active is None:
        active = _cube_active_mask(geom.fluid)

    corners = _corner_alphas(alpha, np)          # (8, cx, cy, cz)
    case = np.zeros((cx, cy, cz), np.int32)
    for v in range(8):
        case |= (corners[v] > iso).astype(np.int32) << v
    act = active & (case != 0) & (case != 255)
    ci, cj, ck = np.nonzero(act)
    if len(ci) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    tri_edges = TRI_TABLE[case[ci, cj, ck]]       # (n, MAX_TRIS, 3)
    valid_tri = tri_edges[:, :, 0] >= 0           # (n, MAX_TRIS)
    n_act = len(ci)

    # Canonical (cube, edge-family) key per referenced edge: shift the
    # cube by the edge's low-corner offset so the family starts at 0.
    te = tri_edges.reshape(n_act, -1)             # (n, MAX_TRIS*3)
    e_flat = te.ravel()
    keep = np.repeat(valid_tri, 3, axis=1).ravel()
    cube_i = np.repeat(ci, te.shape[1])
    cube_j = np.repeat(cj, te.shape[1])
    cube_k = np.repeat(ck, te.shape[1])
    e_safe = np.where(keep, e_flat, 0)
    a_off = _EDGE_A[e_safe]
    b_off = _EDGE_B[e_safe]
    canon_i = cube_i + (a_off & 1)
    canon_j = cube_j + ((a_off >> 1) & 1)
    canon_k = cube_k + ((a_off >> 2) & 1)
    fam = np.where(keep, b_off ^ a_off, 0)        # canonical family = b ^ a
    key = ((canon_i.astype(np.int64) * (cy + 1) + canon_j) * (cz + 1)
           + canon_k) * 8 + fam

    used = keep
    uniq, inverse = np.unique(key[used], return_inverse=True)

    # Crossing point for each unique (cube, family) vertex.
    u_fam = (uniq % 8).astype(np.int32)
    u_k = ((uniq // 8) % (cz + 1)).astype(np.int64)
    u_j = ((uniq // (8 * (cz + 1))) % (cy + 1)).astype(np.int64)
    u_i = (uniq // (8 * (cz + 1) * (cy + 1))).astype(np.int64)
    aa = alpha[u_i, u_j, u_k]
    bi = u_i + (u_fam & 1)
    bj = u_j + ((u_fam >> 1) & 1)
    bk = u_k + ((u_fam >> 2) & 1)
    ab = alpha[bi, bj, bk]
    denom = np.where(np.abs(ab - aa) > 1e-12, ab - aa, 1.0)
    t = np.clip((iso - aa) / denom, 0.0, 1.0)
    hx, hy, hz = geom.spacing
    x0, y0, z0 = geom.origin
    px = x0 + (u_i + 0.5 + t * (u_fam & 1)) * hx
    py = y0 + (u_j + 0.5 + t * ((u_fam >> 1) & 1)) * hy
    pz = z0 + (u_k + 0.5 + t * ((u_fam >> 2) & 1)) * hz
    points = np.stack([px, py, pz], axis=-1)

    # Triangle connectivity: map each (tri, corner) slot to its unique id.
    vert_id = np.full(key.shape, -1, np.int64)
    vert_id[used] = inverse
    vert_id = vert_id.reshape(n_act, MAX_TRIS, 3)
    tris = vert_id[valid_tri]
    return points, tris
