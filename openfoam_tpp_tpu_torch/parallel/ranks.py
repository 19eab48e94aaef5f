"""One process per card: the ranks of the sharded step under
torch.distributed — the port's counterpart of the JAX package's mesh over
distinct devices (openfoam_tpp_tpu/parallel/sharding.py) and of the
collectives GSPMD emits there.

The JAX package runs the sharded step as one GSPMD program over an
(x, y) mesh of N·M devices. The port runs it as N·M processes, one a
card (OpenFOAM's `decomposePar` with `hierarchical (N M 1)` →
`mpirun -np N·M foamRun -parallel`): each rank holds its x·y block of
every array and computes it alone, between the kernel islands too. What
crosses ranks:

  * plane and row exchanges (`RankCtx.exchange(..., axis=)`): a block's
    first or last x planes (axis 0) or y rows (axis 1) to its neighbour
    below or above along that axis, for the islands' halos
    (parallel/spmd.py) and for every x- or y-neighbour access between
    them (ops/stencil.py). y rows of an (x, y, z) array are strided:
    they are copied contiguous before they travel, and the stats count
    those bytes (`copy_bytes`);
  * reductions (`RankCtx.all_reduce`, sum, max and min): each rank's
    partials are gathered to every rank and combined in rank order, so
    every rank holds the same bits and takes the same branch (the CG's
    stop test, the adaptive dt), whatever the backend's own algorithm;
  * whole arrays (`gather_block`, `scatter_block`): the multigrid levels
    whose 2:1 pairs straddle two ranks (solver/poisson.py), checkpoints
    and probe rows (rank 0 writes), a resumed state (rank 0 reads).

Layout. The ranks form an (N, M) grid, N along x and M along y, in the
order r = ix·M + iy (y fastest); `grid` defaults to (world, 1), the 1-D
x decomposition. A sweep farmed over ranks adds a case axis in front:
a (C, N, M) grid, r = ic·N·M + ix·M + iy, where each of the C case
groups (the N·M ranks of one case position) holds its slice of the
batch's cases and cuts it into x·y blocks as above. Neighbours, cuts,
blocks, whole-array gathers and scatters and the reductions stay within
the rank's case group (one process group a case position, made by
`make_groups`); only the lockstep minima of a sweep reduce over the
whole world (`all_reduce(..., world=True)`). A (C, N, M) grid with C = 1
is the (N, M) grid, bit for bit. The grid's nx cells split into N slabs
of nxl = nx/N planes and its ny cells into M rows of nyl = ny/M; rank r
holds cells [ix·nxl, (ix+1)·nxl) × [iy·nyl, (iy+1)·nyl) × all of z. An
x-face array
(nx + 1 planes) keeps nxl + 1 planes on every rank: its block's lower
faces and the next block's first face, which the two ranks hold alike
(the global face-nx wall plane is the last rank's); a y-face array
(ny + 1 rows) keeps nyl + 1 rows the same way. Every rank computes that
shared plane or row from the same operands, so the two copies stay
equal bit for bit; a face array a kernel island writes packed (nxl
planes) takes its last plane from the right neighbour.

Backends. NCCL when every rank has its own card; gloo when ranks share a
card (NCCL refuses two ranks on one GPU) or run on the CPU. gloo's
point-to-point calls take CPU tensors only (its all_reduce, broadcast
and all_gather take CUDA tensors and copy through the host themselves:
chip_smoke.py phase 12d), so under gloo every transfer of a CUDA tensor
goes through a host copy here. `launch` says which backend it chose in
its first log line, and the runner names it in its Mesh line.

`launch(fn, positions, ...)` spawns one process per position (the
`spawn` start method, never `fork` after CUDA is up), joins them through
a `FileStore` in a temporary directory (no network, no port) and returns
each rank's result. Rank 0's log lines reach the caller's `log` while
the ranks run. A rank that fails ends the launch with RuntimeError
naming the rank. The parent builds every kernel library first, so the
ranks do not each run nvcc.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from openfoam_tpp_tpu_torch.device import resolve_device
from openfoam_tpp_tpu_torch.utils.profiling import launch_counts  # noqa: F401

# Seconds a collective may wait for its peers before it raises.
TIMEOUT_S = 300


def backend_for(positions) -> str:
    """NCCL when every position is its own card, else gloo."""
    devs = [torch.device(p) for p in positions]
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


def _listed(t):
    return list(t) if isinstance(t, (list, tuple)) else [t]


def _pack(t):
    """A tensor, or a list of them, as one contiguous byte tensor."""
    parts = [x.contiguous().reshape(-1).view(torch.uint8) for x in _listed(t)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _unpack(buf, like):
    """`_pack`'s inverse: tensors shaped and typed as `like`'s."""
    out, at = [], 0
    for x in _listed(like):
        n = x.numel() * x.element_size()
        out.append(buf[at:at + n].view(x.dtype).reshape(x.shape))
        at += n
    return out if isinstance(like, (list, tuple)) else out[0]


@dataclasses.dataclass
class ExchangeStats:
    """What one rank sent and waited for: x-plane exchanges (one a halo
    call, both directions) and the bytes it sent in them, the same for
    y-row exchanges, the bytes of strided rows copied contiguous before
    sending, reductions, whole-array gathers and scatters, and the host
    seconds spent in all of these."""

    exchanges: int = 0
    bytes: int = 0
    y_exchanges: int = 0
    y_bytes: int = 0
    copy_bytes: int = 0
    all_reduces: int = 0
    gathers: int = 0
    seconds: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(eq=False)
class RankCtx:
    """This process's place among the ranks: its rank, the world size,
    its torch.device, the backend of the default process group and the
    rank grid: (N, M) (default (world, 1)), or (C, N, M) with C case
    positions in front, which sets `cases` = C and `grid` = (N, M). Rank
    r sits at case position ic = r // (N·M) and, within its case group,
    at (ix, iy) = (l // M, l % M), l = r % (N·M)."""

    rank: int
    world: int
    device: torch.device
    backend: str
    stats: ExchangeStats = dataclasses.field(default_factory=ExchangeStats)
    grid: tuple = None
    cases: int = 1
    # The case group's process group (None: the world's, with C = 1).
    group: object = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.grid is None:
            self.grid = (self.world // self.cases, 1)
        grid = tuple(int(g) for g in self.grid)
        if len(grid) == 3:
            self.cases, grid = grid[0], grid[1:]
        self.grid = grid
        if (len(grid) != 2
                or self.cases * grid[0] * grid[1] != self.world):
            shown = (self.cases, *grid) if self.cases > 1 else grid
            raise ValueError(
                f"a rank grid {shown} for {self.world} ranks: N·M must be "
                "the world size (C·N·M with C case positions in front)")

    @property
    def group_size(self) -> int:
        """N·M: the ranks of one case position."""
        return self.grid[0] * self.grid[1]

    @property
    def ic(self) -> int:
        """This rank's case position."""
        return self.rank // self.group_size

    @property
    def lead(self) -> int:
        """The first rank of this rank's case group."""
        return self.ic * self.group_size

    @property
    def ix(self) -> int:
        return (self.rank - self.lead) // self.grid[1]

    @property
    def iy(self) -> int:
        return (self.rank - self.lead) % self.grid[1]

    def make_groups(self):
        """One process group a case position (every rank takes part, in
        the same order); nothing with one case position, whose group is
        the world."""
        if self.cases > 1 and self.group is None:
            n = self.group_size
            for c in range(self.cases):
                g = dist.new_group(list(range(c * n, (c + 1) * n)))
                if c == self.ic:
                    self.group = g
        return self

    def neighbours(self, axis: int = 0):
        """(lo, hi): the ranks below and above this one along x (axis 0)
        or y (axis 1) within its case group, None at a global end."""
        n, m = self.grid
        if axis == 0:
            return (self.rank - m if self.ix > 0 else None,
                    self.rank + m if self.ix < n - 1 else None)
        return (self.rank - 1 if self.iy > 0 else None,
                self.rank + 1 if self.iy < m - 1 else None)

    @property
    def left(self):
        return self.neighbours(0)[0]

    @property
    def right(self):
        return self.neighbours(0)[1]

    # --- transport ----------------------------------------------------
    def _staged(self, t):
        """gloo moves CPU tensors only: a CUDA tensor goes through the
        host there."""
        return t.cpu() if self.backend == "gloo" else t

    def _back(self, t):
        return t.to(self.device, non_blocking=True)

    def exchange(self, send_lo, send_hi, axis: int = 0):
        """Send `send_lo` to the neighbour below along `axis` (0: x, the
        left one; 1: y) and `send_hi` to the one above; returns
        (from_lo, from_hi): the lower neighbour's `send_hi` and the upper
        neighbour's `send_lo` (None at a global end, or where nothing of
        that side is sent). Each side is a tensor or a list of tensors
        (any dtypes and strides, sent as one message of bytes, and
        received as a list of the same shapes, contiguous). Every rank
        makes the same call, so the shapes match."""
        t0 = time.perf_counter()
        lo_peer, hi_peer = self.neighbours(axis)
        out = [None, None]
        sends, recvs = [], []
        for t, peer in ((send_lo, lo_peer), (send_hi, hi_peer)):
            if t is not None and peer is not None:
                self.stats.copy_bytes += sum(
                    x.numel() * x.element_size() for x in _listed(t)
                    if not x.is_contiguous())
                sends.append((self._staged(_pack(t)), peer))
        for i, (like, peer) in enumerate(((send_hi, lo_peer),
                                          (send_lo, hi_peer))):
            if like is not None and peer is not None:
                n = sum(x.numel() * x.element_size() for x in _listed(like))
                buf = torch.empty(n, dtype=torch.uint8,
                                  device="cpu" if self.backend == "gloo"
                                  else self.device)
                recvs.append((i, buf, peer, like))
        if sends or recvs:
            if self.backend == "nccl":
                ops = ([dist.P2POp(dist.isend, t, p) for t, p in sends]
                       + [dist.P2POp(dist.irecv, b, p)
                          for _, b, p, _ in recvs])
                reqs = dist.batch_isend_irecv(ops)
            else:
                reqs = ([dist.isend(t, p) for t, p in sends]
                        + [dist.irecv(b, p) for _, b, p, _ in recvs])
            for r in reqs:
                r.wait()
            for i, buf, _, like in recvs:
                out[i] = _unpack(self._back(buf), like)
            sent = sum(t.numel() for t, _ in sends)
            if axis == 0:
                self.stats.exchanges += 1
                self.stats.bytes += sent
            else:
                self.stats.y_exchanges += 1
                self.stats.y_bytes += sent
        self.stats.seconds += time.perf_counter() - t0
        return out[0], out[1]

    def all_gather(self, t, world: bool = False):
        """Every rank's `t` of the case group (of the `world`), same
        shape everywhere, in rank order, on this rank's device."""
        t0 = time.perf_counter()
        parts = self._gather(t, world)
        self.stats.gathers += 1
        self.stats.seconds += time.perf_counter() - t0
        return parts

    def _gather(self, t, world: bool = False):
        """`all_gather` uncounted, over the case group (or the `world`):
        `t` travels as bytes, so any dtype crosses bit for bit (gloo's
        gather refuses some, int16 among them)."""
        wire = self._staged(t.contiguous().reshape(-1).view(torch.uint8))
        n = self.world if world else self.group_size
        parts = [torch.empty_like(wire) for _ in range(n)]
        dist.all_gather(parts, wire, group=None if world else self.group)
        return [self._back(p).view(t.dtype).reshape(t.shape) for p in parts]

    def all_reduce(self, *ts, op: str = "sum", world: bool = False):
        """The sum, max or min over the ranks of the case group (every
        rank with `world`) of each 0-d (or equally shaped) tensor in
        `ts`, in one collective: the partials are gathered and combined
        in rank order on every rank (a NaN propagates, as torch.maximum
        does). One tensor in, one out; several in, a tuple out."""
        t0 = time.perf_counter()
        flat = torch.stack([t.reshape(-1) for t in ts])
        parts = self._gather(flat, world)
        if op == "sum":
            total = parts[0]
            for p in parts[1:]:
                total = total + p
        elif op in ("max", "min"):
            fn = torch.maximum if op == "max" else torch.minimum
            total = parts[0]
            for p in parts[1:]:
                total = fn(total, p)
        else:
            raise ValueError(f"all_reduce: op {op!r} (sum, max or min)")
        self.stats.all_reduces += 1
        self.stats.seconds += time.perf_counter() - t0
        outs = tuple(total[i].reshape(t.shape) for i, t in enumerate(ts))
        return outs[0] if len(outs) == 1 else outs

    # --- whole arrays -------------------------------------------------
    def cut(self, t, n: int, axis: int, rank: int | None = None,
            dim: int | None = None):
        """This rank's (or `rank`'s) part along grid `axis` (0: x, 1: y)
        of its case group
        of a global array of `n` cells there (or n + 1 faces: the block's
        faces and the next block's first), cut along its dimension `dim`
        (default `axis`; 0 for a 1-D coordinate array). Works on tensors
        and numpy arrays."""
        r = (self.rank if rank is None else rank) % self.group_size
        i = r // self.grid[1] if axis == 0 else r % self.grid[1]
        dim = axis if dim is None else dim
        nl = n // self.grid[axis]
        faces = t.shape[dim] == n + 1
        sl = [slice(None)] * t.ndim
        sl[dim] = slice(i * nl, (i + 1) * nl + (1 if faces else 0))
        return t[tuple(sl)]

    def block(self, t, shape, rank: int | None = None):
        """This rank's (or `rank`'s) x·y block of a global array on a
        grid of `shape` cells (nx, ny, ...): along x its slab, along y
        (where the array has a second dimension) its rows; face arrays
        keep the shared plane or row."""
        t = self.cut(t, shape[0], 0, rank)
        return self.cut(t, shape[1], 1, rank) if t.ndim > 1 else t

    def gather_block(self, t, faces: int | None = None):
        """The global array from the blocks of the case group's ranks, on
        each of them (any trailing dimensions, a batch's cases among
        them, carried).
        `faces` (0 or 1): `t` is a face array along that axis, whose
        blocks drop the plane or row their upper neighbour holds too."""
        t0 = time.perf_counter()
        parts = self._gather(t)
        n, m = self.grid
        cols = []
        for ix in range(n):
            row = parts[ix * m:(ix + 1) * m]
            if faces == 1:
                row = [p[:, :-1] for p in row[:-1]] + row[-1:]
            cols.append(torch.cat(row, 1) if m > 1 else row[0])
        if faces == 0:
            cols = [c[:-1] for c in cols[:-1]] + cols[-1:]
        self.stats.gathers += 1
        self.stats.seconds += time.perf_counter() - t0
        return torch.cat(cols, 0)

    def scatter_block(self, g, shape, dtype, gshape):
        """The case group's first rank's global array `g` (None on the
        other ranks) on a grid of `gshape` cells cut into blocks: each
        rank of the group returns its own, `shape` and `dtype` (the
        block's), on its device."""
        t0 = time.perf_counter()
        if self.rank == self.lead:
            g = g.to(self.device)
            for r in range(self.lead + 1, self.lead + self.group_size):
                part = self.block(g, gshape, rank=r)
                dist.send(self._staged(part.contiguous()), r)
            out = self.block(g, gshape).contiguous()
        else:
            buf = torch.empty(shape, dtype=dtype,
                              device="cpu" if self.backend == "gloo"
                              else self.device)
            dist.recv(buf, self.lead)
            out = self._back(buf)
        self.stats.gathers += 1
        self.stats.seconds += time.perf_counter() - t0
        return out

    def broadcast(self, obj, group: bool = False):
        """Rank 0's picklable `obj` on every rank (with `group`, the case
        group's first rank's on the group's ranks)."""
        src = self.lead if group else 0
        box = [obj if self.rank == src else None]
        dist.broadcast_object_list(box, src=src,
                                   group=self.group if group else None)
        return box[0]


# ------------------------------------------------------------------ state

_CELL_FIELDS = ("alpha", "p", "w")


def scatter_state(state, shape, ranks: RankCtx):
    """The case group's first rank's global SimState (None elsewhere) as
    every rank's block state on its device: each field cut by cells, or
    by faces along its own axis, the scalars whole."""
    from openfoam_tpp_tpu_torch.core.state import SimState

    nx, ny, nz = shape
    nxl, nyl = nx // ranks.grid[0], ny // ranks.grid[1]
    shapes = {"alpha": (nxl, nyl, nz), "p": (nxl, nyl, nz),
              "u": (nxl + 1, nyl, nz), "v": (nxl, nyl + 1, nz),
              "w": (nxl, nyl, nz + 1)}
    f = {k: ranks.scatter_block(None if state is None
                                else getattr(state, k),
                                s, torch.float32, shape)
         for k, s in shapes.items()}
    scalars = ranks.broadcast(None if state is None else
                              {k: getattr(state, k).cpu()
                               for k in ("t", "dt", "step")}, group=True)
    return SimState(**f, **{k: v.to(ranks.device)
                            for k, v in scalars.items()})


def gather_state(state, ranks: RankCtx):
    """The global SimState on the CPU from the blocks of the case group's
    ranks (every rank of the group takes part; all get it)."""
    from openfoam_tpp_tpu_torch.core.state import SimState

    f = {k: ranks.gather_block(getattr(state, k)).cpu()
         for k in _CELL_FIELDS}
    f["u"] = ranks.gather_block(state.u, faces=0).cpu()
    f["v"] = ranks.gather_block(state.v, faces=1).cpu()
    return SimState(**f, **{k: getattr(state, k).cpu()
                            for k in ("t", "dt", "step")})


# ----------------------------------------------------------------- launch

def _rank_main(i, world, positions, backend, store_path, fn, args, queue,
               timeout_s, grid=None):
    """One rank: join the group, run `fn(ctx, log, *args)`, hand its
    result to the parent."""
    dev = torch.device(positions[i])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # The ranks share the host's cores.
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world), rank=i,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        ctx = RankCtx(rank=i, world=world, device=dev, backend=backend,
                      grid=grid).make_groups()

        def log(line):
            if i == 0:
                queue.put(("log", i, line))

        queue.put(("result", i, fn(ctx, log, *args)))
    finally:
        dist.destroy_process_group()


def launch(fn, positions, args=(), log=print, timeout_s: int = TIMEOUT_S,
           grid=None):
    """Run `fn(ctx, log, *args)` on one spawned process per position
    (a torch.device or its name) and return each rank's result, in rank
    order. `grid` (N, M): the ranks' x·y grid, N·M positions in the order r
    = ix·M + iy (default (N, 1)); (C, N, M): C case positions of such
    grids, r = ic·N·M + ix·M + iy. `fn` and `args` are pickled: `fn` must
    be a module-level function. Rank 0's `log(line)` calls reach `log` here
    while the ranks run. A rank that raises, or dies, ends the launch with
    RuntimeError naming the rank; the other ranks are stopped."""
    positions = [torch.device(p) for p in positions]
    world = len(positions)
    backend = backend_for(positions)
    if any(p.type == "cuda" for p in positions):
        resolve_device(positions[0])
        from openfoam_tpp_tpu_torch.ops.kernels import _build

        _build.build_all()
    shared = len(set(positions)) < world
    grid = (world, 1) if grid is None else tuple(int(g) for g in grid)
    if len(grid) not in (2, 3) or int(np.prod(grid)) != world:
        raise ValueError(f"a rank grid {grid} for {world} positions")
    log(f"  ranks: {world} processes"
        + (f" ({'x'.join(map(str, grid))}, y fastest)"
           if grid[-1] > 1 or len(grid) == 3 else "")
        + " on "
        f"{', '.join(str(p) for p in positions)}, backend {backend}"
        + (" (ranks share a device: gloo, CUDA tensors through the host)"
           if shared and positions[0].type == "cuda" else ""))
    queue = torch.multiprocessing.get_context("spawn").SimpleQueue()
    results = {}

    def drain():
        while not queue.empty():
            kind, rank, payload = queue.get()
            if kind == "log":
                log(payload)
            else:
                results[rank] = payload

    with tempfile.TemporaryDirectory(prefix="oftpp_ranks_") as tmp:
        procs = torch.multiprocessing.start_processes(
            _rank_main, args=(world, [str(p) for p in positions], backend,
                              os.path.join(tmp, "store"), fn, tuple(args),
                              queue, timeout_s, grid),
            nprocs=world, join=False, start_method="spawn")
        try:
            while True:
                drain()
                if procs.join(timeout=0.05):
                    break
        except torch.multiprocessing.ProcessRaisedException as e:
            raise RuntimeError(
                f"rank {e.error_index} of {world} ({backend}) failed:\n"
                f"{e}") from None
        except torch.multiprocessing.ProcessExitedException as e:
            raise RuntimeError(
                f"rank {e.error_index} of {world} ({backend}) died with "
                f"exit code {e.exit_code}") from None
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.terminate()
                    p.join()
        drain()
    missing = [r for r in range(world) if r not in results]
    if missing:
        raise RuntimeError(f"ranks {missing} of {world} ended without a "
                           "result")
    return [results[r] for r in range(world)]
