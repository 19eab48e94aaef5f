"""One process per card: the ranks of the x-sharded step under
torch.distributed — the port's counterpart of the JAX package's mesh over
distinct devices (openfoam_tpp_tpu/parallel/sharding.py) and of the
collectives GSPMD emits there.

The JAX package runs the x-sharded step as one GSPMD program over N
devices. The port runs it as N processes, one a card (OpenFOAM's
`decomposePar` → `mpirun -np N foamRun -parallel`): each rank holds its
x-slab of every array and computes it alone, between the kernel islands
too. What crosses ranks:

  * plane exchanges (`RankCtx.exchange`): a slab's first or last planes
    to its left or right neighbour, for the islands' halos
    (parallel/spmd.py) and for every x-neighbour access between them
    (ops/stencil.py);
  * reductions (`RankCtx.all_reduce`, sum, max and min): each rank's
    partials are gathered to every rank and combined in rank order, so
    every rank holds the same bits and takes the same branch (the CG's
    stop test, the adaptive dt), whatever the backend's own algorithm;
  * whole arrays (`gather_x`, `scatter_x`): the multigrid levels whose
    2:1 pairs straddle two ranks (solver/poisson.py), checkpoints and
    probe rows (rank 0 writes), a resumed state (rank 0 reads).

Layout. The grid's nx cells split into `world` slabs of nxl = nx/world
planes. An x-face array (nx + 1 planes) keeps nxl + 1 planes on every
rank: its slab's lower faces and the next slab's first face, which the
two ranks hold alike (the global face-nx wall plane is the last rank's).
Every rank computes that shared plane from the same operands, so the two
copies stay equal bit for bit; a face array a kernel island writes
packed (nxl planes) takes its last plane from the right neighbour.

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

import torch
import torch.distributed as dist

from openfoam_tpp_tpu_torch.device import resolve_device

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
    """What one rank sent and waited for: plane exchanges (one a halo
    call, both directions), bytes it sent in them, reductions, whole-array
    gathers and scatters, and the host seconds spent in all of these."""

    exchanges: int = 0
    bytes: int = 0
    all_reduces: int = 0
    gathers: int = 0
    seconds: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(eq=False)
class RankCtx:
    """This process's place among the ranks: its rank, the world size,
    its torch.device and the backend of the default process group."""

    rank: int
    world: int
    device: torch.device
    backend: str
    stats: ExchangeStats = dataclasses.field(default_factory=ExchangeStats)

    @property
    def left(self):
        return self.rank - 1 if self.rank > 0 else None

    @property
    def right(self):
        return self.rank + 1 if self.rank < self.world - 1 else None

    # --- transport ----------------------------------------------------
    def _staged(self, t):
        """gloo moves CPU tensors only: a CUDA tensor goes through the
        host there."""
        return t.cpu() if self.backend == "gloo" else t

    def _back(self, t):
        return t.to(self.device, non_blocking=True)

    def exchange(self, send_lo, send_hi):
        """Send `send_lo` to the left neighbour and `send_hi` to the right
        one; returns (from_lo, from_hi): the left neighbour's `send_hi`
        and the right neighbour's `send_lo` (None at a global end, or
        where nothing of that side is sent). Each side is a tensor or a
        list of tensors (any dtypes, sent as one message of bytes, and
        received as a list of the same shapes). Every rank makes the same
        call, so the shapes match."""
        t0 = time.perf_counter()
        out = [None, None]
        sends, recvs = [], []
        for t, peer in ((send_lo, self.left), (send_hi, self.right)):
            if t is not None and peer is not None:
                sends.append((self._staged(_pack(t)), peer))
        for i, (like, peer) in enumerate(((send_hi, self.left),
                                          (send_lo, self.right))):
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
            self.stats.exchanges += 1
            self.stats.bytes += sum(t.numel() for t, _ in sends)
        self.stats.seconds += time.perf_counter() - t0
        return out[0], out[1]

    def all_gather(self, t):
        """Every rank's `t` (same shape everywhere), in rank order, on
        this rank's device."""
        t0 = time.perf_counter()
        parts = self._gather(t)
        self.stats.gathers += 1
        self.stats.seconds += time.perf_counter() - t0
        return parts

    def _gather(self, t):
        """`all_gather` uncounted: `t` travels as bytes, so any dtype
        crosses bit for bit (gloo's gather refuses some, int16 among
        them)."""
        wire = self._staged(t.contiguous().reshape(-1).view(torch.uint8))
        parts = [torch.empty_like(wire) for _ in range(self.world)]
        dist.all_gather(parts, wire)
        return [self._back(p).view(t.dtype).reshape(t.shape) for p in parts]

    def all_reduce(self, *ts, op: str = "sum"):
        """The sum, max or min over the ranks of each 0-d (or equally
        shaped) tensor in `ts`, in one collective: the partials are
        gathered and combined in rank order on every rank (a NaN
        propagates, as torch.maximum does). One tensor in, one out;
        several in, a tuple out."""
        t0 = time.perf_counter()
        flat = torch.stack([t.reshape(-1) for t in ts])
        parts = self._gather(flat)
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
    def slab(self, t, nx: int, rank: int | None = None):
        """This rank's (or `rank`'s) x-slab of a global array of `nx`
        cells along x (or nx + 1 faces: the slab's faces and the next
        slab's first)."""
        nxl = nx // self.world
        lo = (self.rank if rank is None else rank) * nxl
        faces = t.shape[0] == nx + 1
        return t[lo:lo + nxl + (1 if faces else 0)]

    def gather_x(self, t, faces: bool = False):
        """The global array from every rank's x-slab, on every rank (a
        face array drops the planes its right neighbour holds too)."""
        t0 = time.perf_counter()
        parts = self._gather(t)
        if faces:
            parts = [p[:-1] for p in parts[:-1]] + parts[-1:]
        self.stats.gathers += 1
        self.stats.seconds += time.perf_counter() - t0
        return torch.cat(parts, 0)

    def scatter_x(self, g, shape, dtype, nx: int):
        """Rank 0's global array `g` (None on other ranks) cut into
        x-slabs: each rank returns its own, `shape` and `dtype` (the slab's),
        on its device."""
        t0 = time.perf_counter()
        if self.rank == 0:
            g = g.to(self.device)
            for r in range(1, self.world):
                part = self.slab(g, nx, rank=r)
                dist.send(self._staged(part.contiguous()), r)
            out = self.slab(g, nx).contiguous()
        else:
            buf = torch.empty(shape, dtype=dtype,
                              device="cpu" if self.backend == "gloo"
                              else self.device)
            dist.recv(buf, 0)
            out = self._back(buf)
        self.stats.gathers += 1
        self.stats.seconds += time.perf_counter() - t0
        return out

    def broadcast(self, obj):
        """Rank 0's picklable `obj` on every rank."""
        box = [obj if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        return box[0]


# ------------------------------------------------------------------ state

_CELL_FIELDS = ("alpha", "p", "v", "w")


def scatter_state(state, shape, ranks: RankCtx):
    """Rank 0's global SimState (None elsewhere) as every rank's slab
    state on its device: alpha, p, v and w by cells along x, u by faces,
    the scalars whole."""
    from openfoam_tpp_tpu_torch.core.state import SimState

    nx, ny, nz = shape
    nxl = nx // ranks.world
    shapes = {"alpha": (nxl, ny, nz), "p": (nxl, ny, nz),
              "u": (nxl + 1, ny, nz), "v": (nxl, ny + 1, nz),
              "w": (nxl, ny, nz + 1)}
    f = {k: ranks.scatter_x(None if state is None else getattr(state, k),
                            s, torch.float32, nx)
         for k, s in shapes.items()}
    scalars = ranks.broadcast(None if state is None else
                              {k: getattr(state, k).cpu()
                               for k in ("t", "dt", "step")})
    return SimState(**f, **{k: v.to(ranks.device)
                            for k, v in scalars.items()})


def gather_state(state, ranks: RankCtx):
    """The global SimState on the CPU from every rank's slab (every rank
    takes part; all get it)."""
    from openfoam_tpp_tpu_torch.core.state import SimState

    f = {k: ranks.gather_x(getattr(state, k)).cpu() for k in _CELL_FIELDS}
    f["u"] = ranks.gather_x(state.u, faces=True).cpu()
    return SimState(**f, **{k: getattr(state, k).cpu()
                            for k in ("t", "dt", "step")})


def launch_counts() -> dict:
    """Every kernel entry point's launch count in this process, keyed
    'module.function' (the kernel modules of ops/kernels)."""
    from openfoam_tpp_tpu_torch.ops.kernels import (correction, halo7,
                                                    mom_finish, momentum_rhs,
                                                    mules_fct, mules_flux,
                                                    seven_point)

    out = {}
    for mod in (seven_point, halo7, mules_flux, mules_fct, momentum_rhs,
                correction, mom_finish):
        short = mod.__name__.rsplit(".", 1)[1]
        for name, fn in vars(mod).items():
            if callable(fn) and hasattr(fn, "launches"):
                out[f"{short}.{name}"] = fn.launches
    return out


# ----------------------------------------------------------------- launch

def _rank_main(i, world, positions, backend, store_path, fn, args, queue,
               timeout_s):
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
        ctx = RankCtx(rank=i, world=world, device=dev, backend=backend)

        def log(line):
            if i == 0:
                queue.put(("log", i, line))

        queue.put(("result", i, fn(ctx, log, *args)))
    finally:
        dist.destroy_process_group()


def launch(fn, positions, args=(), log=print, timeout_s: int = TIMEOUT_S):
    """Run `fn(ctx, log, *args)` on one spawned process per position
    (a torch.device or its name) and return each rank's result, in rank
    order. `fn` and `args` are pickled: `fn` must be a module-level
    function. Rank 0's `log(line)` calls reach `log` here while the ranks
    run. A rank that raises, or dies, ends the launch with RuntimeError
    naming the rank; the other ranks are stopped."""
    positions = [torch.device(p) for p in positions]
    world = len(positions)
    backend = backend_for(positions)
    if any(p.type == "cuda" for p in positions):
        resolve_device(positions[0])
        from openfoam_tpp_tpu_torch.ops.kernels import _build

        _build.build_all()
    shared = len(set(positions)) < world
    log(f"  ranks: {world} processes on "
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
                              queue, timeout_s),
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
