"""Rank groups and the (sweep, cells) device mesh on ``torch.distributed``
(counterpart of ``parallel/sharding.py``): sweep DP x element-partitioned
operator TP.

  "sweep" (DP): the sweep columns (mu values, Pe values) are split over
      the ranks of this mesh dimension; every vector operation and
      reduction is column-local, so this dimension carries no collective
      inside a solve.
  "cells" (TP): the element loop of the operator is split over the ranks
      of this dimension; each rank applies its chunk of elements into a
      full dof vector and one all-reduce over "cells" sums the partial
      results.  A rank holds only its chunk of the fine element arrays.

The JAX package runs this as one program over the devices of one process
(``shard_map`` on a ``Mesh``).  Here every rank is a process: a
:class:`RankGroup` spawns them once (a study run, a test module), they meet
through a ``FileStore`` in a temporary directory, and each ``run`` executes
one SPMD function on every rank and hands rank 0's result back.  Rank r
works on ``cuda:(r % torch.cuda.device_count())``, or on the CPU when the
caller asks for it; nothing falls back from the card to the CPU.

Backends: gloo on the CPU and nccl on CUDA by default.  NCCL takes one card
per rank, so more ranks than cards under nccl raises; gloo shares a card
between ranks, its all-reduce taking the CUDA tensors where they are (the
buffers stay on the card between collectives).

The ranks receive what they solve from the caller (host copies of the
systems the caller built); they build no mesh and no system of their own,
and write no file.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import setup

__all__ = ["make_device_mesh", "resolve_backend", "RankContext",
           "RankGroup", "all_reduce_sum", "kernel_launches",
           "loaded_modules",
           "ShardedMuSweep", "build_sharded_mu_sweep",
           "solve_mu_sweep_sharded"]

# seconds a rank waits in one collective before it raises (a rank that
# died or took another branch must not hang the others for ever)
COLLECTIVE_TIMEOUT_S = 600
BACKENDS = ("gloo", "nccl")


def resolve_backend(device, backend: Optional[str], n_ranks: int) -> str:
    """The process-group backend of ``n_ranks`` ranks on ``device``: None
    takes gloo on the CPU and nccl on CUDA.  NCCL needs CUDA and one card
    per rank, and raises otherwise."""
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "nccl":
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        if n_ranks > cards:
            raise ValueError(
                f"backend='nccl' needs one CUDA card per rank: {n_ranks} "
                f"ranks on {cards} card(s) of device {dev}; NCCL refuses two "
                "ranks on one card. Use backend='gloo' to share the cards")
    return backend


def make_device_mesh(n_devices: int, tp: int, device, backend=None):
    """The ("sweep", "cells") DeviceMesh of this process group, dp =
    n_devices / tp rows of tp ranks: rank r sits at (r // tp, r % tp).
    Called inside a rank, after its process group is up; its two
    sub-groups are ``mesh.get_group("sweep")`` and
    ``mesh.get_group("cells")``."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = torch.device(device)
    backend = resolve_backend(dev, backend, n_devices)
    if tp < 1 or n_devices % tp:
        raise ValueError(f"tp={tp} does not divide {n_devices} ranks")
    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh runs inside a rank whose "
                           "process group is up (RankGroup)")
    if dist.get_world_size() != n_devices or dist.get_backend() != backend:
        raise RuntimeError(
            f"process group of {dist.get_world_size()} ranks on "
            f"{dist.get_backend()}, asked for {n_devices} on {backend}")
    return DeviceMesh(dev.type, torch.arange(n_devices).reshape(-1, tp),
                      mesh_dim_names=("sweep", "cells"))


class RankContext(NamedTuple):
    """What an SPMD function receives as its first argument in a rank."""
    rank: int
    device: torch.device
    mesh: object              # the ("sweep", "cells") DeviceMesh


def all_reduce_sum(t, group):
    """Sum ``t`` in place over the ranks of ``group`` (one collective,
    counted in ``all_reduce_sum.calls``); returns ``t``."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    all_reduce_sum.calls += 1
    return t


all_reduce_sum.calls = 0


def kernel_launches():
    """The hand kernels' launch counters in this process, by kernel and by
    form (kernel C's full and out= forms, per-sample and bf16 launches
    among them)."""
    from ..ops.banded import band_apply, rect_band_apply
    from ..ops.elemspmv import ElementKernel
    return {"band_apply": band_apply.launches,
            "rect_band_apply": rect_band_apply.launches,
            "element_apply": ElementKernel.launches,
            "element_apply out": ElementKernel.launches_out,
            "element_apply full": (ElementKernel.launches
                                   - ElementKernel.launches_out),
            "element_apply per-sample": ElementKernel.launches_sample,
            "band_apply bf16": band_apply.launches_bf16,
            "rect_band_apply bf16": (rect_band_apply.launches_bf16
                                     + rect_band_apply.launches_bf16_band),
            "rect_band_apply bf16 band": rect_band_apply.launches_bf16_band,
            "element_apply bf16": ElementKernel.launches_bf16}


def _rank_main(rank, n, tp, device, backend, store_path, conn):
    """A rank's process: join the group, build the mesh, then run the
    SPMD functions the parent sends until it sends None."""
    def reply(**msg):
        conn.send_bytes(pickle.dumps(msg))

    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        # the ranks share the host's cores
        torch.set_num_threads(1 if dev.type == "cpu"
                              else max(1, (os.cpu_count() or 1) // n))
        setup(dev)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, n), rank=rank,
            world_size=n,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        ctx = RankContext(rank, dev, make_device_mesh(n, tp, dev, backend))
    except BaseException:
        reply(ok=False, error=traceback.format_exc())
        return
    reply(ok=True, result=None, launches={})
    while True:
        path = pickle.loads(conn.recv_bytes())
        if path is None:
            break
        with open(path, "rb") as f:
            task = pickle.load(f)
        before = kernel_launches()
        try:
            fn, args, kwargs = task
            out = fn(ctx, *args, **kwargs)
            after = kernel_launches()
            reply(ok=True, result=out,
                  launches={k: after[k] - before[k] for k in after})
        except BaseException:
            reply(ok=False, error=traceback.format_exc())
    dist.destroy_process_group()


class RankGroup:
    """``n`` rank processes, dp = n / tp sweep rows of tp cells ranks each,
    on ``device`` ("cuda" or "cpu") over ``backend`` (None: gloo on the
    CPU, nccl on CUDA).  Start it once per study run or test module, not
    per solve, and close it (or use it as a context manager).

    ``run(fn, *args, **kwargs)`` calls ``fn(ctx, *args, **kwargs)`` on
    every rank (``fn`` a module-level function, pickled by name, so the
    ranks import only its module) and returns rank 0's result;
    ``results`` holds every rank's result of the last run, and
    ``launches`` the hand kernels' launches of every run since the group
    started, summed over the ranks.  ``log``: None, or a list to which the
    parent's sharded calls (``sharded_solve.solve_sweep_sharded``,
    ``stokes_solve_sharded``) append one record per call (what they were
    given and what they returned), for a caller that holds the solves of
    a study against references.
    Results cross as pickles: numpy arrays, not CUDA tensors.  A rank that
    raises, or dies, closes the group and raises here with its traceback.

    On CUDA the kernel library is built here, before the ranks start, so
    that they do not compile it at once."""

    def __init__(self, n: int, tp: int = 1, device="cuda", backend=None):
        dev = setup(device)
        if n < 1 or tp < 1 or n % tp:
            raise ValueError(f"{n} ranks do not split into rows of tp={tp}")
        self.n, self.tp, self.dp = int(n), int(tp), int(n) // int(tp)
        self.device = dev
        self.backend = resolve_backend(dev, backend, n)
        if dev.type == "cuda":
            from ..ops import _build
            _build.build()
        self.results, self.launches, self.log = None, {}, None
        self._tasks = 0
        self._procs, self._conns = [], []
        self._dir = tempfile.mkdtemp(prefix="feu-ranks-")
        t0 = time.time()
        ctx = multiprocessing.get_context("spawn")
        try:
            for r in range(n):
                parent, child = ctx.Pipe()
                p = ctx.Process(target=_rank_main, daemon=True, args=(
                    r, n, tp, str(dev), self.backend,
                    os.path.join(self._dir, "store"), child))
                p.start()
                child.close()
                self._procs.append(p)
                self._conns.append(parent)
            self._gather()
        except BaseException:
            self.close()
            raise
        self.spawn_s = time.time() - t0

    def _gather(self):
        """Every rank's reply to the last message; raises (after closing
        the group) on a rank's error or death."""
        replies = [None] * self.n
        while any(r is None for r in replies):
            for r, (p, c) in enumerate(zip(self._procs, self._conns)):
                if replies[r] is not None:
                    continue
                if c.poll(0.05):
                    msg = pickle.loads(c.recv_bytes())
                    if not msg["ok"]:
                        self.close()
                        raise RuntimeError(f"rank {r} of {self.n} raised:\n"
                                           f"{msg['error']}")
                    replies[r] = msg
                elif not p.is_alive():
                    code = p.exitcode
                    self.close()
                    raise RuntimeError(f"rank {r} of {self.n} died (exit "
                                       f"code {code})")
        return replies

    def run(self, fn, *args, **kwargs):
        if not self._procs:
            raise RuntimeError("this rank group is closed")
        # the task goes through a file that every rank reads at once: a
        # pipe would hand a large payload to one rank after the other
        self._tasks += 1
        path = os.path.join(self._dir, f"task-{self._tasks}.pkl")
        with open(path, "wb") as f:
            pickle.dump((fn, args, kwargs), f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        for c in self._conns:
            c.send_bytes(pickle.dumps(path))
        try:
            replies = self._gather()
        finally:
            if os.path.exists(path):
                os.unlink(path)
        self.results = [m["result"] for m in replies]
        for k in replies[0]["launches"]:
            self.launches[k] = (self.launches.get(k, 0)
                                + sum(m["launches"][k] for m in replies))
        return self.results[0]

    def close(self):
        """Stop the ranks (each leaves its process group) and remove the
        rendezvous directory; a rank that does not stop is terminated."""
        for c in self._conns:
            try:
                c.send_bytes(pickle.dumps(None))
            except (OSError, ValueError):
                pass
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        for c in self._conns:
            c.close()
        self._procs, self._conns = [], []
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __repr__(self):
        return (f"RankGroup(n={self.n}, tp={self.tp}, device={self.device}, "
                f"backend={self.backend!r})")


def loaded_modules(ctx):
    """SPMD function: the names of the modules loaded in this rank."""
    return sorted(sys.modules)


# ---------------------------------------------------------------------------
# the round-1 demonstration: Jacobi CG on A(mu) = K + mu R, cells split
# ---------------------------------------------------------------------------

class ShardedMuSweep:
    """The sharded mu sweep of the JAX package's first round: A(mu) = D K +
    mu R on the P2 space (no dof permutation, no padding), K's and R's
    elements split over "cells", the mu batch over "sweep", one
    all-reduce per operator apply, Jacobi CG.  Built inside a rank."""

    def __init__(self, device_mesh, sys, rtol=1e-12, maxiter=2000):
        from .sharded_solve import _mesh_layout, _split_block
        self.layout = _mesh_layout(device_mesh)
        self.sys = sys
        self.rtol, self.maxiter = rtol, maxiter
        lay = self.layout
        self.K = _split_block(sys["K"], lay, sys["ndofs"])
        self.R = _split_block(sys["R"], lay, sys["ndofs"])
        self.free = torch.as_tensor(sys["free"], device=lay.device)
        self.g = torch.as_tensor(sys["bc_values"], device=lay.device)
        self.diagK = torch.as_tensor(sys["diagK"], device=lay.device)
        self.diagR = torch.as_tensor(sys["diagR"], device=lay.device)

    def solve(self, mu_values):
        """X (B, ndofs) f64 numpy for every mu, on every rank; the batch is
        padded to a multiple of the sweep ranks with its last value."""
        from ..solvers.batched import batched_cg
        from .sharded_solve import _gather_columns
        lay = self.layout
        mu = np.asarray(mu_values, dtype=np.float64)
        B = len(mu)
        Bp = -(-B // lay.dp) * lay.dp
        mu_p = np.pad(mu, (0, Bp - B), mode="edge")
        cols = lay.columns(Bp)
        mu_l = torch.as_tensor(mu_p[cols], device=lay.device)
        free = self.free[:, None]

        def A_raw(X):
            Y = self.K.apply_batched(X)
            Y = self.R.apply_batched(X, coef=mu_l, out=Y)
            return all_reduce_sum(Y, lay.cells)

        def A_op(X):
            return torch.where(free, A_raw(torch.where(free, X, 0.0)), X)

        G = self.g[:, None].expand(-1, mu_l.numel()).contiguous()
        rhs = torch.where(free, -A_raw(G), G)
        diag = self.diagK[:, None] + mu_l * self.diagR[:, None]
        dinv = torch.where(free & (diag.abs() > 0),
                           1.0 / torch.where(diag != 0, diag, 1.0), 1.0)
        res = batched_cg(A_op, rhs, M=lambda R: dinv * R, rtol=self.rtol,
                         maxiter=self.maxiter)
        return _gather_columns(res.X, cols, Bp, lay)[:, :B].t().cpu().numpy()


def build_sharded_mu_sweep(mesh_data, device_mesh, D=1.0, element="P2",
                           rtol=1e-12, maxiter=2000) -> ShardedMuSweep:
    """The round-1 sweep of ``mesh_data`` on ``device_mesh``: its blocks
    assembled on the host (every rank the same), then split."""
    from ..fem.assembly import make_bc, robin_facet_block, stiffness_block
    from ..fem.space import FunctionSpace
    from ..meshing.mesh_data import MARKERS
    from .sweep import _Block
    space = FunctionSpace(mesh_data, element)
    n = space.ndofs
    K_e, K_dofs = stiffness_block(space, "cpu")
    bottom = mesh_data.bc_marker == MARKERS["bottom"]
    R_e, R_dofs = robin_facet_block(space, bottom, "cpu")
    K = _Block.build(K_e * D, K_dofs, n)
    R = _Block.build(R_e, R_dofs, n)
    bc = make_bc(space, [(MARKERS["left"], 1.0), (MARKERS["right"], 0.0)])
    sys = {"K": K, "R": R, "ndofs": n, "free": bc.free,
           "bc_values": bc.values, "diagK": K.diagonal(),
           "diagR": R.diagonal()}
    return ShardedMuSweep(device_mesh, sys, rtol=rtol, maxiter=maxiter)


def _mu_sweep_task(ctx, mesh_data, mu_values, D, element, rtol, maxiter):
    sh = build_sharded_mu_sweep(mesh_data, ctx.mesh, D=D, element=element,
                                rtol=rtol, maxiter=maxiter)
    X = sh.solve(mu_values)
    return X if ctx.rank == 0 else None


def solve_mu_sweep_sharded(group: RankGroup, mesh_data, mu_values, D=1.0,
                           element="P2", rtol=1e-12, maxiter=2000):
    """The parent's round-1 sweep: X (B, ndofs) f64 numpy of every mu
    value, solved by ``ShardedMuSweep`` on the ranks of ``group``."""
    return group.run(_mu_sweep_task, mesh_data, np.asarray(mu_values),
                     D, element, rtol, maxiter)
