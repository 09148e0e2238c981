"""Batched (multi right-hand-side) Krylov solvers in the batch-minor
``(n, B)`` layout, in one dtype (counterpart of ``solvers/batched.py``).

The port's one Krylov core.  ``cg_step`` and ``bicgstab_step`` advance all
B columns by one masked iteration; a column outside its ``active`` mask is
frozen (its step lengths are zero, its direction is kept), so the iterates
of a converged column no longer move and every column's result is what a
solve of that column alone would give.  The step bodies are the JAX
package's, term for term, with its breakdown guards.  ``krylov_loop``
runs a step until no column is active or ``maxiter`` is reached.  One
step and one loop serve every transport solve of the port:

* ``parallel.sweep.solve_sweep``'s mixed passes: the f32 inner CG and
  BiCGStab of the f64 defect correction, through ``krylov_loop``;
* its f64 and f32 solves and Stokes' inner A-solves (``solvers.stokes``),
  through ``batched_cg`` / ``batched_bicgstab``, which run in the dtype of
  the right-hand side;
* the sharded chunks (``parallel.sharded_solve``): ``chunk_iters`` calls
  of the step with ``active`` taken on the device, no host read between.

The JAX package splits the loop into fixed-size compiled chunks with an
escalating schedule, a workaround for its runtime's cap on the length of a
device program, and so counts a column's iterations in whole chunks.  Here
the loop tests convergence on the host once per iteration (one device sync
each) and stops when no column is active; ``iters`` counts the iterations
each column was active for, which is what the JAX loop gives with chunks
of one iteration.  The host reads go through ``utils.profiling.host_read``
(counted in ``host_syncs``) and each iteration counts in ``krylov_steps``.

``KrylovGraph`` is ``krylov_loop``'s graphed twin, which only the mixed
passes of ``parallel.sweep`` take, and only on the card: one CUDA graph of
the step and its bookkeeping, captured once per solve and replayed at
every later step, so that a step costs the host one replay and one read
instead of the launches of its 120-270 kernels.  The other drivers stay
eager: the f64 and f32 solves, Stokes' inner solves (tens of one-column
steps a solve), the sharded operators (a gloo all-reduce, which a graph
cannot hold) and the sharded chunks.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..utils import profiling
from ..utils.profiling import host_read, span

__all__ = ["batched_cg", "batched_bicgstab", "BatchedResult", "CGState",
           "BiCGStabState", "cg_state", "bicgstab_state", "cg_step",
           "bicgstab_step", "krylov_loop", "KrylovGraph", "LaunchCounts"]


class BatchedResult(NamedTuple):
    X: torch.Tensor          # (n, B)
    iters: np.ndarray        # (B,) iterations each column was active for
    resnorm: np.ndarray      # (B,) recurrence residual norms at the end
    converged: np.ndarray    # (B,) bool


class CGState(NamedTuple):
    X: torch.Tensor          # (n, B) iterate
    R: torch.Tensor          # (n, B) recurrence residual
    Z: torch.Tensor          # M(R)
    P: torch.Tensor          # search direction
    rz: torch.Tensor         # (B,) sum(R * Z)


class BiCGStabState(NamedTuple):
    X: torch.Tensor          # (n, B) iterate
    R: torch.Tensor          # (n, B) recurrence residual
    Rhat: torch.Tensor       # the shadow residual: R at the start
    P: torch.Tensor
    V: torch.Tensor          # A(M(P))
    rho: torch.Tensor        # (B,)
    alpha: torch.Tensor      # (B,)
    omega: torch.Tensor      # (B,)


def _colnorm(R):
    return torch.sqrt(torch.sum(R * R, dim=0))


def _identity(X):
    return X


def cg_state(M, X, R) -> CGState:
    """The CG state at iterate X with residual R."""
    Z = M(R)
    return CGState(X=X, R=R, Z=Z, P=Z, rz=torch.sum(R * Z, dim=0))


def bicgstab_state(M, X, R) -> BiCGStabState:
    """The BiCGStab state at iterate X with residual R (M is not used:
    the signature is ``cg_state``'s, so a driver takes either method)."""
    one = torch.ones(R.shape[1], dtype=R.dtype, device=R.device)
    return BiCGStabState(X=X, R=R, Rhat=R, P=torch.zeros_like(R),
                         V=torch.zeros_like(R), rho=one, alpha=one,
                         omega=one)


def cg_step(A: Callable, M: Callable, s: CGState, active) -> CGState:
    """One preconditioned CG iteration of the ``active`` (B,) columns."""
    X, R, Z, P, rz = s
    AP = A(P)
    pAp = torch.sum(P * AP, dim=0)
    alpha = torch.where(active & (pAp != 0),
                        rz / torch.where(pAp != 0, pAp, 1.0), 0.0)
    X = X + alpha * P
    R = R - alpha * AP
    Z = M(R)
    rz_new = torch.sum(R * Z, dim=0)
    beta = torch.where(active & (rz != 0),
                       rz_new / torch.where(rz != 0, rz, 1.0), 0.0)
    P = torch.where(active, Z + beta * P, P)
    return CGState(X=X, R=R, Z=Z, P=P, rz=rz_new)


def bicgstab_step(A: Callable, M: Callable, s: BiCGStabState,
                  active) -> BiCGStabState:
    """One right-preconditioned BiCGStab iteration of the ``active`` (B,)
    columns."""
    X, R, Rhat, P, V, rho, alpha, omega = s
    rho_new = torch.sum(Rhat * R, dim=0)
    beta = torch.where(
        active,
        (rho_new / torch.where(rho != 0, rho, 1.0))
        * (alpha / torch.where(omega != 0, omega, 1.0)), 0.0)
    P = torch.where(active, R + beta * (P - omega * V), P)
    Phat = M(P)
    V = A(Phat)
    denom = torch.sum(Rhat * V, dim=0)
    alpha = torch.where(active & (denom != 0),
                        rho_new / torch.where(denom != 0, denom, 1.0), 0.0)
    S = R - alpha * V
    Shat = M(S)
    T = A(Shat)
    tt = torch.sum(T * T, dim=0)
    omega = torch.where(active & (tt != 0),
                        torch.sum(T * S, dim=0)
                        / torch.where(tt != 0, tt, 1.0), 0.0)
    X = X + alpha * Phat + omega * Shat
    R = torch.where(active, S - omega * T, R)
    return BiCGStabState(X=X, R=R, Rhat=Rhat, P=P, V=V, rho=rho_new,
                         alpha=alpha, omega=omega)


def krylov_loop(step: Callable, A: Callable, M: Callable, state, tol,
                maxiter: int):
    """``step`` (``cg_step`` or ``bicgstab_step``) from ``state`` while
    some column's residual norm is above its ``tol`` (B,), at most
    ``maxiter`` times; one host read of the active mask per iteration.

    Returns (the last state, (B,) int64 iterations each column was active
    for, on the device)."""
    cit = torch.zeros(state.R.shape[1], dtype=torch.int64,
                      device=state.R.device)
    for _ in range(maxiter):
        active = _colnorm(state.R) > tol
        if not bool(host_read(active.any())):
            break
        profiling.krylov_steps += 1
        state = step(A, M, state, active)
        cit = cit + active
    return state, cit


class LaunchCounts:
    """Counters that a CUDA graph's capture moves though nothing runs:
    integer attributes ``(owner, name)`` and ``collections.Counter``
    tallies.  Inside ``capture()`` they move as the calls made there move
    them; when it ends they are set back, and what they moved by is the
    graph's.  ``replayed()`` adds that once: a replay runs the captured
    kernels, so the counters count executions, as the eager loop's do."""

    def __init__(self, attrs, tallies=()):
        self.attrs, self.tallies = tuple(attrs), tuple(tallies)
        self.delta = ([0] * len(self.attrs), [Counter() for _ in tallies])

    def _read(self):
        return ([getattr(o, n) for o, n in self.attrs],
                [Counter(t) for t in self.tallies])

    @contextlib.contextmanager
    def capture(self):
        ints, tallies = self._read()
        try:
            yield
        finally:
            now, now_t = self._read()
            self.delta = ([b - a for a, b in zip(ints, now)],
                          [b - a for a, b in zip(tallies, now_t)])
            for (o, n), v in zip(self.attrs, ints):
                setattr(o, n, v)
            for t, v in zip(self.tallies, tallies):
                t.clear()
                t.update(v)

    def replayed(self):
        for (o, n), d in zip(self.attrs, self.delta[0]):
            if d:
                setattr(o, n, getattr(o, n) + d)
        for t, d in zip(self.tallies, self.delta[1]):
            t.update(d)


def _kernel_counts() -> LaunchCounts:
    """The hand kernels' launch counters (those ``parallel.sharding.
    kernel_launches`` reads, and the launches by band)."""
    from ..ops.banded import band_apply, launches_by_band, rect_band_apply
    from ..ops.elemspmv import ElementKernel
    return LaunchCounts(
        [(band_apply, n) for n in ("launches", "launches_packed",
                                   "launches_bf16")]
        + [(rect_band_apply, n) for n in ("launches", "launches_bf16",
                                          "launches_bf16_band")]
        + [(ElementKernel, n) for n in ("launches", "launches_out",
                                        "launches_sample", "launches_bf16")],
        [launches_by_band])


# per device: the side stream the captures run on (as torch.cuda.graph
# keeps one) and the last graph captured, which holds the capture pool
_CAPTURE = {}


def _cuda_graph(body, device):
    """A ``torch.cuda.CUDAGraph`` of ``body()``, captured on the device's
    side stream, which waits for the current one (the current stream waits
    for it in turn); the capture runs the host side of ``body`` and no
    kernel.

    Every capture allocates its temporaries from the memory pool of the
    capture before it, and the last graph is kept (never replayed again)
    to hold that pool.  A pool of its own per graph is handed back when
    the graph dies but freed only where an allocation fails: the memory
    reserved then grows by one step's temporaries a solve (2 MiB a solve
    of the h = 0.15 test system on the H100), where the shared pool stays
    at one capture's.  Sharing is safe while replays run one at a time on
    one stream: everything a graph allocates is dead when its replay ends
    (the state lives in the ``KrylovGraph``'s buffers, allocated outside
    the pool)."""
    side, last = _CAPTURE.get(device.index) or (torch.cuda.Stream(device),
                                                None)
    main = torch.cuda.current_stream(device)
    side.wait_stream(main)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin(pool=None if last is None else last.pool(),
                            capture_error_mode="thread_local")
        try:
            body()
        finally:
            graph.capture_end()
    main.wait_stream(side)
    _CAPTURE[device.index] = (side, graph)
    return graph


class KrylovGraph:
    """``krylov_loop`` of one ``step``, A and M, its steps replayed as one
    CUDA graph: made once per solve and handed to each loop of the solve
    (``loop``), on the card.

    The solve's first step runs eagerly and binds what the step's kernels
    bind at their first call (the kernel library, kernel attributes).  The
    next is captured with its bookkeeping into one graph over static
    buffers: the step written back into the state's buffers, ``cit +=
    active``, the next ``active`` (``|R_b| > tol_b``) and whether any
    column is.  Every later step of every loop of the solve replays it; a
    loop copies its start state, ``tol``, mask and counts into the buffers
    first.  Per step the host replays, counts the step and reads the flag:
    the eager loop's arithmetic in its order and its reads, so the
    iterations, the host syncs and every bit of the state are the eager
    loop's.  A and M apply the same operators on the same tensors at every
    loop, and read nothing from the device on the host.

    The kernel wrappers' launch counters move at the capture, where no
    kernel runs: its increments are set back and added once per replay
    (``LaunchCounts``).  Counted in ``profiling.krylov_graph_captures``
    (one per graph) and ``krylov_graph_steps`` (steps replayed); the
    capture is a ``solve.capture`` span.  Dropping the object frees its
    buffers; its graph, never replayed again, holds the capture pool until
    the next capture takes it over (``_cuda_graph``)."""

    def __init__(self, step: Callable, A: Callable, M: Callable):
        self.step, self.A, self.M = step, A, M
        self._warm = False
        self._graph = None
        self._counts = _kernel_counts()

    def loop(self, state, tol, maxiter: int):
        """``krylov_loop(step, A, M, state, tol, maxiter)``, bit for bit.
        Where a step was replayed, the state and iterations returned are
        this object's buffers, which the next ``loop`` overwrites."""
        cit = torch.zeros(state.R.shape[1], dtype=torch.int64,
                          device=state.R.device)
        active = _colnorm(state.R) > tol
        n = 0
        if not self._warm:
            if maxiter < 1 or not bool(host_read(active.any())):
                return state, cit
            profiling.krylov_steps += 1
            state = self.step(self.A, self.M, state, active)
            cit = cit + active
            active = _colnorm(state.R) > tol
            self._warm = True
            n = 1
        if n >= maxiter or not bool(host_read(active.any())):
            return state, cit
        self._load(state, tol, active, cit)
        while True:
            self._graph.replay()
            self._counts.replayed()
            profiling.krylov_steps += 1
            profiling.krylov_graph_steps += 1
            n += 1
            if n >= maxiter or not bool(host_read(self._flag)):
                return self._state, self._cit

    def _load(self, state, tol, active, cit):
        if self._graph is None:
            self._state = type(state)(*(t.clone() for t in state))
            self._tol, self._active = tol.clone(), active.clone()
            self._cit = cit.clone()
            self._flag = torch.zeros((), dtype=torch.bool,
                                     device=tol.device)
            with span("solve.capture"), self._counts.capture():
                self._graph = _cuda_graph(self._body, tol.device)
            profiling.krylov_graph_captures += 1
            return
        for buf, t in zip(self._state, state):
            buf.copy_(t)
        self._tol.copy_(tol)
        self._active.copy_(active)
        self._cit.copy_(cit)

    def _body(self):
        """One step and its bookkeeping, in place in the buffers."""
        new = self.step(self.A, self.M, self._state, self._active)
        for buf, t in zip(self._state, new):
            if t is not buf:
                buf.copy_(t)
        self._cit += self._active
        self._active.copy_(_colnorm(self._state.R) > self._tol)
        self._flag.copy_(self._active.any())


def _solve(step, start, A, B_rhs, M, X0, rtol, atol, maxiter):
    M = _identity if M is None else M
    X = torch.zeros_like(B_rhs) if X0 is None else X0
    tol = torch.clamp(rtol * _colnorm(B_rhs), min=atol)
    state, cit = krylov_loop(step, A, M, start(M, X, B_rhs - A(X)), tol,
                             maxiter)
    rn = _colnorm(state.R)
    return BatchedResult(X=state.X, iters=host_read(cit),
                         resnorm=host_read(rn),
                         converged=host_read(rn <= tol))


def batched_cg(A: Callable, B_rhs, M: Optional[Callable] = None, X0=None,
               rtol=1e-12, atol=0.0, maxiter=20000) -> BatchedResult:
    """Preconditioned CG on (n, B) right-hand sides; A and M map (n, B) to
    (n, B) in B_rhs's dtype (M symmetric positive definite; None: the
    identity)."""
    return _solve(cg_step, cg_state, A, B_rhs, M, X0, rtol, atol, maxiter)


def batched_bicgstab(A: Callable, B_rhs, M: Optional[Callable] = None,
                     X0=None, rtol=1e-12, atol=0.0,
                     maxiter=20000) -> BatchedResult:
    """Right-preconditioned BiCGStab on (n, B) right-hand sides; A and M as
    in :func:`batched_cg` (M need not be symmetric)."""
    return _solve(bicgstab_step, bicgstab_state, A, B_rhs, M, X0, rtol,
                  atol, maxiter)
