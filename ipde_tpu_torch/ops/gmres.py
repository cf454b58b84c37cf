"""Right-preconditioned restarted GMRES in float64, for one system or for B
independent systems in lockstep.

Replaces the reference's scipy-based ``right_gmres``
(reference: personal_utilities.scipy_gmres.right_gmres, used by
ipde/annular/modified_helmholtz.py:198).  As in ipde_tpu.ops.gmres, the
whole iteration stays on the vectors' device: the Krylov basis, the
Hessenberg columns, the Givens rotations, the residual estimates and the
back substitution.  The Krylov buffers have fixed sizes and the column
index j is a device tensor, so one Arnoldi step has the same shapes for
every j: CGS2 (classical Gram-Schmidt with reorthogonalization) projects
against all m + 1 basis columns, the unused ones being zero.  The rotations
so far are kept as one (m + 1, m + 1) orthogonal matrix per system, so a
new Hessenberg column is rotated by one small product.

The host drives the loop.  It reads one small status vector (a flag, and
at a cycle end the iteration counts and residuals) by a non-blocking copy
to pinned memory and an event: once per chunk of ``CHUNK`` Arnoldi steps
and once per cycle end, never once per iteration.  A chunk's steps after a
system has converged feed it zero rows and leave its state as it is.

The returned residual is the true relative residual ||b - A x|| / ||b|| of
the returned x: each restart cycle ends by computing it, and the iteration
goes on while it is above tol, even where the Arnoldi estimate had already
dropped below.

The three phases of a solve (start, chunk, cycle end) are what
``utils/planify.py`` captures as CUDA graphs: inside a planified call the
loop registers itself with the active recorder (``planify.recording``)
and its host loop replays the three graphs.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch

from ipde_tpu_torch.utils.planify import recording
from ipde_tpu_torch.utils.profiling import spanned

# Arnoldi steps between two host reads.  A read costs a round trip to the
# host; a step past convergence costs a matvec and a preconditioner on zero
# rows.  Chosen from H100 timings (PERF.md, "GMRES chunk").
CHUNK = 2


class GmresResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor   # 0-d int64 on x's device: inner iterations
    residual: torch.Tensor     # 0-d float64: true relative residual of x
    loop: "LockstepGmres"      # its host reads (``on_host``)

    def on_host(self, fn: Callable):
        """Call ``fn(iterations, residual)`` with the host values, once
        they are read: now on an eager call, after every replay inside a
        planified one."""
        self.loop.on_host(lambda its, rs: fn(its[0], rs[0]))


class BatchedGmresResult(NamedTuple):
    x: torch.Tensor            # (B, N)
    iterations: torch.Tensor   # (B,) int64 on x's device
    residual: torch.Tensor     # (B,) float64: true relative residual of x[b]
    loop: "LockstepGmres"

    def on_host(self, fn: Callable):
        """Call ``fn(iterations, residual)`` (lists of B ints and floats)
        once they are read; see ``GmresResult.on_host``."""
        self.loop.on_host(fn)


def gmres(matvec: Callable, b: torch.Tensor,
          precond: Optional[Callable] = None, tol: float = 1e-14,
          maxiter: int = 100, restart: int = 30) -> GmresResult:
    """Solve A x = b with right-preconditioned GMRES(restart).

    matvec: x -> A x on flat vectors.  precond: r -> M^{-1} r.  At most
    ceil(maxiter / restart) restart cycles run from x = 0; convergence is
    declared when ||b - A x|| <= tol * ||b||."""
    pc = (lambda v: v) if precond is None else \
        (lambda v: precond(v[0])[None])  # noqa: E731
    res = batched_gmres(lambda v: matvec(v[0])[None], b[None], pc, tol=tol,
                        maxiter=maxiter, restart=restart)
    return GmresResult(res.x[0], res.iterations[0], res.residual[0], res.loop)


def batched_gmres(matvec: Callable, b: torch.Tensor,
                  precond: Optional[Callable] = None, tol: float = 1e-14,
                  maxiter: int = 100, restart: int = 30) -> BatchedGmresResult:
    """Solve the B independent systems A_i x_i = b_i (b: (B, N)) with
    right-preconditioned GMRES(restart) in lockstep.

    matvec and precond map a (B, N) stack to a (B, N) stack, row i through
    A_i and M_i^{-1}; both must be linear (a zero row gives a zero row).
    Each system follows the iteration ``gmres`` runs on it alone: the
    restart cycles are shared, a system that meets tol inside a cycle is fed
    zero rows until the cycle ends, and a system whose true residual has met
    tol at the end of a cycle is frozen."""
    loop = LockstepGmres(matvec, precond, b, tol, maxiter, restart)
    loop.run()
    return BatchedGmresResult(loop.x, loop.iters, loop.resid, loop)


class LockstepGmres:
    """The state and the three phases of one lockstep GMRES solve.

    ``start`` zeroes x and opens the first cycle; ``chunk`` runs CHUNK
    Arnoldi steps; ``end`` closes a cycle (back substitution, x update,
    true residual) and opens the next.  Each writes only into the state
    tensors allocated here, and ``status`` = [flag, iterations (B),
    residuals (B)] is what the host reads: after ``chunk`` the flag says
    whether a system is still live in the cycle, after ``end`` whether one
    still runs.  ``LockstepGmres.host_reads`` counts the reads of every
    solve."""

    host_reads = 0

    def __init__(self, matvec, precond, b, tol, maxiter, restart):
        self.matvec = matvec
        self.precond = precond if precond is not None else (lambda v: v)
        self.tol = float(tol)
        self.m = m = int(restart)
        self.chunk_len = CHUNK
        self.max_outer = (int(maxiter) + m - 1) // m
        self.b = b
        B, N = b.shape
        self.B = B
        dev = b.device
        f64 = dict(dtype=b.dtype, device=dev)
        self.x = torch.zeros((B, N), **f64)
        self.r = torch.zeros((B, N), **f64)
        self.V = torch.zeros((B, m + 1, N), **f64)
        self.H = torch.zeros((B, m + 1, m), **f64)
        self.Q = torch.zeros((B, m + 1, m + 1), **f64)   # rotations so far
        self.g = torch.zeros((B, m + 1), **f64)
        self.bnorm = torch.zeros(B, **f64)
        self.tol_b = torch.zeros(B, **f64)      # tol ||b|| (tol where b = 0)
        self.rnorm = torch.zeros(B, **f64)
        self.resid = torch.zeros(B, **f64)
        self.run_ = torch.zeros(B, dtype=torch.bool, device=dev)
        self.live = torch.zeros(B, dtype=torch.bool, device=dev)
        self.steps = torch.zeros(B, dtype=torch.int64, device=dev)
        self.iters = torch.zeros(B, dtype=torch.int64, device=dev)
        self.j = torch.zeros(1, dtype=torch.int64, device=dev)
        self.status = torch.zeros(1 + 2 * B, **f64)
        # per column index j (the chunk's steps may run past m - 1): the
        # masks of rows j and j + 1 and of Hessenberg column j, and whether
        # j < m; the pair (j, j + 1) of rows a step reads, clamped
        rows = m + self.chunk_len
        j = torch.arange(rows, device=dev)[:, None]
        r1 = torch.arange(m + 1, device=dev)[None, :]
        self._sel = torch.cat([r1 == j, r1 == j + 1,
                               r1[:, :m] == j, j < m], dim=1)
        self._pair = torch.cat([j.clamp(max=m - 1), (j + 1).clamp(max=m)],
                               dim=1)
        self._cols = torch.arange(m, device=dev)
        self._eye = torch.eye(m + 1, **f64)
        self._flip = torch.arange(2, **f64)[None] * 2 - 1     # [[-1, 1]]
        self._host = None           # (iterations, residuals) of the last read
        self._callbacks = []
        self._pinned = self._event = None   # made at the first read

    # -- the three phases (device work only) ---------------------------------
    def start(self):
        torch.linalg.vector_norm(self.b, dim=1, out=self.bnorm)
        self.tol_b.copy_(self.tol * torch.where(self.bnorm > 0, self.bnorm,
                                                1.0))
        self.x.zero_()
        self.r.copy_(self.b)
        self.rnorm.copy_(self.bnorm)
        self.iters.zero_()
        self._open_cycle()

    def _open_cycle(self):
        """A system runs this cycle unless its true residual meets tol; a
        system outside the cycle gets a zero basis (r / inf)."""
        run = ~(self.rnorm <= self.tol_b)
        self.run_.copy_(run)
        self.live.copy_(run)
        self.V.zero_()
        self.V[:, 0] = self.r / torch.where(run, self.rnorm,
                                            torch.inf)[:, None]
        self.H.zero_()
        self.Q.copy_(self._eye.expand_as(self.Q))
        self.g.zero_()
        self.g[:, 0] = torch.where(run, self.rnorm, 0.0)
        self.steps.zero_()
        self.j.zero_()

    def step(self):
        """One Arnoldi step at column j for every live system.  The others
        are fed zero rows: their new column is zero, so their rotation is
        the identity and their H, Q and g stay as they are (the entries of
        g past their last step are never read)."""
        m = self.m
        sel = self._sel.index_select(0, self.j)[0]
        at_j, at_j1 = sel[:m + 1], sel[m + 1:2 * m + 2]
        col_j, valid = sel[2 * m + 2:3 * m + 2], sel[3 * m + 2:]
        pair = self._pair.index_select(0, self.j)[0]        # (j, j + 1)
        act = self.live & valid
        V = self.V
        vj = V.index_select(1, pair[:1])[:, 0]
        w = self.matvec(self.precond(vj * act[:, None]))
        # CGS2 against all m + 1 columns (the unused ones are zero)
        h1 = torch.bmm(V, w[:, :, None])[:, :, 0]
        w = w - torch.bmm(h1[:, None], V)[:, 0]
        h2 = torch.bmm(V, w[:, :, None])[:, :, 0]
        w = w - torch.bmm(h2[:, None], V)[:, 0]
        wnorm = torch.linalg.vector_norm(w, dim=1)
        h = torch.where(at_j1, wnorm[:, None], h1 + h2)
        V.index_copy_(1, pair[1:], (w / torch.where(wnorm > 0, wnorm, 1.0)
                                    [:, None])[:, None])
        # rotate the new column by the rotations so far; the new rotation
        # (c, s) annihilates its entry j + 1
        h = torch.bmm(self.Q, h[:, :, None])[:, :, 0]
        hp = h.index_select(1, pair)                       # (h_j, h_j+1)
        denom = torch.hypot(hp[:, 0], hp[:, 1])
        pos = denom > 0
        cs = torch.where(pos[:, None],
                         hp / torch.where(pos, denom, 1.0)[:, None],
                         self._eye[0, :2])
        h = torch.where(at_j, (cs * hp).sum(1, keepdim=True),
                        torch.where(at_j1, 0.0, h))
        self.H.copy_(torch.where(col_j & act[:, None, None], h[:, :, None],
                                 self.H))
        # rows j, j + 1 of Q and g times [[c, s], [-s, c]]
        rot = torch.stack([cs, cs.flip(1) * self._flip], dim=1)
        self.Q.index_copy_(1, pair, torch.bmm(rot, self.Q.index_select(
            1, pair)))
        g = self.g.index_select(1, pair[:1]) * rot[:, :, 0]
        self.g.index_copy_(1, pair, g)
        self.steps.add_(act)
        self.live.logical_and_(~(g[:, 1].abs() <= self.tol_b))
        self.j.add_(1)

    def chunk(self):
        for _ in range(self.chunk_len):
            self.step()
        self.status[0] = (self.live.any() & (self.j[0] < self.m)).to(
            self.status.dtype)

    def end(self):
        """Back substitution on the systems that ran (H[:k, :k] y = g[:k],
        k = steps; the diagonal padded with ones beyond k), the x update,
        the true residual; then the next cycle opens."""
        m = self.m
        beyond = self._cols[None, :] >= self.steps[:, None]      # (B, m)
        Hs = self.H[:, :m, :] + torch.diag_embed(beyond.to(self.H.dtype))
        gs = torch.where(beyond, 0.0, self.g[:, :m])
        y = torch.linalg.solve_triangular(Hs, gs[:, :, None], upper=True)
        dx = self.precond(torch.bmm(y[:, :, 0][:, None],
                                    self.V[:, :m])[:, 0])
        self.x.add_(dx)
        self.r.copy_(self.b - self.matvec(self.x))
        self.rnorm.copy_(torch.where(
            self.run_, torch.linalg.vector_norm(self.r, dim=1), self.rnorm))
        self.iters.add_(self.steps)
        self.resid.copy_(self.rnorm / torch.where(self.bnorm > 0,
                                                  self.bnorm, 1.0))
        self._open_cycle()
        B = self.B
        self.status[0] = self.run_.any().to(self.status.dtype)
        self.status[1:1 + B] = self.iters.to(self.status.dtype)
        self.status[1 + B:] = self.resid

    # -- the host loop -------------------------------------------------------
    @spanned("gmres.read")
    def read(self) -> List[float]:
        """The status vector on the host: by a non-blocking copy to pinned
        memory and an event on a card (no stream synchronize)."""
        LockstepGmres.host_reads += 1
        if self.b.device.type != "cuda":
            return self.status.tolist()
        if self._pinned is None:
            self._pinned = torch.empty(self.status.shape,
                                       dtype=self.status.dtype,
                                       pin_memory=True)
            self._event = torch.cuda.Event()
        self._pinned.copy_(self.status, non_blocking=True)
        self._event.record()
        self._event.synchronize()
        return self._pinned.tolist()

    def drive(self, start, chunk, end):
        """Run the solve with the phase callables given (the eager phases,
        or the replays of their graphs) and read the host values."""
        start()
        st = None
        for _ in range(self.max_outer):
            while True:
                chunk()
                if not self.read()[0]:
                    break
            end()
            st = self.read()
            if not st[0]:
                break
        if st is None:      # maxiter 0: no cycle ran
            end()
            st = self.read()
        B = self.B
        self._host = ([int(v) for v in st[1:1 + B]],
                      [float(v) for v in st[1 + B:]])
        for fn in self._callbacks:
            fn(*self._host)

    def run(self):
        """Eagerly, or registered with the active planify recorder (which
        captures the phases and drives them at every replay)."""
        rec = recording()
        if rec is not None:
            rec.add_loop(self)
        else:
            self.drive(self.start, self.chunk, self.end)

    def on_host(self, fn: Callable):
        """``fn(iterations, residuals)`` with the host lists: now if they
        have been read, else after every drive (replay)."""
        self._callbacks.append(fn)
        if self._host is not None:
            fn(*self._host)
