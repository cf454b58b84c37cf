"""The port's multi-device layer (``ipde_tpu_torch/parallel/sharded.py``,
``use_mesh``, the boundary-axis split of the lockstep GMRES,
``dryrun_multichip``) against ``ipde_tpu``'s and against its own unsharded
path, on meshes of CPU shards (``[cpu] * 4``: a device may repeat).

- The four sharded applies on tests/test_sharded.py's cloud (S = 37,
  T = 101): the Laplace target- and source-sharded and the Stokeslet applies
  against ``ipde_tpu``'s sharded applies on a 4-device JAX mesh (conftest
  gives 8 virtual CPU devices), the Yukawa one against ``ipde_tpu``'s
  unsharded apply (its ``shard_map`` compile alone takes ~35 s here;
  tests/test_sharded.py holds the two to each other at 1e-13); target-sharded
  within 1e-13, source-sharded within 1e-12, as tests/test_sharded.py.
  Ragged and empty shards against the port's unsharded apply.
- The boundary axis: ``batched_annular_solve`` and ``batched_stokes_solve``
  with B = 3 over 2 shards: iterations equal, x within 1e-14 of max |x|.
- Whole slices under ``use_mesh`` against the unsharded solve: the two-body
  Poisson problem of ``dryrun_multichip`` at nb = 64, M = 6 within 1e-12
  (tests/test_sharded.py:136) and within 1e-10 of ``ipde_tpu``'s unsharded
  solve on its dense grid backend (the BIE given the port's radial plans,
  see tests/test_torch_multi_body.py); one-boundary Poisson (both grid
  backends) within 5e-12 (tests/test_sharded.py:79); Yukawa k = 2 with
  ``NeumannBIE`` and Stokes within 1e-12.

Marker ``gpu``: the sharded applies and one ``use_mesh`` solve on the card,
the caller's current device kept across a launch (a leak shows only where
torch sees two cards or more), and meshes of the card and the CPU in turns
(the four applies, the boundary axis of both lockstep solves): every copy
to a shard's device and every gather on the lead, on one card."""

import numpy as np
import pytest
import torch

import _torch_testing as tt
from _torch_testing import SOLVE, as_np as _np
from _torch_testing import cards_or_skip as _cards
from _torch_testing import one_torch_thread  # noqa: F401
from ipde_tpu.ops import kernels as jk
from ipde_tpu.parallel import sharded as jsh
from ipde_tpu_torch.entry import build_problem, dryrun_multichip, frc, sol
from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu_torch.geometry.annular import AnnularGeometry, AnnularMetric
from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
from ipde_tpu_torch.geometry.curve import star
from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
from ipde_tpu_torch.ops import kernels as tk
from ipde_tpu_torch.ops import stokes_kernels as tsk
from ipde_tpu_torch.parallel import sharded as tsh
from ipde_tpu_torch.parallel.sharded import Mesh, make_mesh
from ipde_tpu_torch.solvers import annular_scalar as ann
from ipde_tpu_torch.solvers import annular_stokes as anns
from ipde_tpu_torch.solvers import scalar as tscalar
from ipde_tpu_torch.solvers import vector as tvector
from ipde_tpu_torch.solvers.bie import (DirichletBIE, NeumannBIE,
                                        StokesDirichletBIE)
from ipde_tpu_torch.solvers.scalar import (ModifiedHelmholtzSolver,
                                           PoissonSolver)
from ipde_tpu_torch.solvers.vector import StokesSolver

CPU4 = ["cpu"] * 4
K_MH = 3.0
APPLIES = ("laplace", "source_laplace", "mh", "stokes")


def _pts(S=37, T=101):
    """tests/test_sharded.py's cloud, with a second charge column."""
    rng = np.random.default_rng(7)
    th = np.linspace(0, 2 * np.pi, S, endpoint=False)
    q = rng.standard_normal(S)
    return (np.cos(th), np.sin(th), q, np.roll(q, 3),
            0.4 * rng.standard_normal(T), 0.4 * rng.standard_normal(T))


def _tuple(out):
    return tuple(map(_np, out if isinstance(out, tuple) else (out,)))


def _sharded(name, mesh, sx, sy, q, q2, tx, ty):
    """The port's sharded apply ``name``."""
    if name == "laplace":
        return tsh.sharded_laplace_slp_apply(mesh, sx, sy, q, tx, ty)
    if name == "source_laplace":
        return tsh.source_sharded_laplace_slp_apply(mesh, sx, sy, q, tx, ty)
    if name == "mh":
        return tsh.sharded_mh_slp_apply(mesh, sx, sy, q, tx, ty, K_MH)
    return tsh.sharded_stokes_slp_apply(mesh, sx, sy, q, q2, tx, ty)


def _unsharded(name, sx, sy, q, q2, tx, ty):
    """The port's one-device apply that ``name`` shards."""
    if name == "mh":
        return tk.mh_slp_apply(sx, sy, q, tx, ty, K_MH)
    if name == "stokes":
        return tsk.stokes_slp_apply(sx, sy, q, q2, tx, ty)
    return tk.laplace_slp_apply(sx, sy, q, tx, ty)


def _tol(name):
    return 1e-12 if name == "source_laplace" else 1e-13


@pytest.fixture(scope="module")
def jmesh():
    return jsh.make_mesh(4)


def _reference(name, jmesh, sx, sy, q, q2, tx, ty):
    """ipde_tpu's sharded apply ``name`` (its unsharded Yukawa apply)."""
    if name == "laplace":
        return jsh.sharded_laplace_slp_apply(jmesh, sx, sy, q, tx, ty)
    if name == "source_laplace":
        return jsh.source_sharded_laplace_slp_apply(jmesh, sx, sy, q, tx, ty)
    if name == "mh":
        return jk.mh_slp_apply(sx, sy, q, tx, ty, K_MH)
    return jsh.sharded_stokes_slp_apply(jmesh, sx, sy, q, q2, tx, ty)


@pytest.mark.parametrize("name", APPLIES)
def test_sharded_apply_matches_ipde_tpu(name, jmesh):
    pts = _pts()
    args = [torch.as_tensor(a) for a in pts]
    got = _tuple(_sharded(name, make_mesh(devices=CPU4), *args))
    want = _tuple(_reference(name, jmesh, *pts))
    one = _tuple(_unsharded(name, *args))
    assert len(got) == len(want) == len(one)
    for g, w, o in zip(got, want, one):
        assert g.shape == w.shape == (101,)
        assert np.abs(g - w).max() <= _tol(name)
        assert np.abs(g - o).max() <= _tol(name)


def _wrapper(name):
    """(module, attribute) of the one-device wrapper a shard calls."""
    if name == "mh":
        return tk, "mh_slp_apply"
    if name == "stokes":
        return tsk, "stokes_slp_apply"
    return tk, "laplace_slp_apply"


@pytest.mark.parametrize("T,S", [(3, 37), (0, 37), (101, 3)])
@pytest.mark.parametrize("name", APPLIES)
def test_sharded_apply_ragged_and_empty(name, T, S, monkeypatch):
    """Ragged and empty shards (nothing is padded): the port's unsharded
    apply within the tolerance, on the lead device, one wrapper call per
    non-empty shard (one call on the lead where the split axis is empty)."""
    args = [torch.as_tensor(a) for a in _pts(S=S, T=T)]
    want = _tuple(_unsharded(name, *args))
    module, attr = _wrapper(name)
    orig, calls = getattr(module, attr), []

    def spy(*a):
        calls.append(a)
        return orig(*a)

    monkeypatch.setattr(module, attr, spy)
    got = _sharded(name, make_mesh(devices=CPU4), *args)
    split = S if name == "source_laplace" else T
    assert len(calls) == max(1, min(split, 4))
    for g, w in zip(got if isinstance(got, tuple) else (got,), want):
        assert g.device == torch.device("cpu") and g.shape == (T,)
        assert np.abs(_np(g) - w).max(initial=0.0) <= _tol(name)


def test_make_mesh():
    m = make_mesh(devices=CPU4)
    assert (m.size, m.physical, m.lead) == (4, 1, torch.device("cpu"))
    assert make_mesh(2, devices=CPU4).size == 2
    with pytest.raises(RuntimeError):
        make_mesh(5, devices=CPU4)
    # never quietly stacks shards on fewer cards than asked for
    with pytest.raises(RuntimeError):
        make_mesh(torch.cuda.device_count() + 1)


# ---------------------------------------------------------------------------
# the boundary axis of the lockstep annular GMRES
# ---------------------------------------------------------------------------

def _annuli(n=64, M=8):
    """Three boundaries of one (n, M): (geometries, metrics, radial x, y)."""
    out = []
    for a, f in ((0.1, 3), (0.05, 5), (0.15, 4)):
        e = EmbeddedBoundary(star(n, a=a, f=f), True, M, 0.02)
        geom = AnnularGeometry(n, M, e.lb, e.ub, e.approximate_radius)
        out.append((geom, AnnularMetric(e.bdy.speed, e.bdy.curvature, geom),
                    e.radial_x, e.radial_y))
    return out


def _same_solve(got, want, tol=1e-14):
    """Iterations equal, solutions on one device within tol of max |x|."""
    (xs, st), (ws, wst) = got, want
    assert st["iterations"] == wst["iterations"]
    flat = lambda x: torch.cat([a.reshape(-1) for a in x]) \
        if isinstance(x, tuple) else x.reshape(-1)  # noqa: E731
    for x, w in zip(xs, ws):
        assert flat(x).device == flat(w).device
        assert float((flat(x) - flat(w)).abs().max()) \
            <= tol * float(flat(w).abs().max())


def test_batched_annular_solve_boundary_axis():
    annuli = _annuli()
    solvers = [ann.AnnularPoissonSolver(g, device="cpu") for g, *_ in annuli]
    metrics = [m for _, m, *_ in annuli]
    zero = torch.zeros(64, dtype=torch.float64)
    rhss = [s.build_rhs(torch.as_tensor(np.sin(3 * x) * np.cos(2 * y)),
                        zero, zero)
            for s, (_, _, x, y) in zip(solvers, annuli)]
    mesh = make_mesh(devices=["cpu", "cpu"])
    groups = ann.shard_boundary_axis(
        mesh, [s.make_ops(m) for s, m in zip(solvers, metrics)])
    assert [g[1] for g in groups] == [slice(0, 2), slice(2, 3)]
    _same_solve(ann.batched_annular_solve(solvers, metrics, rhss, mesh=mesh),
                ann.batched_annular_solve(solvers, metrics, rhss))


def test_boundary_groups_built_once():
    """The split of one list of bundles is kept on the mesh (a solver's
    every solve reuses it); another list splits anew."""
    annuli = _annuli()
    solvers = [ann.AnnularPoissonSolver(g, device="cpu") for g, *_ in annuli]
    ops = [s.make_ops(m) for s, (_, m, *_) in zip(solvers, annuli)]
    mesh = make_mesh(devices=["cpu", "cpu"])
    groups = ann.shard_boundary_axis(mesh, ops)
    assert ann.shard_boundary_axis(mesh, list(ops)) is groups
    assert ann.shard_boundary_axis(mesh, ops[:2]) is not groups
    assert [g[1] for g in ann.shard_boundary_axis(mesh, ops[:2])] == \
        [slice(0, 1), slice(1, 2)]


def test_one_shard_mesh_is_the_one_device_call(monkeypatch):
    """A one-shard mesh (what a solver without use_mesh runs on) is the
    one-device call: the wrapper gets the caller's tensors and its result
    comes back as it is, nothing cut, concatenated or copied."""
    args = [torch.as_tensor(a) for a in _pts()]
    args = args[:3] + args[4:]
    want = tk.laplace_slp_apply(*args)
    calls = []
    monkeypatch.setattr(tk, "laplace_slp_apply",
                        lambda *a: calls.append(a) or want)
    assert tsh.sharded_laplace_slp_apply(Mesh(["cpu"]), *args) is want
    assert len(calls) == 1 and all(g is a for g, a in zip(calls[0], args))


def test_batched_stokes_solve_boundary_axis():
    annuli = _annuli()
    solvers = [anns.AnnularStokesSolver(g, device="cpu") for g, *_ in annuli]
    metrics = [m for _, m, *_ in annuli]
    zero = torch.zeros(64, dtype=torch.float64)
    rhss = [s.build_rhs(torch.as_tensor(np.sin(3 * x) * np.cos(2 * y)),
                        torch.as_tensor(np.cos(x + y)), zero, zero, zero,
                        zero)
            for s, (_, _, x, y) in zip(solvers, annuli)]
    mesh = make_mesh(devices=["cpu", "cpu"])
    _same_solve(anns.batched_stokes_solve(solvers, metrics, rhss, mesh=mesh),
                anns.batched_stokes_solve(solvers, metrics, rhss))


# ---------------------------------------------------------------------------
# whole slices under use_mesh
# ---------------------------------------------------------------------------

def _fields(out):
    """Every tensor of a solve's output (EmbeddedFunctions or a tuple of
    them), grids and radials."""
    efs = out if isinstance(out, tuple) else (out,)
    return [t for ef in efs for t in (ef.grid, *ef.radials)]


def _gap(a, b):
    return max(float((x - y).abs().max()) for x, y in
               zip(_fields(a), _fields(b)))


@pytest.fixture(scope="module")
def two_body():
    """The two-body Poisson problem of dryrun_multichip at nb = 64, M = 6
    (__graft_entry__._build_problem's geometry) in both packages from one
    saved collection; ipde_tpu on its dense grid backend, unsharded."""
    nb, M = 64, 6
    bodies = (tt.body(nb, M, a=0.1, f=3),
              tt.body(nb, M, False, x=0.0, y=0.0, r=0.22, a=0.05, f=4))
    bh = tt.one_body_h(bodies[0])
    _, tc = tt.paired_collections(bodies, bh)
    ref = tt.reference_solve(bodies, bh, "poisson", (frc,), (sol,),
                             port_plans=True)
    ts = PoissonSolver(tc)
    return dict(jue=ref["jue"], ts=ts, bie=DirichletBIE(ts),
                f=EmbeddedFunction.from_function(tc, frc),
                bc=BoundaryFunction.from_function(tc, sol))


def _poisson_run(p):
    ue, st = p["ts"].solve_with_stats(p["f"], **SOLVE)
    return p["bie"].apply_bc(ue, p["bc"]), st["annular_iterations"]


def test_two_body_mesh_solve(two_body, monkeypatch):
    """The lockstep GMRES split over the mesh and every Laplace apply
    sharded: the unsharded solve within 1e-12, ipde_tpu's within 1e-10;
    use_mesh(None) gives the unsharded solve back, bit for bit."""
    p, ts = two_body, two_body["ts"]
    base, base_it = _poisson_run(p)
    seen, orig = [], tscalar.batched_annular_solve
    monkeypatch.setattr(tscalar, "batched_annular_solve",
                        lambda *a: seen.append(a[-1]) or orig(*a))
    mesh = make_mesh(devices=CPU4)
    ts.use_mesh(mesh)
    try:
        got, it = _poisson_run(p)
    finally:
        ts.use_mesh(None)
    assert seen == [mesh] and it == base_it
    assert _gap(got, base) <= 1e-12
    jue = p["jue"]
    assert max(np.abs(_np(a) - np.asarray(b)).max() for a, b in
               zip(_fields(got), [jue.grid, *jue.radials])) <= 1e-10
    again, _ = _poisson_run(p)
    assert ts._mesh is None and _gap(again, base) == 0.0


def _one_body(backend=None):
    solver, bie, f, bc = build_problem(nb=64, M=6, device="cpu")
    if backend is not None:
        solver = PoissonSolver(solver.ebdyc, grid_backend=backend)
        bie = DirichletBIE(solver)
    return solver, bie, f, bc


def _mesh_gap(solver, run, monkeypatch, module, name):
    """(max |sharded - unsharded| of ``run()`` under a [cpu] * 4 mesh, the
    target counts of the calls of the sharded apply ``module.name`` made in
    the sharded run)."""
    base = run()
    orig, targets = getattr(module, name), []

    def spy(mesh, *a):
        # the targets follow the sources and charges; the Yukawa k is last
        targets.append(a[-3 if name == "sharded_mh_slp_apply" else -2]
                       .shape[0])
        return orig(mesh, *a)

    monkeypatch.setattr(module, name, spy)
    solver.use_mesh(make_mesh(devices=CPU4))
    try:
        got = run()
    finally:
        solver.use_mesh(None)
    return _gap(got, base), targets


@pytest.mark.parametrize("backend", ["fft", "dense"])
def test_one_boundary_poisson_mesh(backend, monkeypatch):
    """The mesh branches of the radial correction and of the BIE's radial
    loop (one apply of every source onto the ravelled radial grid): within
    5e-12 of the stratified plans (at this size they take every source
    too, and the two agree bit for bit here)."""
    solver, bie, f, bc = _one_body(backend)
    gap, targets = _mesh_gap(
        solver, lambda: bie.apply_bc(solver(f, **SOLVE), bc), monkeypatch,
        tscalar, "sharded_laplace_slp_apply")
    assert gap <= 5e-12
    n_radial = solver.ebdyc.ebdys[0].radial_x.size
    # merged, correct, BIE radial; dense: also the BIE grid field
    assert len(targets) == (3 if backend == "fft" else 4)
    assert targets.count(n_radial) == 2


def test_yukawa_neumann_mesh(monkeypatch):
    """Yukawa k = 2 with NeumannBIE, on the dense grid backend (every
    field of the solve and the BIE through the sharded Yukawa apply)."""
    solver, _, f, _ = _one_body()
    mh = ModifiedHelmholtzSolver(solver.ebdyc, k=2.0, grid_backend="dense")
    bie = NeumannBIE(mh)
    b = solver.ebdyc.ebdys[0].bdy
    bc = BoundaryFunction([torch.as_tensor(np.cos(b.x) * b.normal_x
                                           + np.sin(b.y) * b.normal_y)])
    gap, targets = _mesh_gap(mh, lambda: bie.apply_bc(mh(f, **SOLVE), bc),
                             monkeypatch, tscalar, "sharded_mh_slp_apply")
    assert gap <= 1e-12 and len(targets) == 4


def test_stokes_mesh(monkeypatch):
    """One-boundary Stokes on the dense grid backend (the fft one's
    evaluators take ~9 s to build here): the merged Stokeslet apply sharded
    (_apply_stokes); the radial correction and the BIE stay unsharded."""
    bdy = star(64, a=0.1, f=3)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / 6)
    c = EmbeddedBoundaryCollection([EmbeddedBoundary(bdy, True, 6, bh)],
                                   device="cpu")
    c.generate_grid(bh)
    solver = StokesSolver(c, grid_backend="dense")
    bie = StokesDirichletBIE(solver)
    fu = EmbeddedFunction.from_function(c, lambda x, y: np.sin(x) * np.cos(y))
    fv = EmbeddedFunction.from_function(c, lambda x, y: np.cos(x) * np.sin(y))
    bcs = [BoundaryFunction.from_function(c, lambda x, y: np.sin(x + y))] * 2
    gap, targets = _mesh_gap(
        solver, lambda: bie.apply_bc(*solver(fu, fv, **SOLVE), *bcs),
        monkeypatch, tvector, "sharded_stokes_slp_apply")
    assert gap <= 1e-12
    assert targets == [solver._dense_tx.shape[0]]


def test_use_mesh_checks_the_lead(two_body):
    mesh = Mesh(["cuda:0", "cpu"])
    with pytest.raises(ValueError):
        two_body["ts"].use_mesh(mesh)
    assert two_body["ts"]._mesh is None


def test_dryrun_multichip_cpu():
    grid, physical = dryrun_multichip(4, device="cpu")
    assert physical == 1 and grid.dim() == 2
    assert bool(torch.isfinite(grid).all())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _round_robin(cards, n=4):
    return make_mesh(devices=[cards[i % len(cards)] for i in range(n)])


MIXED = ["cuda:0", "cpu", "cuda:0", "cpu"]


@pytest.mark.gpu
@pytest.mark.parametrize("mixed", [False, True],
                         ids=["cards", "card_and_cpu"])
@pytest.mark.parametrize("name", APPLIES)
def test_sharded_apply_on_card(name, mixed):
    """Four shards round-robin over the cards, or the card and the CPU in
    turns (a CPU shard takes the plain version; the sources, charges and
    targets copied to each shard's device and the results gathered on the
    card, all on one card): within 1e-12 (relative to max |plain|) of the
    unsharded kernel and of the plain version, the results on the lead, one
    launch per card shard."""
    cards = _cards()
    mesh = Mesh(MIXED) if mixed else _round_robin(cards)
    args = [torch.as_tensor(a, device=cards[0])
            for a in _pts(S=1501, T=7001)]
    module, attr = _wrapper(name)
    before = getattr(module, attr).launches
    out = _sharded(name, mesh, *args)
    assert getattr(module, attr).launches == before + (2 if mixed else 4)
    assert all(o.device == mesh.lead
               for o in (out if isinstance(out, tuple) else (out,)))
    got = _tuple(out)
    one = _tuple(_unsharded(name, *args))
    cpu = [a.cpu() for a in args]
    plain = _tuple(_unsharded(name, *cpu))
    for g, o, w in zip(got, one, plain):
        scale = np.abs(w).max()
        assert np.abs(g - o).max() <= 1e-12 * scale
        assert np.abs(g - w).max() <= 1e-12 * scale


@pytest.mark.gpu
def test_launch_keeps_current_device():
    """A launch on any card leaves torch's current device as it was.  The
    launcher sets the device it launches on; with one card that is the
    current one anyway, so a leak shows only where torch sees two."""
    cards = _cards()
    args = _pts()
    for dev in cards:
        torch.cuda.set_device(cards[0])
        tk.laplace_slp_apply(*(torch.as_tensor(a, device=dev)
                               for a in args[:3] + args[4:]))
        assert torch.cuda.current_device() == cards[0].index


@pytest.mark.gpu
def test_mesh_solve_on_card():
    """The two-body problem of dryrun_multichip (nb = 64, M = 6) on the
    card under a 4-shard mesh: iterations equal, within 1e-12 of the
    unsharded solve on the card."""
    cards = _cards()
    solver, bie, f, bc = build_problem(nb=64, M=6, device=cards[0],
                                       two_body=True)

    def run():
        ue, st = solver.solve_with_stats(f, **SOLVE)
        return bie.apply_bc(ue, bc), st["annular_iterations"]

    base, base_it = run()
    solver.use_mesh(_round_robin(cards))
    got, it = run()
    solver.use_mesh(None)
    assert it == base_it and _gap(got, base) <= 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("pde", ["poisson", "stokes"])
def test_boundary_axis_mixed_devices(pde):
    """B = 3 over (card, cpu): the second group's bundle on the CPU, the
    solve gathered on the card; iterations equal and within 1e-12 of max |x|
    of the unsharded solve on the card (the CPU group's FFTs and products
    are not the card's, so the two differ in the last bits)."""
    cards = _cards()
    annuli = _annuli()
    metrics = [m for _, m, *_ in annuli]
    zero = torch.zeros(64, dtype=torch.float64, device=cards[0])
    dev = lambda a: torch.as_tensor(a, device=cards[0])  # noqa: E731
    if pde == "poisson":
        solvers = [ann.AnnularPoissonSolver(g, device=cards[0])
                   for g, *_ in annuli]
        rhss = [s.build_rhs(dev(np.sin(3 * x) * np.cos(2 * y)), zero, zero)
                for s, (_, _, x, y) in zip(solvers, annuli)]
        solve = ann.batched_annular_solve
    else:
        solvers = [anns.AnnularStokesSolver(g, device=cards[0])
                   for g, *_ in annuli]
        rhss = [s.build_rhs(dev(np.sin(3 * x) * np.cos(2 * y)),
                            dev(np.cos(x + y)), zero, zero, zero, zero)
                for s, (_, _, x, y) in zip(solvers, annuli)]
        solve = anns.batched_stokes_solve
    mesh = Mesh(MIXED[:2])
    groups = ann.shard_boundary_axis(
        mesh, [s.make_ops(m) for s, m in zip(solvers, metrics)])
    assert [(g[0].type, g[1]) for g in groups] == \
        [("cuda", slice(0, 2)), ("cpu", slice(2, 3))]
    assert all(v.device.type == "cpu" for v in groups[1][2]
               if isinstance(v, torch.Tensor))
    _same_solve(solve(solvers, metrics, rhss, mesh=mesh),
                solve(solvers, metrics, rhss), tol=1e-12)
