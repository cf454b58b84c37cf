"""The port's moving-boundary path against ipde_tpu: PointPartition, the
zone-3 Newton solves, one step of each semi-Lagrangian advector (FE and
BDF2 with a moving boundary, BDF3 with a fixed one) and one
CoupledAdvectionDiffusionStepper step against ipde_tpu's eager recipe
(tests/test_stepper.py:46-67: advector, ModifiedHelmholtzSolver on its
dense grid backend, NeumannBIE).

One geometry, star(48, a=0.1, f=3), M = 8, registered with pad_quantum=256
in ipde_tpu and carried to the port by ``save`` / ``load_collection``; the
rigid rotation u = -y, v = x, dt = 0.05, and the diffusing Gaussian of
examples/coupled_advection_diffusion.py (nu = 0.05, t0 = 0.5).  Each
ipde_tpu step is computed once per module.  Tolerances: partitions' zones
equal and values 1e-12, Newton solutions 1e-12, advected fields 1e-11 and
the stepper 1e-10 of the largest value.

ipde_tpu's ThirdOrderAdvector builds its first partition with
extra_capture=0 (ROADMAP.md Queue 3); the port passes 3 umax dt.  The BDF3
parity test gives the reference the port's capture, and
test_third_order_captures_points_entering_an_annulus shows a point the
reference misses.  Marker ``gpu``: one stepper step on the card against
the CPU, skipped with a reason where torch sees no CUDA device."""

import numpy as np
import pytest

from _torch_testing import as_np as _np, cuda_or_skip
from _torch_testing import one_torch_thread  # noqa: F401
from _torch_testing import rel_gap as _gap
import ipde_tpu.advection.semi_lagrangian as jsl
from ipde_tpu.advection import zone3_device as jz3
from ipde_tpu.functions import BoundaryFunction as JBF
from ipde_tpu.functions import EmbeddedFunction as JEF
from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection as JEBC
from ipde_tpu.geometry.curve import star as jstar
from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary as JEB
from ipde_tpu.geometry.partition import PointPartition as JPP
from ipde_tpu.solvers.bie import NeumannBIE as JNBIE
from ipde_tpu.solvers.scalar import ModifiedHelmholtzSolver as JMHS
from ipde_tpu_torch.advection import semi_lagrangian as sl
from ipde_tpu_torch.advection import zone3_device as z3
from ipde_tpu_torch.advection.stepper import CoupledAdvectionDiffusionStepper
from ipde_tpu_torch.functions import EmbeddedFunction
from ipde_tpu_torch.geometry.collection import load_collection
from ipde_tpu_torch.geometry.partition import (PointPartition,
                                               interpolate_to_points)

NB, M, PQ = 48, 8, 256
NU, DT, T0 = 0.05, 0.05, 0.5


def c0(x, y):
    s = 4 * NU * T0
    return np.exp(-(x * x + y * y) / s) / (np.pi * s)


def uf(x, y):
    return -y


def vf(x, y):
    return x


def F(x, y):
    return np.exp(np.sin(x)) * np.sin(2 * y)


def _collections(device="cpu"):
    bdy = jstar(NB, a=0.1, f=3)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    jc = JEBC([JEB(bdy, True, M, bh, qfs_tolerance=1e-12)])
    jc.generate_grid(bh, pad_quantum=PQ)
    tc = load_collection(jc.save(), device)
    tc.generate_grid(tc.ebdys[0].h, pad_quantum=PQ)
    return jc, tc


def _velocity(ebdyc):
    return (EmbeddedFunction.from_function(ebdyc, uf),
            EmbeddedFunction.from_function(ebdyc, vf))


@pytest.fixture(scope="module")
def steps():
    """One FE step and the BDF2 step after it (both moving the boundary on
    the fixed grid), in both packages, from the same saved geometry and
    fields."""
    jc, tc = _collections()
    jcf = JEF.from_function(jc, c0)
    tcf = EmbeddedFunction.load(jcf.save(), "cpu")
    ja = jsl.SemiLagrangianAdvector(jc, JEF.from_function(jc, uf),
                                    JEF.from_function(jc, vf))
    jn = ja.generate(DT, fixed_grid=True)
    ta = sl.SemiLagrangianAdvector(tc, *_velocity(tc))
    tn = ta.generate(DT, fixed_grid=True)
    jstar_ = ja(jcf)
    jb = jsl.SecondOrderAdvector(jn, JEF.from_function(jn, uf),
                                 JEF.from_function(jn, vf), ja)
    jn2 = jb.generate(DT, fixed_grid=True)
    tb = sl.SecondOrderAdvector(tn, *_velocity(tn), ta)
    tn2 = tb.generate(DT, fixed_grid=True)
    return dict(jc=jc, tc=tc, jcf=jcf, tcf=tcf, ja=ja, ta=ta, jn=jn, tn=tn,
                jstar=jstar_, tstar=ta(tcf), jb=jb, tb=tb, jn2=jn2, tn2=tn2)


# ---------------------------------------------------------------------------
# PointPartition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad_quantum", [None, 128])
def test_point_partition_matches_ipde_tpu(steps, pad_quantum):
    jc, tc = steps["jc"], steps["tc"]
    rng = np.random.default_rng(1)
    t = rng.uniform(0, 2 * np.pi, 400)
    rr = rng.uniform(0, 1.25, 400)
    px, py = rr * np.cos(t), rr * np.sin(t)
    jp = JPP(jc, px, py, pad_quantum=pad_quantum)
    tp = PointPartition(tc, px, py, pad_quantum=pad_quantum)
    assert np.array_equal(jp.zone1, tp.zone1)
    assert np.array_equal(jp.phys, tp.phys) and tp.n_ext > 0
    for (a, *_), (b, *_) in zip(jp.zone2 + jp.zone3, tp.zone2 + tp.zone3):
        assert a.size and np.array_equal(a, b)
    assert _np(tp.zone1_dev).shape == _np(jp.zone1_dev).shape
    jf = JEF.from_function(jc, F)
    tf = EmbeddedFunction.load(jf.save(), "cpu")
    want = _np(jp.interpolate_many([jf, jf * 2.0]))
    got = _np(tp.interpolate_many([tf, tf * 2.0]))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.abs(got - want)[ok].max() < 1e-12 * np.abs(want[ok]).max()
    # one field, exterior 0; the one-shot helper (exterior NaN)
    one = _np(tp.interpolate(tf, exterior_value=0.0))
    assert np.abs(one - np.where(ok[0], got[0], 0.0)).max() < 1e-15
    assert np.allclose(_np(interpolate_to_points(tc, tf, px, py)), got[0],
                       rtol=0, atol=1e-15, equal_nan=True)


# ---------------------------------------------------------------------------
# zone-3 Newton solves
# ---------------------------------------------------------------------------

def _boundary_fields(e, ang):
    """The boundary of e rotated by ang with the rotation's velocity and
    normal derivatives of a made-up field, as the advectors build them."""
    c, s = np.cos(ang), np.sin(ang)
    b = e.bdy
    bx, by = c * b.x - s * b.y, s * b.x + c * b.y
    nx, ny = c * b.normal_x - s * b.normal_y, s * b.normal_x + c * b.normal_y
    return dict(bx=bx, by=by, nx=nx, ny=ny, ub=-by, vb=bx,
                urb=0.1 * np.cos(b.t), vrb=0.2 * np.sin(2 * b.t),
                urrb=0.05 * np.sin(b.t), vrrb=-0.05 * np.cos(3 * b.t))


def test_zone3_newton_matches_ipde_tpu(steps):
    e = steps["tc"].ebdys[0]
    rng = np.random.default_rng(2)
    P = 40
    s_true = rng.uniform(0, 2 * np.pi, P)
    r_true = rng.uniform(0.0, 0.5 * e.radial_width, P)
    fe = _boundary_fields(e, 0.0)
    at = {k: sl._trig_interp(v, s_true) for k, v in fe.items()}
    xo = at["bx"] + r_true * at["nx"] + DT * (at["ub"] + r_true * at["urb"])
    yo = at["by"] + r_true * at["ny"] + DT * (at["vb"] + r_true * at["vrb"])
    s0, r0 = s_true + 0.02, np.zeros(P)
    fe8 = {k: fe[k] for k in z3._FE_FIELDS}
    want = jz3.zone3_newton_fe(fe8, DT, xo, yo, s0, r0)
    got = z3.zone3_newton_fe(fe8, DT, xo, yo, s0, r0, device="cpu")
    assert want[2] < 1e-8 and got[2] < 1e-8
    for a, b in zip(got[:2], want[:2]):
        assert np.abs(a - b).max() < 1e-12
    assert np.abs(got[0] - s_true).max() < 1e-10
    # second order: the old level is the boundary rotated back by DT
    fo = _boundary_fields(e, -DT)
    args = (fe, fo, DT, xo, yo, s0, r0, s0, r0)
    want = jz3.zone3_newton_so(*args)
    got = z3.zone3_newton_so(*args, device="cpu")
    assert want[4] < 1e-8 and got[4] < 1e-8
    for a, b in zip(got[:4], want[:4]):
        assert np.abs(a - b).max() < 1e-12


# ---------------------------------------------------------------------------
# advectors
# ---------------------------------------------------------------------------

def test_fe_step_matches_ipde_tpu(steps):
    jn, tn = steps["jn"], steps["tn"]
    assert np.array_equal(jn.pna_flat, tn.pna_flat)
    # the step uncovers points outside the old domain: the zone-3 Newton
    # places their departure points
    px, py = sl._query_points(tn)
    assert PointPartition(steps["tc"], px, py).n_ext > 0
    for a, b in ((steps["ta"].xd, steps["ja"].xd),
                 (steps["ta"].yd, steps["ja"].yd)):
        assert np.abs(a - b).max() < 1e-11
    assert _gap(steps["tstar"], steps["jstar"], jn.phys) < 1e-11


def test_fe_boundary_motion_branch(steps):
    """``boundary_motion`` that moves the boundary as the FE default does
    (x + dt u, y + dt v for the rotation) gives the default step's result;
    ``fixed_boundary`` keeps the geometry."""
    tc = steps["tc"]
    ta = sl.SemiLagrangianAdvector(tc, *_velocity(tc))
    tn = ta.generate(DT, fixed_grid=True,
                     boundary_motion=lambda x, y, dt: (x - dt * y,
                                                       y + dt * x))
    assert np.array_equal(tn.pna_flat, steps["tn"].pna_flat)
    assert _gap(ta(steps["tcf"]), steps["tstar"], tn.phys) < 1e-12
    tf = sl.SemiLagrangianAdvector(tc, *_velocity(tc))
    assert tf.generate(DT, fixed_boundary=True).ebdys[0] is tc.ebdys[0]
    assert tf(steps["tcf"]).grid.shape == tc.grid.shape


def test_bdf2_step_matches_ipde_tpu(steps):
    jn2, tn2 = steps["jn2"], steps["tn2"]
    assert np.array_equal(jn2.pna_flat, tn2.pna_flat)
    got = steps["tb"].advect_bdf2(steps["tstar"], steps["tcf"])
    want = steps["jb"].advect_bdf2(steps["jstar"], steps["jcf"])
    assert _gap(got, want, jn2.phys) < 1e-11


class _Hist:
    def __init__(self, u, v, uo, vo):
        self.u, self.v, self.uo, self.vo = u, v, uo, vo


def test_bdf3_fixed_boundary_matches_ipde_tpu(steps, monkeypatch):
    """BDF3 on the fixed star with the rotation at three levels; the
    reference is given the port's first-partition capture of 3 umax dt."""
    jc, tc = steps["jc"], steps["tc"]
    jv = [JEF.from_function(jc, lambda x, y, w=w, fn=fn: fn(x, y) * w)
          for w in (1.0, 0.9, 0.8) for fn in (uf, vf)]
    tv = [EmbeddedFunction.load(f.save(), "cpu") for f in jv]
    ta = sl.ThirdOrderAdvector(tc, tv[0], tv[1], _Hist(*tv[2:]))
    ta.generate(DT)
    capture = ta.extra_capture
    assert capture == pytest.approx(3 * DT * float(
        np.sqrt(_np(abs(tv[0] * tv[0] + tv[1] * tv[1]).max()))))

    def with_capture(ebdyc, x, y, seed=None, **kw):
        if seed is None:
            kw["extra_capture"] = capture
        return JPP(ebdyc, x, y, seed=seed, **kw)

    monkeypatch.setattr(jsl, "PointPartition", with_capture)
    ja = jsl.ThirdOrderAdvector(jc, jv[0], jv[1], _Hist(*jv[2:]))
    ja.generate(DT)
    fs = [steps["jcf"], JEF.from_function(jc, F), steps["jcf"] * 0.5]
    got = ta(*[EmbeddedFunction.load(f.save(), "cpu") for f in fs])
    assert _gap(got, ja(*fs), jc.phys) < 1e-11


def test_third_order_captures_points_entering_an_annulus(steps):
    """An outward trace (inward flow u = -1.5 (x, y) on the fixed star): a
    departure point that lies in the annulus while its arrival point was
    beyond the reference's capture band.  The port's seeded partitions
    agree with fresh ones; ipde_tpu's (extra_capture=0) put at least one
    such point in zone 1."""
    jc, tc = steps["jc"], steps["tc"]
    inward = [lambda x, y: -1.5 * x, lambda x, y: -1.5 * y]
    jv = [JEF.from_function(jc, fn) for fn in inward]
    tv = [EmbeddedFunction.load(f.save(), "cpu") for f in jv]
    ta = sl.ThirdOrderAdvector(tc, tv[0], tv[1], _Hist(*tv, *tv))
    ta.generate(DT)
    ja = jsl.ThirdOrderAdvector(jc, jv[0], jv[1], _Hist(*jv, *jv))
    ja.generate(DT)
    missed = 0
    for tp, jp in zip(ta.dep_partitions, ja.dep_partitions):
        fresh = PointPartition(tc, tp.x, tp.y, fix_r=True)
        assert np.array_equal(tp.zone2[0][0], fresh.zone2[0][0])
        assert np.array_equal(tp.zone1, fresh.zone1)
        missed += np.setdiff1d(fresh.zone2[0][0], jp.zone2[0][0]).size
    assert missed > 0


# ---------------------------------------------------------------------------
# the stepper
# ---------------------------------------------------------------------------

def test_stepper_matches_eager_step(steps):
    jn = steps["jn"]
    k2 = 1.0 / (DT * NU)
    # the reference on its dense grid backend (the port's stepper takes the
    # default fft one): the two evaluate the same layer potential within
    # ~5e-16 (tests/test_torch_grid_eval.py), and ipde_tpu's fft setup
    # would triple this test's time
    js = JMHS(jn, k=np.sqrt(k2), grid_backend="dense")
    bcn = JBF([np.zeros(e.bdy.N) for e in jn])
    want = JNBIE(js).apply_bc(
        js(steps["jstar"] * k2, tol=1e-12, maxiter=100, restart=30), bcn)
    stepper = CoupledAdvectionDiffusionStepper(steps["tc"], _velocity, NU,
                                               DT)
    got = stepper.step(steps["tcf"])
    assert np.array_equal(stepper.ebdyc.pna_flat, jn.pna_flat)
    assert _gap(got, want, jn.phys) < 1e-10
    assert set(stepper.last_times) == {"generate_s", "advect_s", "setup_s",
                                       "solve_s"}
    assert stepper.recompiles == 0 and stepper.miss_log == []
    assert len(stepper.helpers) == 1


def test_stepper_checks_its_inputs(steps):
    bdy = steps["tc"].ebdys[0]
    tc = load_collection({"ebdys": [bdy.save()]}, "cpu")
    tc.generate_grid(bdy.h)
    with pytest.raises(ValueError, match="pad_quantum"):
        CoupledAdvectionDiffusionStepper(tc, _velocity, NU, DT)
    with pytest.raises(NotImplementedError, match="neumann"):
        CoupledAdvectionDiffusionStepper(steps["tc"], _velocity, NU, DT,
                                         bc="dirichlet")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_stepper_step_on_cuda_matches_cpu(steps, monkeypatch):
    # both runs on the host setup backend (the CPU's; the card's default,
    # the device one, is held to the CPU in test_torch_device_setup.py)
    monkeypatch.setenv("IPDE_QFS_BACKEND", "host")
    from ipde_tpu_torch.ops import kernels as K
    cuda_or_skip()
    out = {}
    for dev in ("cpu", "cuda"):
        _, tc = _collections(dev)
        before = K.mh_slp_apply.launches
        stepper = CoupledAdvectionDiffusionStepper(tc, _velocity, NU, DT)
        c = stepper.step(EmbeddedFunction.from_function(tc, c0))
        out[dev] = (c, K.mh_slp_apply.launches - before, stepper.ebdyc.phys)
    (cpu, nc, phys), (gpu, ng, _) = out["cpu"], out["cuda"]
    assert nc == 0 and ng > 0
    assert _gap(gpu, cpu, phys) < 1e-10

