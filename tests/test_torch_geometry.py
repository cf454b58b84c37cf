"""Host-side modules of the port against ipde_tpu: the numpy copies
(curve, grid, coords, cheb, slepian, annular, embedded boundary, singular
forms) give bit-equal arrays, and the collection and function types built
on tensors hold the same values, on the problem of
__graft_entry__.entry() (star(128, a=0.1, f=3), M=8).  Also the shared
scaffold of the port's tests (tests/_torch_testing.py): its cached builders
and its thread fixture."""

import numpy as np
import pytest
import torch

import _torch_testing as tt
from _torch_testing import one_torch_thread  # noqa: F401
from ipde_tpu.functions import BoundaryFunction as JBF
from ipde_tpu.functions import EmbeddedFunction as JEF
from ipde_tpu.geometry.annular import AnnularGeometry as JAG
from ipde_tpu.geometry.annular import AnnularMetric as JAM
from ipde_tpu.geometry.curve import star as jstar
from ipde_tpu.ops import singular as jsq
from ipde_tpu.ops.slepian import SlepianMollifier as JSM
from ipde_tpu.utils.cheb import ChebyshevOperators as JCO
from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu_torch.geometry.annular import AnnularGeometry, AnnularMetric
from ipde_tpu_torch.geometry.collection import (EmbeddedBoundaryCollection,
                                                load_collection)
from ipde_tpu_torch.geometry.curve import star
from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
from ipde_tpu_torch.ops import singular as sq
from ipde_tpu_torch.ops.slepian import SlepianMollifier
from ipde_tpu_torch.utils.cheb import ChebyshevOperators

NB, M = 128, 8


def sol(x, y):
    return -np.cos(x) * np.exp(np.sin(x)) * np.sin(y)


def _bh(bdy):
    return min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)


ENTRY = (tt.body(NB, M, a=0.1, f=3),)


@pytest.fixture(scope="module")
def pair():
    """The entry() geometry in ipde_tpu and, from its save(), in the port,
    each with its bump ready."""
    jc, tc = tt.paired_collections(ENTRY, tt.one_body_h(ENTRY[0]))
    jc.ready_bump()
    tc.ready_bump()
    return jc, tc


def _same(a, b):
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


def test_curve_bit_equal():
    a, b = jstar(NB, a=0.2, f=5), star(NB, a=0.2, f=5)
    for name in ("x", "y", "normal_x", "normal_y", "curvature", "weights",
                 "speed"):
        assert _same(getattr(a, name), getattr(b, name)), name
    assert _same(a.resampled(3 * NB).x, b.resampled(3 * NB).x)
    assert _same(a.complex_offset(0.07).y, b.complex_offset(0.07).y)
    d = b.dev("cpu")
    assert d["x"].dtype == torch.float64 and _same(a.weights, d["weights"])


def test_cheb_slepian_annular_bit_equal():
    ja, ta = JCO(M, 0.3), ChebyshevOperators(M, 0.3)
    for name in ("D00", "D01", "D12", "R01", "R12", "R02", "P10",
                 "ibc_dirichlet", "obc_neumann"):
        assert _same(getattr(ja, name), getattr(ta, name)), name
    x = np.linspace(-1.2, 1.2, 301)
    assert _same(JSM(16).step(x), SlepianMollifier(16).step(x))
    assert _same(JSM(16).bump(x), SlepianMollifier(16).bump(x))
    bdy = star(NB, a=0.1, f=3)
    jg, tg = JAG(NB, M, -0.1, 0.0, 1.0), AnnularGeometry(NB, M, -0.1, 0.0, 1.0)
    jm = JAM(bdy.speed, bdy.curvature, jg)
    tm = AnnularMetric(bdy.speed, bdy.curvature, tg)
    for name in ("psi0", "psi1", "inv_psi2", "dt_curvature"):
        assert _same(getattr(jm, name), getattr(tm, name)), name


def test_singular_forms_bit_equal():
    a, b = jstar(NB, a=0.1, f=3), star(NB, a=0.1, f=3)
    src_a, src_b = a.complex_offset(0.1), b.complex_offset(0.1)
    assert _same(jsq.laplace_slp_self(a), sq.laplace_slp_self(b))
    assert _same(jsq.laplace_dlp_self(a), sq.laplace_dlp_self(b))
    assert _same(jsq.laplace_slp_naive(src_a, a.x, a.y),
                 sq.laplace_slp_naive(src_b, b.x, b.y))
    assert _same(jsq.laplace_dlp_naive(src_a, a.x, a.y),
                 sq.laplace_dlp_naive(src_b, b.x, b.y))


def test_embedded_boundary_and_registration_bit_equal(pair):
    jc, tc = pair
    je, te = jc.ebdys[0], tc.ebdys[0]
    for name in ("radial_x", "radial_y", "radial_quadrature_weights",
                 "interp_f_to_bdy", "interp_dn_to_interface", "radial_cutoff"):
        assert _same(getattr(je, name), getattr(te, name)), name
    for name in ("interface", "bdy_qfs_upper", "interface_qfs_lower"):
        assert _same(getattr(je, name).x, getattr(te, name).x), name
    jr, tr = je.registration, te.registration
    for name in ("near_ix", "near_iy", "near_t", "near_r", "ia_ix", "ia_t",
                 "grid_to_radial_step"):
        assert _same(getattr(jr, name), getattr(tr, name)), name


def test_collection_matches(pair):
    jc, tc = pair
    assert tc.grid.shape == jc.grid.shape
    assert tc.grid.Nx % 32 == 0 and tc.grid.Ny % 32 == 0
    for name in ("phys", "in_annulus", "phys_not_in_annulus", "pna_flat",
                 "pna_x", "grid_step", "lap", "all_interface_y"):
        assert _same(getattr(jc, name), getattr(tc, name)), name
    assert _same(jc.phys_extremes(), tc.phys_extremes())
    assert _same(jc.bumpy, tc.bumpy)
    assert _same(jc.grid_step_dev, tc.grid_step_dev)
    assert _same(jc.ia_flat_list[0], tc.ia_flat_list[0])
    assert tc.phys_dev.dtype == torch.bool and _same(jc.phys, tc.phys_dev)
    rng = np.random.default_rng(3)
    f = rng.standard_normal(jc.grid.shape)
    # demean: one sum over the box; the summation order differs
    want = np.asarray(jc.demean_function(f))
    got = tc.demean_function(torch.as_tensor(f)).numpy()
    assert np.abs(got - want).max() < 1e-13 * np.abs(want).max()
    v = np.arange(NB, dtype=np.float64)
    assert [_same(a, b) for a, b in
            zip(jc.v2l(v), tc.v2l(torch.as_tensor(v)))] == [True]


def test_collection_device_is_explicit():
    # no device given: the CUDA card, and without one a RuntimeError (no
    # silent CPU fallback); the CPU only where the caller names it
    for make in (lambda: EmbeddedBoundaryCollection([]),
                 lambda: load_collection({"ebdys": []})):
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    assert EmbeddedBoundaryCollection([], device="cpu").device.type == "cpu"
    # pad_quantum is ported: the padded sets sit on the named device, padded
    # to a multiple of the quantum with the out-of-range index Nx * Ny
    bdy = star(NB, a=0.1, f=3)
    tc = EmbeddedBoundaryCollection(
        [EmbeddedBoundary(bdy, True, M, _bh(bdy))], device="cpu")
    tc.generate_grid(_bh(bdy), pad_quantum=256)
    n_real = int(tc.phys_not_in_annulus.sum())
    assert tc.pad_quantum == 256 and tc.pna_flat.size % 256 == 0
    assert (tc.pna_flat[n_real:] == tc.grid.Nx * tc.grid.Ny).all()
    assert tc.pna_flat_dev.device.type == "cpu"


def test_functions_match_and_roundtrip(pair):
    jc, tc = pair
    jf, tf = JEF.from_function(jc, sol), EmbeddedFunction.from_function(tc, sol)
    assert _same(jf.grid, tf.grid) and _same(jf.radials[0], tf.radials[0])
    assert _same(JBF.from_function(jc, sol)[0],
                 BoundaryFunction.from_function(tc, sol)[0])
    # a function saved by ipde_tpu loads into the port, and back
    lf = EmbeddedFunction.load(jf.save(), "cpu")
    assert _same(jf.grid, lf.grid) and _same(jf.radials[0], lf.radials[0])
    rf = JEF.load(lf.save())
    assert _same(rf.grid, lf.grid)
    g = 2.0 * tf - tf * tf + 1.0
    jg = 2.0 * jf - jf * jf + 1.0
    assert _same(jg.grid, g.grid) and _same(jg.radials[0], g.radials[0])
    assert _same(jf.get_grid_value(jc), tf.get_grid_value(tc))
    assert float(abs(-tf).max()) == float(abs(-jf).max())
    assert float(tf.max_on(tc)) == float(jf.max_on(jc))


# ---------------------------------------------------------------------------
# the scaffold of the port's tests
# ---------------------------------------------------------------------------

def test_cached_builders_share_equal_problems(monkeypatch):
    """Equal arguments give the same objects (a default spelled out is
    the same problem), other arguments other ones; a set-up-backend
    variable is part of the key."""
    small = (tt.body(32, 4, a=0.1, f=3),)
    h = tt.one_body_h(small[0])
    jc, tc = tt.paired_collections(small, h)
    assert tt.paired_collections(small, h, pad_quantum=None) == (jc, tc)
    other = tt.paired_collections((tt.body(32, 4, a=0.05, f=3),), h)
    assert other[0] is not jc and other[1] is not tc
    assert tt.paired_collections(small, h, pad_quantum=256)[0] is not jc
    s = tt.port_solver(small, h, "poisson")
    assert tt.port_solver(small, h, "poisson", grid_backend="dense") is s
    assert tt.port_solver(small, h, "poisson", grid_backend="fft") is not s
    assert s.ebdyc is tc
    for name in tt.SETUP_VARS:
        monkeypatch.delenv(name, raising=False)
    assert tt.paired_collections(small, h)[0] is jc
    monkeypatch.setenv("IPDE_QFS_BACKEND", "host")
    assert tt.paired_collections(small, h)[0] is not jc
    monkeypatch.delenv("IPDE_QFS_BACKEND")
    assert tt.paired_collections(small, h)[0] is jc


def test_thread_fixture_restores_what_it_found():
    """one_torch_thread holds torch and BLAS to one thread for its module
    and gives back the counts it found, whatever they were."""
    threadpoolctl = pytest.importorskip("threadpoolctl")

    def blas():
        return {p["num_threads"] for p in threadpoolctl.threadpool_info()
                if p["user_api"] == "blas"}

    assert torch.get_num_threads() == 1 and blas() == {1}
    outer = torch.get_num_threads()
    torch.set_num_threads(3)
    try:
        with threadpoolctl.threadpool_limits(limits=2, user_api="blas"):
            gen = tt.one_torch_thread.__wrapped__()
            next(gen)
            assert torch.get_num_threads() == 1 and blas() == {1}
            with pytest.raises(StopIteration):
                next(gen)
            assert torch.get_num_threads() == 3 and blas() == {2}
    finally:
        torch.set_num_threads(outer)
    assert blas() == {1}
