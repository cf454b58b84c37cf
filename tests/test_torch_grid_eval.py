"""The port's free-space FFT grid evaluators (ipde_tpu_torch.ops.grid_eval)
against ipde_tpu: the truncated symbols (host and device forms, on both
sides of the series switch at z = 6), the radial Hankel tables, the
half-spectrum transforms, the patch add, the Laplace, Yukawa (kappa = 3) and
Stokes evaluators against the JAX evaluators and the dense numpy sums at the
sources of tests/test_stokes_grid_eval.py (on a square and a non-square
grid: the half spectrum keeps the FIRST axis halved, and a symbol laid out
for the other convention is silently wrong only when the padded box is
square), and the scatter spread against the matmul one.  The whole fft
slices against ipde_tpu's are in tests/test_torch_grid_eval_slices.py (a
file of their own, so that the tier-1 command's workers run the two halves
side by side).  Also (marker ``gpu``, skipped with a reason where torch
sees no CUDA device) each evaluator on the card against the same evaluator
on the CPU.

Inputs are made with numpy from seeds.  Tolerances: 1e-13 relative to the
largest value for the symbols, tables, transforms and patch add (the same
float64 arithmetic, sums in another order); the evaluators to 1e-12
absolute (scalar), 1e-10 (u, v) and 1e-11 (p), the limits of
tests/test_stokes_grid_eval.py."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import k0 as scipy_k0

from _torch_testing import as_np as _np, rel as _rel
from _torch_testing import one_torch_thread  # noqa: F401
from ipde_tpu.geometry.grid import Grid as JGrid
from ipde_tpu.ops import grid_eval as jge
from ipde_tpu_torch.geometry.grid import Grid
from ipde_tpu_torch.ops import grid_eval as tge

# (Nx, Ny) of the evaluator cases: square, and non-square (the padded box
# is then non-square too)
GRIDS = [(96, 96), (96, 128)]


# ---------------------------------------------------------------------------
# symbols and tables
# ---------------------------------------------------------------------------

L_SYM = 2.7
# z = k L over [0, 60], dense around the series/table switch at z = 6
K_SYM = np.concatenate([[0.0], np.linspace(0.01, 60.0, 997),
                        6.0 + np.linspace(-1e-3, 1e-3, 21)]) / L_SYM
SYMBOLS = {
    "laplace": (lambda m, k: m.laplace_truncated_symbol_dev(k, L_SYM),
                lambda m, k: m.laplace_truncated_symbol(k, L_SYM)),
    "yukawa": (lambda m, k: m.yukawa_truncated_symbol_dev(k, L_SYM, 3.0),
               lambda m, k: m.yukawa_truncated_symbol(k, L_SYM, 3.0)),
    "biharmonic": (lambda m, k: m.biharmonic_truncated_symbol_dev(k, L_SYM),
                   lambda m, k: m.biharmonic_truncated_symbol(k, L_SYM)),
}


@pytest.mark.parametrize("which", sorted(SYMBOLS))
def test_symbols_match_reference(which):
    dev_form, host_form = SYMBOLS[which]
    got = dev_form(tge, torch.as_tensor(K_SYM))
    assert got.dtype == torch.float64
    assert _rel(got, dev_form(jge, jnp.asarray(K_SYM))) <= 1e-13
    assert _rel(host_form(tge, K_SYM), host_form(jge, K_SYM)) <= 1e-13
    # the series side agrees with the table side at the switch
    z = K_SYM * L_SYM
    near = (z > 5.999) & (z < 6.001)
    assert _rel(_np(got)[near], host_form(jge, K_SYM)[near]) <= 1e-13


def test_hankel_tables_match_reference():
    """The three moments over the screened biharmonic symbol and the
    Laplace one, at an evaluator's parameters (h = 2/48)."""
    h = 2.0 / 48
    eta = np.pi / (11.4 * h)
    kmax, r_max = 12.0 * eta, float(np.hypot(25 * h, 25 * h))

    def scr(k, mod):
        return (1.0 + k**2 / (4 * eta**2)) * mod.exp(-(k**2) / (4 * eta**2))

    cases = [
        (lambda k: tge.biharmonic_truncated_symbol_dev(k, L_SYM)
         * scr(k, torch),
         lambda k: jge.biharmonic_truncated_symbol_dev(k, L_SYM)
         * scr(k, jnp),
         ["_m_j1_over_z_dev", "_m_k2_j0_dev"]),
        (lambda k: tge.laplace_truncated_symbol_dev(k, L_SYM)
         * torch.exp(-(k**2) / (4 * eta**2)),
         lambda k: jge.laplace_truncated_symbol_dev(k, L_SYM)
         * jnp.exp(-(k**2) / (4 * eta**2)),
         ["_m_j0_dev", "_m_j1_over_z_dev"]),
    ]
    for tsym, jsym, moments in cases:
        got = tge._radial_hankel_tables_dev(
            tsym, kmax, L_SYM, r_max, [getattr(tge, m) for m in moments],
            ntab=512, device="cpu")
        want = jge._radial_hankel_tables_dev(
            jsym, kmax, L_SYM, r_max, [getattr(jge, m) for m in moments],
            ntab=512)
        for g, w in zip(got, want):
            assert _rel(g.tab, w.tab) <= 1e-13
            r = torch.as_tensor(np.random.default_rng(2).uniform(
                0.0, r_max, 5000))
            assert _rel(g(r), w(jnp.asarray(_np(r)))) <= 1e-13


def test_half_spectrum_transforms_match_reference():
    """FourierPlan2D.rfft2 of a prefix block (the zero tail skipped) and
    irfft2_real_corner, one field and a batch of two, against ipde_tpu's
    plan on a non-square padded box."""
    from ipde_tpu.ops.fourier import FourierPlan2D as JPlan
    from ipde_tpu_torch.ops.fourier import FourierPlan2D
    nx, ny = 96, 160
    x = np.random.default_rng(8).standard_normal((2, 40, 72))
    tp, jp = FourierPlan2D(nx, ny), JPlan(nx, ny)
    c = tp.rfft2(torch.as_tensor(x))
    assert c.shape == (2, nx // 2 + 1, ny)
    for i in range(2):
        jc = jp.rfft2(jnp.asarray(x[i]))
        assert _rel(c[i].real, jc.re) <= 1e-13
        assert _rel(c[i].imag, jc.im) <= 1e-13
        want = jp.irfft2_real_corner(jc, 50, 70, 7, 11)
        assert _rel(tp.irfft2_real_corner(c[i], 50, 70, 7, 11), want) <= 1e-13
        assert _rel(tp.irfft2_real_corner(c, 50, 70, 7, 11)[i], want) <= 1e-13
    # the round trip gives back the field and its zero tail
    full = tp.irfft2_real_corner(c, nx, ny)
    assert _rel(full[:, :40, :72], x) <= 1e-14
    assert float(full[:, 40:].abs().max()) <= 1e-14


# ---------------------------------------------------------------------------
# the evaluators
# ---------------------------------------------------------------------------

def _sources(kind):
    """The sources and charges of tests/test_stokes_grid_eval.py: the Stokes
    case (seed 3, 60 sources on a circle of radius 0.55, two force
    components) or the scalar one (seed 5, 40 sources, radius 0.5)."""
    seed, S, rad = (3, 60, 0.55) if kind == "stokes" else (5, 40, 0.5)
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, S, endpoint=False)
    sx = 1.0 + rad * np.cos(th) + 0.003 * rng.standard_normal(S)
    sy = 1.0 + rad * np.sin(th) + 0.003 * rng.standard_normal(S)
    return sx, sy, rng.standard_normal(S), rng.standard_normal(S)


def _grids(shape):
    """Port and ipde_tpu grids of spacing 2/96 from (0, 0)."""
    Nx, Ny = shape
    xb, yb = [0.0, 2.0 * Nx / 96], [0.0, 2.0 * Ny / 96]
    return Grid(xb, Nx, yb, Ny), JGrid(xb, Nx, yb, Ny)


def _dense(tg, kind, sx, sy, fx, fy):
    """The dense numpy sums on every grid point: (phi,) or (u, v, p)."""
    dx = tg.xg[..., None] - sx
    dy = tg.yg[..., None] - sy
    r = np.maximum(np.hypot(dx, dy), 1e-300)
    if kind == "laplace":
        return ((-np.log(r) / (2 * np.pi)) @ fx,)
    if kind == "yukawa":
        return ((scipy_k0(3.0 * r) / (2 * np.pi)) @ fx,)
    r2 = r**2
    Gxx = (-np.log(r) + dx**2 / r2) / (4 * np.pi)
    Gxy = dx * dy / (4 * np.pi * r2)
    Gyy = (-np.log(r) + dy**2 / r2) / (4 * np.pi)
    return (Gxx @ fx + Gxy @ fy, Gxy @ fx + Gyy @ fy,
            (dx / (2 * np.pi * r2)) @ fx + (dy / (2 * np.pi * r2)) @ fy)


def _make(mod, grid, kind, sx, sy, **kw):
    if kind == "stokes":
        return mod.StokesFreespaceGridEvaluator(grid, sx, sy, **kw)
    return mod.FreespaceGridEvaluator(grid, sx, sy, kernel=kind, kappa=3.0,
                                      **kw)


def _apply(ev, kind, fx, fy):
    return ev(fx, fy) if kind == "stokes" else (ev(fx),)


# absolute limits of tests/test_stokes_grid_eval.py: scalar; u, v; p
LIMITS = {"laplace": (1e-12,), "yukawa": (1e-12,),
          "stokes": (1e-10, 1e-10, 1e-11)}


@pytest.fixture(scope="module")
def evaluators():
    """{(kind, shape): (port evaluator, ipde_tpu evaluator or None,
    inputs)}, built once.  ipde_tpu's evaluators (their setup is most of
    this file's time) on the non-square grid only."""
    out = {}
    for shape in GRIDS:
        tg, jg = _grids(shape)
        for kind in LIMITS:
            sx, sy, fx, fy = _sources(kind)
            out[kind, shape] = (
                _make(tge, tg, kind, sx, sy, device="cpu"),
                _make(jge, jg, kind, sx, sy) if shape[0] != shape[1]
                else None, (tg, sx, sy, fx, fy))
    return out


@pytest.mark.parametrize("shape", GRIDS)
@pytest.mark.parametrize("kind", sorted(LIMITS))
def test_evaluator_matches_reference_and_dense(evaluators, kind, shape):
    tev, jev, (tg, sx, sy, fx, fy) = evaluators[kind, shape]
    got = _apply(tev, kind, torch.as_tensor(fx), torch.as_tensor(fy))
    refs = [_dense(tg, kind, sx, sy, fx, fy)]
    if jev is not None:
        assert (tev.Px, tev.Py, tev.L) == (jev.Px, jev.Py, jev.L)
        assert tev.Px != tev.Py
        refs.append(_apply(jev, kind, jnp.asarray(fx), jnp.asarray(fy)))
    for ref in refs:
        for g, w, lim in zip(got, ref, LIMITS[kind]):
            assert g.shape == tg.shape and g.dtype == torch.float64
            assert np.abs(_np(g) - _np(w)).max() <= lim


@pytest.mark.parametrize("kind", ["laplace", "stokes"])
def test_patch_add_matches_reference(evaluators, kind):
    """The port's near corrections (one CSR product) against ipde_tpu's
    serial patch scan (_apply_patches): on ipde_tpu's own patch values for
    the scalar kernel, on each package's values for the Stokeslet."""
    tev, jev, (tg, sx, sy, fx, fy) = evaluators[kind, GRIDS[1]]
    zero = jnp.zeros(tg.shape)
    if kind == "laplace":
        vals = np.array(jev.patches)
        *_, cell = tev._patch_geometry(sx, sy, 22.0 * max(tg.xh, tg.yh))
        A = tev._patch_matrix(cell, torch.as_tensor(vals != 0),
                              [(0, 0, torch.as_tensor(vals))], 1, 1)
        got = [A @ torch.as_tensor(fx)]
        want = jev._apply_patches([zero], [jev.patches * fx[:, None]])
    else:
        got = tev._patches @ torch.as_tensor(np.concatenate([fx, fy]))
        got = got.reshape(3, *tg.shape)
        P = jev.patch_P
        dxs = jnp.repeat(jev.patch_nodex[:, None] + jev.patch_locx[None, :],
                         P, axis=1)
        dys = jnp.tile(jev.patch_nodey[:, None] + jev.patch_locy[None, :],
                       (1, P))
        rdot = dxs * fx[:, None] + dys * fy[:, None]
        want = jev._apply_patches(
            [zero] * 3, [jev.CA * fx[:, None] + jev.CB2 * dxs * rdot,
                         jev.CA * fy[:, None] + jev.CB2 * dys * rdot,
                         jev.CP * rdot])
    for g, w in zip(got, want):
        assert _rel(g.reshape(tg.shape), w) <= 1e-13


@pytest.mark.parametrize("kind", ["yukawa", "stokes"])
def test_scatter_spread_matches_matmul(evaluators, monkeypatch, kind):
    """Past SPREAD_MATMUL_MB the spread is an index_add_ scatter: the same
    field as the matmul spread (the evaluator's spreading plan made again
    with the limit at 0)."""
    mm, _, (tg, sx, sy, fx, fy) = evaluators[kind, GRIDS[1]]
    q = torch.as_tensor(np.stack([fx, fy]))
    monkeypatch.setattr(tge, "SPREAD_MATMUL_MB", 0.0)
    sc = copy.copy(mm)
    sc._setup_spreading(sx, sy, 16)
    assert mm._spread_mm is not None and sc._spread_mm is None
    assert _rel(sc._spread(q), mm._spread(q)) <= 1e-13
    for g, w in zip(_apply(sc, kind, *q), _apply(mm, kind, *q)):
        assert _rel(g, w) <= 1e-13


def test_evaluator_setup_checks():
    tg, _ = _grids(GRIDS[0])
    sx, sy, fx, _ = _sources("laplace")
    with pytest.raises(ValueError, match="helmholtz"):
        tge.FreespaceGridEvaluator(tg, sx, sy, kernel="helmholtz",
                                   device="cpu")
    with pytest.raises(ValueError, match="padding insufficient"):
        tge.FreespaceGridEvaluator(tg, sx, sy, pad=1, device="cpu")


# ---------------------------------------------------------------------------
# on the card (marker gpu)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(LIMITS))
def test_evaluator_on_cuda_matches_cpu(kind):
    """The same evaluator built on the card and on the CPU: cuFFT and
    cuSPARSE against the CPU transforms and sparse product, sums in
    another order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    tg, _ = _grids(GRIDS[1])
    sx, sy, fx, fy = _sources(kind)
    out = []
    for d in ("cpu", dev):
        ev = _make(tge, tg, kind, sx, sy, device=d)
        out.append([_np(a) for a in _apply(
            ev, kind, torch.as_tensor(fx, device=d),
            torch.as_tensor(fy, device=d))])
    for c, g, lim in zip(*out, LIMITS[kind]):
        assert np.abs(c - g).max() <= 0.01 * lim
