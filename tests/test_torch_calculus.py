"""The port's Fourier and FD pieces, the window NUFFT, the exact and
polynomial interpolators, the collection calculus and pad_quantum against
ipde_tpu (tests/test_interp.py, test_collection_calculus.py and
test_padded_shapes.py at small sizes).

Inputs are made with numpy from a seed; the collection is star(48, a=0.1,
f=3), M = 8.  Tolerances are relative to the largest value compared: 1e-13
for the transforms and interpolators (the same float64 sums in another
order), 1e-12 for the calculus (two spectral derivatives, or the radial
Laplacian's two Chebyshev ones).  Two places where the port departs from
ipde_tpu on purpose are held to the exact sum instead: ``_pad_modes`` and
``HybridInterp2D`` put the mode k = (n - 1) / 2 of an odd n at the end in
ipde_tpu (test_odd_grid_matches_exact_sum)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_testing as tt
from _torch_testing import assert_close as _close
from _torch_testing import one_torch_thread  # noqa: F401
from ipde_tpu.functions import EmbeddedFunction as JEF
from ipde_tpu.ops import fd as jfd
from ipde_tpu.ops import fourier as jfourier
from ipde_tpu.ops import interp as jinterp
from ipde_tpu.ops.cx import Cx
from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu_torch.ops import fd, fourier, interp
from ipde_tpu_torch.solvers.bie import NeumannBIE, solve_dirichlet
from ipde_tpu_torch.solvers.scalar import (ModifiedHelmholtzSolver,
                                           PoissonSolver)

NB, M = 48, 8


def _cx(c):
    return Cx(jnp.asarray(np.real(c)), jnp.asarray(np.imag(c)))


def _smooth_field(rng, nx, ny, B=None):
    """The band-limited field of tests/test_interp.py (modes damped by
    exp(-0.05 |k|^2)), B of them when B is given."""
    f = rng.standard_normal((B or 1, nx, ny))
    kx = np.fft.fftfreq(nx, 1 / nx)
    ky = np.fft.fftfreq(ny, 1 / ny)
    fh = np.fft.fft2(f) * np.exp(-0.05 * (kx[:, None] ** 2 + ky[None, :] ** 2))
    f = np.real(np.fft.ifft2(fh))
    return f if B else f[0]


# ---------------------------------------------------------------------------
# Fourier and FD pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("piece", ["plan1d", "plan2d", "filter", "fd"])
def test_fourier_and_fd_pieces(piece):
    rng = np.random.default_rng(1)
    if piece == "plan1d":
        for n in (48, 49):
            x = rng.standard_normal((5, n))
            jp, tp = jfourier.FourierPlan1D(n), fourier.FourierPlan1D(
                n, device="cpu")
            xt = torch.as_tensor(x)
            jc, tc = jp.rfft(jnp.asarray(x)), tp.rfft(xt)
            _close(tc.real, jc.re)
            _close(tc.imag, jc.im)
            # irfft of a spectrum whose zero and Nyquist modes carry an
            # imaginary part: both packages ignore it
            c = rng.standard_normal((5, n // 2 + 1)) \
                + 1j * rng.standard_normal((5, n // 2 + 1))
            _close(tp.irfft(torch.as_tensor(c)), jp.irfft(_cx(c)))
            _close(tp.tderiv2(xt), jp.tderiv2(jnp.asarray(x)))
    elif piece == "plan2d":
        nx, ny = 48, 40
        f = rng.standard_normal((nx, ny))
        jp, tp = jfourier.FourierPlan2D(nx, ny), fourier.FourierPlan2D(nx, ny)
        kx = np.fft.fftfreq(nx, 1.0 / nx)[:, None]
        ky = np.fft.fftfreq(ny, 1.0 / ny)[None, :]
        sym = -1.0 / (1.0 + kx ** 2 + ky ** 2)
        ft = torch.as_tensor(f)
        _close(tp.solve_symbol(ft, torch.as_tensor(sym)),
               jp.solve_symbol(jnp.asarray(f), jnp.asarray(sym)))
        _close(tp.deriv_x(ft, torch.as_tensor(kx)),
               jp.deriv_x(jnp.asarray(f), jnp.asarray(kx)))
        _close(tp.deriv_y(ft, torch.as_tensor(ky)),
               jp.deriv_y(jnp.asarray(f), jnp.asarray(ky)))
    elif piece == "filter":
        x = rng.standard_normal((3, 64))
        for kind, kw in (("fraction", {"fraction": 0.6}),
                         ("rule 36", {"power": 36})):
            want = jfourier.SimpleFourierFilter(64, kind, **kw)(
                jnp.asarray(x))
            got = fourier.SimpleFourierFilter(64, kind, device="cpu", **kw)(
                torch.as_tensor(x))
            _close(got, want)
        with pytest.raises(ValueError):
            fourier.SimpleFourierFilter(64, "box", device="cpu")
    else:
        f = rng.standard_normal((40, 36))
        for name in ("fd_x_4", "fd_y_4", "fd_xx_4", "fd_yy_4"):
            _close(getattr(fd, name)(torch.as_tensor(f), 0.07),
                   getattr(jfd, name)(jnp.asarray(f), 0.07))


# ---------------------------------------------------------------------------
# interpolators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nx,ny,xo,sigma,w", [
    (40, 48, 0.0, 2, 16), (40, 49, np.pi / 40, 1.25, 24),
    (81, 96, 0.0, 2, 16), (81, 95, np.pi / 81, 1.25, 24)])
def test_periodic_interpolator_matches_ipde_tpu(nx, ny, xo, sigma, w):
    """Values, batched values, the grid-values entry and from_modes_grad on
    an even grid, an odd ny (half-spectrum path) and an odd nx (full ifft2
    path); on the odd grids the smooth field's mode (n - 1) / 2, which
    ipde_tpu misplaces, is below 1e-30."""
    rng = np.random.default_rng(nx + ny)
    f = _smooth_field(rng, nx, ny, B=2)
    T = 300
    tx = rng.uniform(0, 2 * np.pi, T)
    ty = rng.uniform(0, 2 * np.pi, T)
    jp = jinterp.PeriodicInterpolator2D(nx, ny, tx, ty, sigma=sigma, w=w,
                                        x_offset=xo)
    tp = interp.PeriodicInterpolator2D(nx, ny, tx, ty, sigma=sigma, w=w,
                                       x_offset=xo, device="cpu")
    c = np.fft.fft2(f)
    ct = torch.as_tensor(c)
    vals = tp.from_modes(ct)
    _close(vals, jp.from_modes(_cx(c)))
    _close(tp(torch.as_tensor(f)), jp(jnp.asarray(f)))
    grads = tp.from_modes_grad(ct)
    for got, want in zip(grads, jp.from_modes_grad(_cx(c))):
        assert got.shape == (2, T)
        _close(got, want)
    # one field: the first row of the batched results
    _close(tp.from_modes(ct[0]), vals[0], 1e-15)
    for one, many in zip(tp.from_modes_grad(ct[0]), grads):
        _close(one, many[0], 1e-15)


def test_periodic_interpolator_chunks_the_gather(monkeypatch):
    """A gather cut into many target chunks gives the same numbers."""
    rng = np.random.default_rng(4)
    f = torch.as_tensor(_smooth_field(rng, 40, 48, B=3))
    tx = rng.uniform(0, 2 * np.pi, 500)
    ty = rng.uniform(0, 2 * np.pi, 500)
    tp = interp.PeriodicInterpolator2D(40, 48, tx, ty, device="cpu")
    whole = tp.from_modes_grad(torch.fft.fft2(f))
    monkeypatch.setattr(interp.PeriodicInterpolator2D, "GATHER_MAX_ELEMS",
                        3 * 16 * 16 * 37)
    assert len(tp._chunks(3)) == 14
    for a, b in zip(tp.from_modes_grad(torch.fft.fft2(f)), whole):
        assert torch.equal(a, b)


@pytest.mark.parametrize("ny", [12, 13])
def test_pad_modes_half_matches_symmetric_upsampling(ny):
    """irfft2 of _pad_modes_half equals the canonical symmetric zero-pad
    upsampling (Nyquist lines split half/half) for a rough field, an even
    and an odd ny (tests/test_interp.py's oracle), and ipde_tpu's."""
    rng = np.random.default_rng(11)
    nx, nfx, nfy = 16, 40, 33
    F = np.fft.fft2(rng.standard_normal((nx, ny)))
    half = interp._pad_modes_half(torch.as_tensor(F), nx, ny, nfx, nfy)
    assert half.shape == (nfx // 2 + 1, nfy)
    want = jinterp._pad_modes_half(_cx(F), nx, ny, nfx, nfy)
    _close(half.real, want.re)
    _close(half.imag, want.im)
    got = torch.fft.irfft2(half.T, s=(nfy, nfx)).T.numpy()
    P = np.zeros((nfx, nfy), complex)
    fx = np.fft.fftfreq(nx, 1 / nx).astype(int)
    fy = np.fft.fftfreq(ny, 1 / ny).astype(int)
    for i, ki in enumerate(fx):
        for j, kj in enumerate(fy):
            ti = ([ki % nfx] if abs(ki) != nx // 2 or nx % 2
                  else [ki % nfx, (-ki) % nfx])
            tj = ([kj % nfy] if abs(kj) != ny // 2 or ny % 2
                  else [kj % nfy, (-kj) % nfy])
            for a in ti:
                for b in tj:
                    P[a, b] += F[i, j] / (len(ti) * len(tj))
    assert np.abs(got - np.fft.ifft2(P).real).max() < 1e-13


def test_odd_grid_matches_exact_sum():
    """A rough field on an odd grid: the port's window NUFFT (full ifft2
    path) and hybrid interpolator (odd ny) agree with the direct sum; those
    of ipde_tpu do not, by the mode (n - 1) / 2 they move."""
    rng = np.random.default_rng(5)
    nx, ny, T = 33, 41, 200
    f = rng.standard_normal((nx, ny))
    tx = rng.uniform(0, 2 * np.pi, T)
    ty = rng.uniform(0, 2 * np.pi, T)
    c = np.fft.fft2(f)
    exact = interp.nufft2d2_exact(torch.as_tensor(c), tx, ty).numpy()
    scale = np.abs(exact).max()
    for cls in ("PeriodicInterpolator2D", "HybridInterp2D"):
        got = getattr(interp, cls)(nx, ny, tx, ty, device="cpu").from_modes(
            torch.as_tensor(c)).numpy()
        ref = np.asarray(getattr(jinterp, cls)(nx, ny, tx, ty).from_modes(
            _cx(c)))
        assert np.abs(got - exact).max() / scale < 1e-12, cls
        assert np.abs(ref - exact).max() / scale > 1e-3, cls


def test_exact_sum_and_polynomial_interpolator():
    rng = np.random.default_rng(6)
    c = np.fft.fft2(_smooth_field(rng, 24, 30))
    tx = rng.uniform(0, 2 * np.pi, 90)
    ty = rng.uniform(0, 2 * np.pi, 90)
    _close(interp.nufft2d2_exact(torch.as_tensor(c), tx, ty),
           jinterp.nufft2d2_exact(_cx(c), tx, ty))
    f = rng.standard_normal((40, 36))
    for order in (3, 5, 7):
        args = (-1.0, -0.8, 0.05, 0.045, 40, 36, rng.uniform(-1, 1, 80),
                rng.uniform(-0.8, 0.8, 80))
        _close(interp.PolyInterpolator2D(*args, order=order, device="cpu")(
            torch.as_tensor(f)),
            jinterp.PolyInterpolator2D(*args, order=order)(jnp.asarray(f)))


def test_make_interpolator_routes_tier2_interface():
    """Bench tier 2's interface plan, from its sizes: star(2700, a=0.2,
    f=5), M = 20, a box of about 2048 x 2048 (bench.py:63-71 at
    grid_target 2048), 2,700 interface targets, goes to the wide-window
    PeriodicInterpolator2D in both packages' routing (T * max(nx, ny) =
    5.5e6 > 2^21 rules out the exact path)."""
    rng = np.random.default_rng(7)
    nx = ny = 2048
    tx = rng.uniform(0, 2 * np.pi, 2700)
    ty = rng.uniform(0, 2 * np.pi, 2700)
    got = interp.make_interpolator(nx, ny, tx, ty, device="cpu")
    assert isinstance(got, interp.PeriodicInterpolator2D)
    assert (got.w, got.plan.nfx, got.plan.nfy) == (24, 2560, 2560)


# ---------------------------------------------------------------------------
# collection calculus
# ---------------------------------------------------------------------------

F = lambda x, y: np.exp(np.sin(x)) * np.sin(2 * y)  # noqa: E731


STAR = (tt.body(NB, M, a=0.1, f=3),)


def _star_collection(pad_quantum=None):
    return tt.paired_collections(STAR, tt.one_body_h(STAR[0]), pad_quantum)


@pytest.fixture(scope="module")
def calc():
    jc, tc = _star_collection()
    return jc, tc, JEF.from_function(jc, F), EmbeddedFunction.from_function(
        tc, F)


def _close_ef(got, want, phys, rtol=1e-12):
    scale = max(np.abs(np.asarray(want.grid))[phys].max(),
                *(np.abs(np.asarray(r)).max() for r in want.radials))
    gap = np.abs(got.grid.numpy() - np.asarray(want.grid))[phys].max()
    for a, b in zip(got.radials, want.radials):
        gap = max(gap, np.abs(a.numpy() - np.asarray(b)).max())
    assert gap < rtol * scale, gap / scale


@pytest.mark.parametrize("derivative_type", ["spectral", "fourth"])
def test_gradient_and_laplacian(calc, derivative_type):
    jc, tc, jf, tf = calc
    for got, want in zip(tc.gradient(tf, derivative_type),
                         jc.gradient(jf, derivative_type)):
        _close_ef(got, want, jc.phys)
    _close_ef(tc.laplacian(tf, derivative_type),
              jc.laplacian(jf, derivative_type), jc.phys)
    with pytest.raises(ValueError):
        tc.gradient(tf, "second")


def test_collection_interpolation_and_integral(calc):
    jc, tc, jf, tf = calc
    g = jc.grid
    f = (np.sin((g.xg - g.x_bounds[0]) / g.x_period * 2 * np.pi)
         * np.cos(2 * (g.yg - g.y_bounds[0]) / g.y_period * 2 * np.pi))
    _close(tc.interpolate_grid_to_radial(f, order=5)[0],
           jc.interpolate_grid_to_radial(f, order=5)[0])
    _close(tc.interpolate_radial_to_boundary(tf.radials)[0],
           jc.interpolate_radial_to_boundary(jf.radials)[0])
    _close(tc.interpolate_grid_to_interface(torch.as_tensor(f)),
           jc.interpolate_grid_to_interface(jnp.asarray(f)))
    c = np.fft.fft2(f)
    _close(tc.interpolate_grid_to_interface_modes(torch.as_tensor(c)),
           jc.interpolate_grid_to_interface_modes(_cx(c)))
    # a positive integrand (sin(2y) integrates to about 0)
    ef = jf * jf + 1.0
    got = tc.volume_integral(tf * tf + 1.0)
    assert abs(got - jc.volume_integral(ef)) < 1e-13 * abs(got)


# ---------------------------------------------------------------------------
# pad_quantum
# ---------------------------------------------------------------------------

def test_padded_plans_match_ipde_tpu():
    """Padded plan arrays and shapes equal ipde_tpu's (the arrays a saved
    and compared plan carries)."""
    jc, tc = _star_collection(pad_quantum=256)
    for name in ("pna_flat", "pna_x", "pna_y"):
        a, b = getattr(jc, name), getattr(tc, name)
        assert a.shape == b.shape and np.array_equal(a, b), name
    assert tc.pna_flat.size % 256 == 0
    # the device copy: ipde_tpu's, then the sentinel up to a capacity
    # that a turned boundary keeps (a multiple of the quantum)
    n = jc.pna_flat_dev.shape[0]
    assert np.array_equal(tc.pna_flat_dev[:n].numpy(),
                          np.asarray(jc.pna_flat_dev))
    assert tc.pna_flat_dev.shape[0] % 256 == 0
    assert (tc.pna_flat_dev[n:] == tc.grid.Nx * tc.grid.Ny).all()
    for a, b in zip(jc.ia_flat_list, tc.ia_flat_list):
        assert a.shape == b.shape
        assert np.array_equal(np.asarray(a), b.numpy())


def test_padded_solves_match_unpadded():
    """A padded ModifiedHelmholtzSolver + NeumannBIE solve (fft backend) and
    a padded Poisson solve_dirichlet (dense backend: the kernel's values
    are scattered over the padded pna set) equal the unpadded ones."""
    sol = lambda x, y: np.sin(x) * np.cos(y)  # noqa: E731
    frc = lambda x, y: -2.0 * np.sin(x) * np.cos(y)  # noqa: E731
    outs = []
    for pq in (None, 512):
        _, tc = _star_collection(pad_quantum=pq)
        ms = ModifiedHelmholtzSolver(tc, k=20.0)
        f = EmbeddedFunction.from_function(tc, sol)
        zero = BoundaryFunction([torch.zeros(e.bdy.N, dtype=torch.float64)
                                 for e in tc])
        mh = NeumannBIE(ms).apply_bc(ms(f * 400.0), zero)
        ps = PoissonSolver(tc, grid_backend="dense")
        po = solve_dirichlet(ps, EmbeddedFunction.from_function(tc, frc),
                             BoundaryFunction.from_function(tc, sol),
                             tol=1e-13)
        outs.append((mh, po, tc.phys))
    (mh0, po0, phys), (mh1, po1, _) = outs
    for a, b in ((mh1, mh0), (po1, po0)):
        assert (a.grid - b.grid).abs().numpy()[phys].max() < 1e-13
        assert (a.radials[0] - b.radials[0]).abs().max() < 1e-13
