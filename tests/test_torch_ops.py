"""The port's FFT layer, exact interpolator and GMRES against ipde_tpu.

Inputs are made with numpy from a seed.  Tolerances are relative to the
largest value compared: 1e-13 unless stated, since both sides compute the
same sums in float64 with FFTs and matmuls that order them differently."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_testing import assert_close as _close
from _torch_testing import one_torch_thread  # noqa: F401
from ipde_tpu.ops import fourier as jfourier
from ipde_tpu.ops import interp as jinterp
from ipde_tpu.ops.cx import Cx
from ipde_tpu.ops.gmres import gmres as jgmres
from ipde_tpu_torch.ops import fourier, interp
from ipde_tpu_torch.ops.gmres import gmres
from ipde_tpu_torch.utils import profiling


def _cx(c: torch.Tensor):
    return Cx(jnp.asarray(c.real.numpy()), jnp.asarray(c.imag.numpy()))


def test_fft2_and_inverse():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((96, 64))
    jp, tp = jfourier.FourierPlan2D(96, 64), fourier.FourierPlan2D(96, 64)
    jc, tc = jp.fft2(jnp.asarray(x)), tp.fft2(torch.as_tensor(x))
    assert tc.dtype == torch.complex128
    _close(tc.real, jc.re)
    _close(tc.imag, jc.im)
    sym = 1.0 / (1.0 + np.arange(64)[None, :] ** 2 + np.arange(96)[:, None])
    _close(tp.ifft2_real(tc * torch.as_tensor(sym)),
           jp.ifft2_real(Cx(jc.re * sym, jc.im * sym)))


@pytest.mark.parametrize("n", [128, 513, 512])   # direct, odd, four-step
def test_tangential_plan(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((7, n))
    jtp, ttp = jfourier.make_tan_plan(n), fourier.make_tan_plan(n, "cpu")
    xt = torch.as_tensor(x)
    jc, tc = jfourier.tan_rfft(jnp.asarray(x), jtp), fourier.tan_rfft(xt, ttp)
    _close(tc.real, jc.re)
    _close(tc.imag, jc.im)
    _close(fourier.tan_irfft(tc, ttp), jfourier.tan_irfft(jc, jtp))
    # the derivative amplifies by up to n/2; its largest value is O(n)
    _close(fourier.tan_deriv(xt, ttp), jfourier.tan_deriv(jnp.asarray(x), jtp))


def test_frequency_helpers():
    assert np.array_equal(fourier.rfftfreq_np(9, 0.5),
                          jfourier.rfftfreq_np(9, 0.5))
    assert np.array_equal(fourier.fftfreq_np(8), jfourier.fftfreq_np(8))
    assert np.array_equal(fourier.spectral_diff_matrix_np(16, 1),
                          jfourier.spectral_diff_matrix_np(16, 1))


@pytest.fixture(scope="module")
def exact_pair():
    rng = np.random.default_rng(1)
    nx, ny, T = 16, 120, 900
    tx = rng.uniform(0, np.pi, T)
    ty = rng.uniform(0, 2 * np.pi, T)
    args = (nx, ny, tx, ty, np.pi / nx)
    f = rng.standard_normal((3, nx, ny))
    return (jinterp.ExactInterp2D(*args),
            interp.ExactInterp2D(*args, device="cpu"), f)


def test_exact_interp_values(exact_pair):
    j, t, f = exact_pair
    _close(t(torch.as_tensor(f)), j(jnp.asarray(f)))
    _close(t(torch.as_tensor(f[0])), j(jnp.asarray(f[0])))
    c = torch.fft.fft2(torch.as_tensor(f))
    _close(t.from_modes(c), j.from_modes(_cx(c)))
    _close(t.from_modes(c[1]), j.from_modes(_cx(c[1])))


def test_exact_interp_grad(exact_pair):
    j, t, f = exact_pair
    c = torch.fft.fft2(torch.as_tensor(f))
    for batch in (c, c[2]):
        for got, want in zip(t.from_modes_grad(batch),
                             j.from_modes_grad(_cx(batch))):
            _close(got, want)


def test_exact_interp_chunks_fields(exact_pair):
    """With a byte budget that fits two fields per chunk, the values and
    gradients of three fields equal the unchunked ones bit for bit."""
    _, t, f = exact_pair
    c = torch.fft.fft2(torch.as_tensor(f))
    whole = (t.from_modes(c), *t.from_modes_grad(c))
    chunked = copy.copy(t)
    chunked.max_temp_bytes = 2 * 16 * t.T * t.nx
    assert len(chunked._chunks(c)) == 2
    parts = (chunked.from_modes(c), *chunked.from_modes_grad(c))
    assert all(torch.equal(a, b) for a, b in zip(parts, whole))


@pytest.mark.parametrize("nx,ny,T", [
    (96, 96, 128),        # interface plan at the entry() size
    (16, 128, 957),       # radial plan at the entry() size
    (544, 576, 1200),     # interface plan at nb=1200, M=16
    (32, 1200, 25254),    # radial plan at nb=1200, M=16
    (32, 2000, 40000),    # many radial targets: hybrid window NUFFT
    (512, 512, 40000),    # box-sized target set: window NUFFT
    (1024, 1024, 10000),  # few targets on a big box: wide window NUFFT
])
def test_make_interpolator_routing(nx, ny, T):
    rng = np.random.default_rng(T)
    tx = rng.uniform(0, 2 * np.pi, T)
    ty = rng.uniform(0, 2 * np.pi, T)
    want = jinterp.make_interpolator(nx, ny, tx, ty)
    got = interp.make_interpolator(nx, ny, tx, ty, device="cpu")
    assert type(got).__name__ == type(want).__name__
    if isinstance(want, jinterp.PeriodicInterpolator2D):
        # the window NUFFT is ported: same window and fine grid
        assert got.w == want.w
        assert (got.plan.nfx, got.plan.nfy) == (want.plan.nfx, want.plan.nfy)


def _host_phases(t, k):
    ang = np.outer(t, k)
    return np.cos(ang) + 1j * np.sin(ang)


@pytest.mark.parametrize("n,M", [(121, 8), (64, 16)])   # odd and even n
def test_phase_matrix_against_numpy(n, M):
    """The device-built phases equal NumPy's cos and sin of the same outer
    product to 1e-15, with negative fftfreq wavenumbers, a Chebyshev
    reflection's offset pi / (2M) and repeated (padded) targets."""
    rng = np.random.default_rng(n)
    t = rng.uniform(0, 2 * np.pi, 700)
    t = np.concatenate([t, np.full(60, t[-1])]) - np.pi / (2 * M)
    k = np.fft.fftfreq(n, 1.0 / n)
    got = interp.phase_matrix(t, k, device="cpu")
    assert got.dtype == torch.complex128 and got.shape == (t.size, n)
    assert np.abs(got.numpy() - _host_phases(t, k)).max() <= 1e-15


def test_phase_entries_counter():
    """Each phase matrix a plan builds adds its T x n entries to
    ``interp.phase_entries`` inside ``recording()``, and nothing outside."""
    rng = np.random.default_rng(3)
    tx, ty = rng.uniform(0, 2 * np.pi, (2, 900))
    profiling.take()
    interp.ExactInterp2D(16, 120, tx, ty, np.pi / 16, device="cpu")
    assert profiling.take().counts == {}
    with profiling.recording():
        interp.ExactInterp2D(16, 120, tx, ty, np.pi / 16, device="cpu")
        assert profiling.take().counts == {"interp.phase_entries": 900 * 136}
        interp.HybridInterp2D(16, 256, tx, ty, x_offset=np.pi / 16,
                              device="cpu")
        assert profiling.take().counts == {"interp.phase_entries": 900 * 16}


@pytest.mark.gpu
def test_phase_matrix_on_card_radial_plan():
    """At Poisson nb=1200's radial-to-grid shape (32 x 1,200 modes, 26,624
    padded annulus targets) the card-built phases are within 4e-15 of
    NumPy's, and the plan's values within 1e-13 of the same plan with the
    NumPy-built phases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(26624)
    nx, ny, T, off = 32, 1200, 26624, np.pi / 32
    tx = rng.uniform(0, np.pi, T)
    ty = rng.uniform(0, 2 * np.pi, T)
    tx[-600:], ty[-600:] = tx[-601], ty[-601]    # padded slots repeat
    plan = interp.ExactInterp2D(nx, ny, tx, ty, off, device=dev)
    host = copy.copy(plan)
    host.EY = torch.as_tensor(
        _host_phases(ty, np.fft.fftfreq(ny, 1.0 / ny)), device=dev)
    host.EX = torch.as_tensor(
        _host_phases(tx - off, np.fft.fftfreq(nx, 1.0 / nx)), device=dev)
    for got, want in ((plan.EY, host.EY), (plan.EX, host.EX)):
        assert (got - want).abs().max().item() <= 4e-15
    c = torch.fft.fft2(torch.as_tensor(rng.standard_normal((3, nx, ny)),
                                       device=dev))
    _close(plan.from_modes(c), host.from_modes(c).cpu().numpy())


def _system(n=80, seed=2):
    rng = np.random.default_rng(seed)
    A = np.eye(n) * 4 + rng.standard_normal((n, n)) / np.sqrt(n)
    P = np.linalg.inv(np.diag(np.diag(A)) + np.triu(A, 1) * 0.5)
    b = rng.standard_normal(n)
    return A, P, b


def test_gmres_matches_reference_and_reports_true_residual():
    A, P, b = _system()
    At, Pt, bt = map(torch.as_tensor, (A, P, b))
    res = gmres(lambda v: At @ v, bt, precond=lambda v: Pt @ v, tol=1e-13,
                maxiter=60, restart=7)
    true = np.linalg.norm(b - A @ res.x.numpy()) / np.linalg.norm(b)
    # the residual is recomputed in float64: it agrees to roundoff of
    # ||A|| ||x|| / ||b|| ~ 1e-16, not to 12 digits of its own size
    assert res.residual == pytest.approx(true, rel=0, abs=1e-15)
    assert res.residual <= 1e-13
    jr = jgmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                precond=lambda v: jnp.asarray(P) @ v, tol=1e-13,
                maxiter=60, restart=7)
    assert res.iterations == int(jr.iterations)
    _close(res.x, jr.x, rtol=1e-12)
    _close(res.x, np.linalg.solve(A, b), rtol=1e-12)


def test_gmres_stops_at_maxiter_with_honest_residual():
    A, P, b = _system(seed=3)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    res = gmres(lambda v: At @ v, bt, tol=1e-14, maxiter=4, restart=2)
    assert res.iterations == 4
    true = np.linalg.norm(b - A @ res.x.numpy()) / np.linalg.norm(b)
    assert res.residual == pytest.approx(true, rel=0, abs=1e-15)
    assert true > 1e-6
    zero = gmres(lambda v: At @ v, torch.zeros_like(bt), tol=1e-14)
    assert zero.iterations == 0 and zero.residual == 0.0
