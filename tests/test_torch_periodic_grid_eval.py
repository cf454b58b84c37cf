"""The port's PeriodicGridEvaluator (Laplace with the k = 0 mode pinned and
the neutralizing background; Yukawa with the untruncated screened symbol)
against ipde_tpu's and against independent sums, on the 128 x 128 box of
[0, 2 pi]^2 of tests/test_periodic_grid_eval.py, and the port's expint_e1
against ipde_tpu's.

One source set serves both comparisons: 24 sources at least 1.2 from every
edge (farther than the near-correction radius r_cut = 22 h ~ 1.08) and 8
within r_cut of an edge or a corner.  The evaluators are linear in the
charges: with the edge charges zero, ipde_tpu is right and the port must
agree with it to 1e-12; with all charges, ipde_tpu drops the part of the
near correction that wraps across the box edge (it adds the patches on a
margin-padded grid and crops the margin, ipde_tpu/ops/grid_eval.py:826-850)
and is off by ~1e-3, while the port (patch cells taken mod (Nx, Ny)) stays
within 1e-9 of the independent sums: an Ewald sum with another splitting
parameter (Laplace) and the free-space kernel over 5 x 5 image shifts
(Yukawa, exact to e^{-kappa L} at kappa = 4), at grid points farther than
6 h from every source on the torus.  Marker ``gpu``: the evaluator on the
card against the mh_slp kernel's image sum, skipped with a reason where
torch sees no CUDA device."""

import numpy as np
import pytest
import torch
from scipy.special import exp1, k0 as K0

import jax.numpy as jnp
from _torch_testing import one_torch_thread  # noqa: F401
from ipde_tpu.geometry.grid import Grid as JGrid
from ipde_tpu.ops.grid_eval import PeriodicGridEvaluator as JPGE
from ipde_tpu.ops.kernels import expint_e1 as jexpint_e1
from ipde_tpu_torch.geometry.grid import Grid
from ipde_tpu_torch.ops import grid_eval
from ipde_tpu_torch.ops.grid_eval import PeriodicGridEvaluator
from ipde_tpu_torch.ops.kernels import expint_e1

L = 2 * np.pi
N = 128
H = L / N
KAPPA = 4.0


def _sources():
    """(sx, sy, q with the edge charges zero, q with all charges): 24
    sources 1.2 or more from every edge, then 8 within r_cut of one (two
    near corners), non-neutral charges."""
    rng = np.random.default_rng(0)
    sx = np.r_[rng.uniform(1.2, 5.0, 24),
               0.3, 6.1, 3.0, 3.4, 0.2, 6.2, 0.5, 1.5]
    sy = np.r_[rng.uniform(1.2, 5.0, 24),
               3.0, 2.0, 0.25, 6.0, 0.15, 6.15, 6.0, 0.9]
    q = rng.standard_normal(32)
    return sx, sy, np.r_[q[:24], np.zeros(8)], q


def _targets(sx, sy, n=240):
    """About n grid indices (i, j) farther than 6 h from every source on
    the torus."""
    i, j = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    i, j = i.ravel(), j.ravel()
    dx = np.abs(i[:, None] * H - sx)
    dy = np.abs(j[:, None] * H - sy)
    d2 = (np.minimum(dx, L - dx) ** 2 + np.minimum(dy, L - dy) ** 2).min(1)
    keep = np.flatnonzero(d2 > (6 * H) ** 2)
    keep = keep[:: max(1, keep.size // n)]
    return i[keep], j[keep]


def _ewald_laplace(tx, ty, sx, sy, q, eta=1.3, nk=18, nimg=3):
    """Zero-mean periodic Laplace potential with the neutralizing
    background: real-space images with scipy exp1 + the k-lattice sum +
    the background constant, another eta than the evaluator's."""
    A = L * L
    out = np.zeros_like(tx)
    for mx in range(-nimg, nimg + 1):
        for my in range(-nimg, nimg + 1):
            dx = tx[:, None] - sx[None, :] + mx * L
            dy = ty[:, None] - sy[None, :] + my * L
            out += (exp1(eta**2 * (dx * dx + dy * dy)) / (4 * np.pi)) @ q
    ks = np.arange(-nk, nk + 1) * (2 * np.pi / L)
    for kx in ks:
        for ky in ks:
            k2 = kx * kx + ky * ky
            if k2 == 0:
                continue
            rho = (q * np.exp(-1j * (kx * sx + ky * sy))).sum()
            out += (np.exp(-k2 / (4 * eta**2)) / k2 / A
                    * (rho * np.exp(1j * (kx * tx + ky * ty)))).real
    return out - q.sum() / (4 * eta**2 * A)


def _yukawa_images(tx, ty, sx, sy, q, nimg=2):
    out = np.zeros_like(tx)
    for mx in range(-nimg, nimg + 1):
        for my in range(-nimg, nimg + 1):
            dx = tx[:, None] - sx[None, :] + mx * L
            dy = ty[:, None] - sy[None, :] + my * L
            out += (K0(KAPPA * np.hypot(dx, dy)) / (2 * np.pi)) @ q
    return out


@pytest.fixture(scope="module", params=["laplace", "yukawa"])
def evaluators(request):
    """Both packages' evaluators of one kernel on the same sources, and
    their fields for the two charge vectors."""
    kernel = request.param
    sx, sy, q_in, q_all = _sources()
    jev = JPGE(JGrid((0.0, L), N, (0.0, L), N), sx, sy, kernel=kernel,
               kappa=KAPPA)
    tev = PeriodicGridEvaluator(Grid((0.0, L), N, (0.0, L), N), sx, sy,
                                kernel=kernel, kappa=KAPPA, device="cpu")
    out = {"kernel": kernel, "src": (sx, sy), "tev": tev}
    for tag, q in (("in", q_in), ("all", q_all)):
        out["q_" + tag] = q
        out["j_" + tag] = np.asarray(jev(jnp.asarray(q)))
        out["t_" + tag] = tev(torch.as_tensor(q)).numpy()
    # the port's evaluator built with ipde_tpu's E1 (a reference fault, see
    # test_expint_e1_matches_ipde_tpu): everything else must agree to 1e-12
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(grid_eval, "expint_e1", lambda x: torch.as_tensor(
            np.array(jexpint_e1(jnp.asarray(x.numpy())))))
        tev_j = PeriodicGridEvaluator(Grid((0.0, L), N, (0.0, L), N), sx,
                                      sy, kernel=kernel, kappa=KAPPA,
                                      device="cpu")
    out["tj_in"] = tev_j(torch.as_tensor(q_in)).numpy()
    return out


def _want(ev, q, i, j):
    sx, sy = ev["src"]
    fn = _ewald_laplace if ev["kernel"] == "laplace" else _yukawa_images
    return fn(i * H, j * H, sx, sy, q)


def test_unpadded_periodic_box(evaluators):
    tev = evaluators["tev"]
    assert (tev.Px, tev.Py) == (N, N)
    assert (tev.sx_cells, tev.sy_cells) == (0, 0)
    assert tev.spread_shape == (N, N)
    assert tev.mean_shift == (1.0 / (4 * tev.eta**2 * L * L)
                              if evaluators["kernel"] == "laplace" else 0.0)


def test_matches_ipde_tpu_away_from_the_edges(evaluators):
    """Charges only on the sources whose patches stay inside the box: the
    two packages agree at every grid point (the port with ipde_tpu's E1;
    with its own, by the Laplace near correction's share of ipde_tpu's E1
    fault), and both with the independent sum."""
    got, want = evaluators["t_in"], evaluators["j_in"]
    assert got.shape == want.shape == (N, N)
    assert np.abs(evaluators["tj_in"] - want).max() <= 1e-12
    gap = np.abs(got - want).max()
    print(f"{evaluators['kernel']}: port - ipde_tpu {gap:.3e}")
    if evaluators["kernel"] == "yukawa":
        assert gap <= 1e-12
    i, j = _targets(*evaluators["src"])
    ref = _want(evaluators, evaluators["q_in"], i, j)
    assert np.abs(got[i, j] - ref).max() <= 1e-9
    assert np.abs(want[i, j] - ref).max() <= 1e-9


def test_sources_near_an_edge(evaluators):
    """All charges, eight sources within r_cut of an edge or a corner: the
    port within 1e-9 of the independent sum; ipde_tpu off by more than
    1e-4 there (the wrapped near corrections it drops)."""
    i, j = _targets(*evaluators["src"])
    ref = _want(evaluators, evaluators["q_all"], i, j)
    port_err = np.abs(evaluators["t_all"][i, j] - ref).max()
    ipde_err = np.abs(evaluators["j_all"][i, j] - ref).max()
    print(f"{evaluators['kernel']}: port {port_err:.3e}, ipde_tpu "
          f"{ipde_err:.3e} from the independent sum")
    assert port_err <= 1e-9
    assert ipde_err > 1e-4


def test_expint_e1_matches_ipde_tpu():
    """The port's E1 is within 1e-14 of scipy's exp1 on [1e-8, 44].
    ipde_tpu's is a reference fault above x = 1: its degree-48 Chebyshev fit
    on [1, 44] is 2.03e-8 off exp1 at x = 1.045, so the port is held to
    ipde_tpu's within 3e-8 there and within 1e-14 below 1, where both sum
    the power series."""
    x = np.geomspace(1e-8, 44.0, 4001)
    got = expint_e1(torch.as_tensor(x)).numpy()
    want = np.asarray(jexpint_e1(jnp.asarray(x)))
    gap = np.abs(got / want - 1.0)
    assert gap[x < 1.0].max() <= 1e-14
    assert gap.max() <= 3e-8
    dist = np.abs(got / exp1(x) - 1.0)
    ref_dist = np.abs(want / exp1(x) - 1.0)
    print(f"expint_e1 vs scipy exp1: port {dist.max():.3e}, ipde_tpu "
          f"{ref_dist.max():.3e} relative")
    assert dist.max() <= 1e-14


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["laplace", "yukawa"])
def test_on_cuda_matches_cpu(kernel):
    """The evaluator on the card against the CPU, all charges; the Yukawa
    field also against the mh_slp kernel's sum over 3 x 3 image-shifted
    sources at the spot points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    from ipde_tpu_torch.ops import kernels as K
    sx, sy, _, q = _sources()
    out = {}
    for d in ("cpu", "cuda"):
        ev = PeriodicGridEvaluator(Grid((0.0, L), N, (0.0, L), N), sx, sy,
                                   kernel=kernel, kappa=KAPPA, device=d)
        out[d] = ev(torch.as_tensor(q, device=d)).cpu().numpy()
    assert np.abs(out["cuda"] - out["cpu"]).max() <= 1e-12
    if kernel == "yukawa":
        i, j = _targets(sx, sy)
        shifts = [(mx * L, my * L) for mx in (-1, 0, 1) for my in (-1, 0, 1)]
        t = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
        img = K.mh_slp_apply(t(np.concatenate([sx + a for a, _ in shifts])),
                             t(np.concatenate([sy + b for _, b in shifts])),
                             t(np.tile(q, 9)), t(i * H), t(j * H), KAPPA)
        assert np.abs(out["cuda"][i, j] - img.cpu().numpy()).max() <= 1e-9
