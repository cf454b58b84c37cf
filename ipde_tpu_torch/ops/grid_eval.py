"""Free-space layer-potential evaluation on ALL grid points via FFT.

The dense O(T*S) kernel sum is replaced, for uniform-grid targets, by a
Vico-Greengard truncated-Green's-function convolution on a padded grid plus
exact local corrections near the sources:

    phi(x) = ifft2( Ghat_L(k) * rho_hat(k) ) / A
           + sum_{|x - s_j| < r_cut} [G(x - s_j) - T(x - s_j)] q_j

where rho_hat is the type-1 (spreading) NUFFT of the point sources, Ghat_L
the analytic Fourier transform of the radially TRUNCATED kernel (exact
free-space convolution for all distances < L: no periodic images), and T the
band-limited kernel the FFT applies (a radial function, tabulated once from a
1D Hankel quadrature).

The port of ipde_tpu.ops.grid_eval (FreespaceGridEvaluator,
PeriodicGridEvaluator, the periodic-box Ewald counterpart on the unpadded
box, and StokesFreespaceGridEvaluator, with the same symbols, box, screen,
tables and corrections) on torch.  What ipde_tpu does only because of the
TPU is left behind: the spread is one ``torch.matmul`` (an ``index_add_``
scatter where the dense window factors would exceed SPREAD_MATMUL_MB; on the
card its FP64 atomics make that path's output differ in the last bits from
run to run, and no problem of chip_smoke.py or the tests reaches it: the
bench Stokes evaluator's factors take about 85 MB), the transforms are
torch.fft, and the near corrections are one sparse CSR matrix per evaluator,
built at setup from the masked patch values and applied as one sparse-dense
product (ipde_tpu adds per-source patches in a serial scan because scatter
is slow on the TPU).  Everything ipde_tpu reads from environment variables
is fixed at its default: matmul spread, deconvolution clip 1e-13, no patch
merge or pull path.

Reference analogue: the Ewald-style grid evaluators
(ipde/grid_evaluators/scalar_grid_evaluator.py:130-307,
laplace_grid_evaluator.py:21-33).
"""

from __future__ import annotations

import functools
import math
import warnings

import numpy as np
import torch
from scipy.special import j0, j1, jv, k0 as K0, k1 as K1

from ipde_tpu_torch.config import require_cuda
from ipde_tpu_torch.geometry.grid import Grid
from ipde_tpu_torch.ops.fourier import FourierPlan2D
from ipde_tpu_torch.ops.interp import _es_kernel
from ipde_tpu_torch.ops.kernels import expint_e1, k0_split
from ipde_tpu_torch.utils.planify import capacity
from ipde_tpu_torch.utils.profiling import spanned

# the spread runs as one matmul of dense window factors, S x (nzx + nzy)
# float64, up to this many MB; beyond it as an index_add_ scatter
SPREAD_MATMUL_MB = 384.0
# padded-spectrum modes whose window FT has decayed below this fraction of
# its peak carry no representable signal: their deconvolution is zeroed
# instead of inverted (1/(phx phy) would amplify transform roundoff into a
# global ~1e-9 velocity floor through the k-weighted Stokes symbols)
DECONV_CLIP = 1e-13
# the longest piece of a row of the near-correction matrix, and the quantum
# its row count of pieces is rounded up to: cuSPARSE's CSR product repeats
# bit for bit on rows of up to 192 entries and not on 256 and more (NVIDIA
# H100, tools/torch_csr_determinism.py; PERF.md, PR 12)
CSR_ROW_CHUNK = 128
CSR_ROW_QUANTUM = 4096


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(n: int, quantum: int) -> int:
    return _ceil_div(n, quantum) * quantum


def _most_within(x: torch.Tensor, y: torch.Tensor, r: float) -> int:
    """The most points of (x, y) within distance r of one of them, itself
    included: a count of pair distances, which turning the points leaves as
    it is."""
    best = x.new_zeros((), dtype=torch.int64)
    for s in range(0, x.numel(), 1024):
        d = torch.hypot(x[s:s + 1024, None] - x[None, :],
                        y[s:s + 1024, None] - y[None, :])
        best = torch.maximum(best, (d <= r).sum(1).max())
    return int(best)


# ---------------------------------------------------------------------------
# symbols (setup).  The closed Bessel formulas amplify J-roundoff at small z
# (numerators are O(z^2) term-wise but O(z^4) in sum for the biharmonic), so
# below z = _Z_SWITCH the symbols use cancellation-free q = (z/2)^2 power
# series; above it J comes from order-10 barycentric interpolation of host
# scipy tables, applied on the device (mul/add only, ~1e-16).
# ---------------------------------------------------------------------------

_JTAB_CACHE: dict = {}


def _bessel_j_tab(nu: int, zmax: float, device):
    """Cached order-10 uniform-node table evaluator of J_nu on [0, zmax
    rounded up to a multiple of 500], step 0.05: host scipy values, device
    barycentric apply."""
    b = max(1, int(np.ceil(zmax / 500.0)))
    key = (nu, b, torch.device(device))
    t = _JTAB_CACHE.get(key)
    if t is None:
        zm = 500.0 * b
        n = int(zm / 0.05) + 11
        zn = np.linspace(0.0, zm, n)
        t = _JTAB_CACHE.setdefault(
            key, RadialTableDev(zn, jv(nu, zn), order=10, device=device))
    return t


def _dev_j(nu: int, z: torch.Tensor) -> torch.Tensor:
    """J_nu(z) elementwise for a float64 tensor z >= 0, by the table."""
    return _bessel_j_tab(nu, float(z.max()), z.device)(z)


@functools.lru_cache(maxsize=1)
def _symbol_series_coeffs(nterms: int = 26):
    """Exact-rational small-z series coefficients (in q = z^2/4) for the
    Laplace and biharmonic truncated symbols (see the formulas below):
      laplace:    Ghat = L^2 [ sum aL[m] q^m  - log(L)/2 * sum bL[m] q^m ]
      biharmonic: Bhat = (L^4/64) [ (log L - 1) sum c1[m] q^m
                                    + sum c2[m] q^m ]
    """
    from fractions import Fraction as Fr
    f = math.factorial
    aL = [Fr((-1) ** j, 4 * f(j + 1) ** 2) for j in range(nterms)]
    bL = [Fr((-1) ** j, f(j) * f(j + 1)) for j in range(nterms)]
    c1 = [8 * Fr((-1) ** m) * (m + 1) / (f(m) * f(m + 2))
          for m in range(nterms)]
    c2 = []
    for mm in range(2, nterms + 2):
        v = (-4 * Fr((-1) ** mm, f(mm - 2) * f(mm))
             - 4 * Fr((-1) ** mm, f(mm) * f(mm))
             + 4 * Fr((-1) ** mm, f(mm - 1) * f(mm)))
        c2.append(v)
    tof = lambda cs: tuple(float(c) for c in cs)  # noqa: E731
    return tof(aL), tof(bL), tof(c1), tof(c2)


def _horner(coeffs, q):
    acc = torch.full_like(q, coeffs[-1])
    for c in coeffs[-2::-1]:
        acc = acc * q + c
    return acc


# the series/table switch (the docstrings of ipde_tpu say "below z = 8"; its
# code, and this, switch at 6)
_Z_SWITCH = 6.0


def laplace_truncated_symbol_dev(kk, L: float):
    """Ghat_L(k) = [(1 - J0(z)) - z log(L) J1(z)] / k^2, z = kL, on a
    float64 tensor (host twin: laplace_truncated_symbol); series below
    z = _Z_SWITCH, table J above."""
    kk = torch.as_tensor(kk, dtype=torch.float64)
    z = kk * L
    aL, bL, _, _ = _symbol_series_coeffs()
    q = 0.25 * z * z
    logL = math.log(L)
    small_val = L * L * (_horner(aL, q) - (logL / 2.0) * _horner(bL, q))
    ks = torch.where(kk > 0, kk, 1.0)
    zs = z.clamp(min=_Z_SWITCH)
    large_val = ((1.0 - _dev_j(0, zs)) - zs * logL * _dev_j(1, zs)) \
        / (ks * ks)
    return torch.where(z < _Z_SWITCH, small_val, large_val)


def yukawa_truncated_symbol_dev(kk, L: float, kappa: float):
    """The Yukawa truncated symbol of yukawa_truncated_symbol on a float64
    tensor, J by the table."""
    kk = torch.as_tensor(kk, dtype=torch.float64)
    z = kk * L
    k0L = float(K0(kappa * L))
    k1L = float(K1(kappa * L))
    return ((1.0 + z * _dev_j(1, z) * k0L
             - kappa * L * _dev_j(0, z) * k1L) / (kk**2 + kappa**2))


def biharmonic_truncated_symbol_dev(kk, L: float):
    """Bhat_L(k) on a float64 tensor (host twin:
    biharmonic_truncated_symbol); series below z = _Z_SWITCH (the closed form
    loses ~8 digits there to cancellation), table J above."""
    kk = torch.as_tensor(kk, dtype=torch.float64)
    z = kk * L
    _, _, c1, c2 = _symbol_series_coeffs()
    q = 0.25 * z * z
    logL = math.log(L)
    small_val = (L**4 / 64.0) * ((logL - 1.0) * _horner(c1, q)
                                 + _horner(c2, q))
    ks = torch.where(kk > 0, kk, 1.0)
    zs = z.clamp(min=_Z_SWITCH)
    J0z, J1z, J2z = _dev_j(0, zs), _dev_j(1, zs), _dev_j(2, zs)
    large_val = ((logL - 1.0) * (zs**3 * J1z - 2.0 * zs**2 * J2z)
                 - zs**2 * J2z + 4.0 * (1.0 - J0z) - 2.0 * zs * J1z) \
        / (4.0 * ks**4)
    return torch.where(z < _Z_SWITCH, small_val, large_val)


def laplace_truncated_symbol(kk: np.ndarray, L: float) -> np.ndarray:
    """FT of G_L = -log(r)/(2pi) * 1_{r<L}:
    Ghat_L(k) = [(1 - J0(kL)) - kL log(L) J1(kL)] / k^2, k != 0;
    Ghat_L(0) = -(L^2/2)(log L - 1/2)."""
    kk = np.asarray(kk, np.float64)
    out = np.empty_like(kk)
    nz = kk > 0
    z = kk[nz] * L
    out[nz] = ((1.0 - j0(z)) - z * np.log(L) * j1(z)) / kk[nz] ** 2
    out[~nz] = -(L**2 / 2.0) * (np.log(L) - 0.5)
    return out


def yukawa_truncated_symbol(kk: np.ndarray, L: float,
                            kappa: float) -> np.ndarray:
    """FT of G_L = K0(kappa r)/(2pi) * 1_{r<L} (Lommel integral):
    Ghat_L(k) = [1 + kL J1(kL) K0(kappa L)
                   - kappa L J0(kL) K1(kappa L)] / (k^2 + kappa^2)."""
    z = kk * L
    return ((1.0 + z * j1(z) * K0(kappa * L)
             - kappa * L * j0(z) * K1(kappa * L)) / (kk**2 + kappa**2))


def biharmonic_truncated_symbol(kk: np.ndarray, L: float) -> np.ndarray:
    """FT of B_L = r^2 (log r - 1)/(8 pi) * 1_{r<L}  (2D biharmonic Green's
    function, lap^2 B = delta).  With z = kL:

      Bhat_L(k) = [(log L - 1)(z^3 J1(z) - 2 z^2 J2(z)) - z^2 J2(z)
                   + 4 (1 - J0(z)) - 2 z J1(z)] / (4 k^4)
      Bhat_L(0) = L^4 (4 log L - 5) / 64.

    The Stokeslet's truncated symbol follows as
    Ghat_ij = (delta_ij k^2 - k_i k_j) Bhat_L, since
    G = (grad grad - delta lap) B."""
    kk = np.asarray(kk, np.float64)
    out = np.empty_like(kk)
    nz = kk > 0
    z = kk[nz] * L
    J0z, J1z, J2z = j0(z), j1(z), jv(2, z)
    out[nz] = ((np.log(L) - 1.0) * (z**3 * J1z - 2.0 * z**2 * J2z)
               - z**2 * J2z + 4.0 * (1.0 - J0z) - 2.0 * z * J1z) \
        / (4.0 * kk[nz] ** 4)
    out[~nz] = L**4 * (4.0 * np.log(L) - 5.0) / 64.0
    return out


# ---------------------------------------------------------------------------
# radial tables of band-limited (screened) kernels
# ---------------------------------------------------------------------------

def _composite_gl(a: float, b: float, npanels: int, deg: int = 12):
    """Composite Gauss-Legendre nodes/weights on [a, b]."""
    xg, wg = np.polynomial.legendre.leggauss(deg)
    edges = np.linspace(a, b, npanels + 1)
    mid = 0.5 * (edges[:-1] + edges[1:])
    half = 0.5 * (edges[1] - edges[0])
    k = (mid[:, None] + half * xg[None, :]).ravel()
    w = np.broadcast_to(half * wg[None, :], (npanels, deg)).ravel()
    return k, w


class RadialTableDev:
    """T(r) tabulated on a uniform grid, evaluated on a tensor by order-p
    barycentric interpolation (second form, uniform-node weights
    (-1)^j C(p-1, j)): a gather and O(p) passes.  The table lives on
    ``device`` (default: where ``values`` lie)."""

    def __init__(self, r_nodes: np.ndarray, values, order: int = 8, *,
                 device=None):
        self.r0 = float(r_nodes[0])
        self.dr = float(r_nodes[1] - r_nodes[0])
        self.tab = torch.as_tensor(values, dtype=torch.float64, device=device)
        self.order = order
        from scipy.special import comb
        j = np.arange(order)
        self.lam = [float(v) for v in ((-1.0) ** j) * comb(order - 1, j)]

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        shape = r.shape
        r = r.reshape(-1)
        k = self.order
        half = (k - 1) // 2
        t = (r - self.r0) / self.dr
        j = (torch.floor(t).to(torch.int64) - half).clamp_(
            0, self.tab.shape[0] - k)
        tj = t - j
        tiny = t.new_tensor(1e-12)
        num = torch.zeros_like(t)
        den = torch.zeros_like(t)
        for i in range(k):
            d = tj - i
            # sign-preserving clamp: a point on a node gets weight ~1e12 x
            # the rest, reproducing the node value to ~1e-12 without an
            # exact-hit branch
            d = torch.where(d.abs() < 1e-12,
                            torch.where(d >= 0, tiny, -tiny), d)
            w = self.lam[i] / d
            num = num + w * self.tab[j + i]
            den = den + w
        return (num / den).reshape(shape)


_TABLE_CACHE: dict = {}


def _radial_hankel_tables_dev(symfn_dev, kmax: float, L_eff: float,
                              r_max: float, moments_dev, ntab: int = 2048,
                              cache_key: tuple = None, *, device):
    """Tables on [0, r_max] of (1/2pi) int_0^kmax sym(k) k * m(kr) dk for
    each moment m in ``moments_dev`` (callables of (k, r) tensors -> kernel
    values): the band-limited kernel is radial, so its values at the near
    offsets come from a 1D Hankel-type quadrature instead of a 2D NUFFT.
    The (ntab x K) moment contraction is a matmul on ``device``.

    cache_key: when given, the tables are memoized process-wide under
    (cache_key, kmax, L_eff, r_max, ntab, device): the truncation radius L
    is quantized (_setup_box), so the key repeats across moving-boundary
    steps and a rebuilt evaluator skips its dominant setup cost."""
    device = torch.device(device)
    if cache_key is not None:
        full_key = (cache_key, float(kmax), float(L_eff), float(r_max), ntab,
                    device)
        got = _TABLE_CACHE.get(full_key)
        if got is not None:
            return got
    # panels resolve both the symbol's 2pi/L oscillation and J's 2pi/r_max
    npanels = int(np.ceil(kmax * (L_eff + r_max) / (2.0 * np.pi))) + 64
    k, w = _composite_gl(0.0, kmax, npanels)
    kd = torch.as_tensor(k, device=device)
    base = symfn_dev(kd) * kd * torch.as_tensor(w, device=device) \
        / (2.0 * np.pi)
    r_nodes = np.linspace(0.0, r_max, ntab)
    rd = torch.as_tensor(r_nodes, device=device)
    # chunk rows so the (rows, K) intermediate stays modest
    chunk = max(1, (1 << 22) // max(k.size, 1))
    out = [RadialTableDev(r_nodes, torch.cat(
        [m(kd[None, :], rd[s:s + chunk, None]) @ base
         for s in range(0, ntab, chunk)])) for m in moments_dev]
    if cache_key is not None:
        _TABLE_CACHE[full_key] = out
    return out


def _m_j0_dev(k, r):
    return _dev_j(0, k * r)


def _m_j1_over_z_dev(k, r):
    """k^2 * J1(kr)/(kr), finite at r = 0 (-> k^2/2)."""
    z = k * r
    small = z < 1e-8
    zz = torch.where(small, 1.0, z)
    return k * k * torch.where(small, 0.5 - z * z / 16.0,
                               _dev_j(1, zz) / zz)


def _m_k2_j0_dev(k, r):
    return k * k * _dev_j(0, k * r)


class _EvaluatorBase:
    """Shared machinery: box/padding layout, spreading plan, window
    deconvolution, Gaussian screen, near-patch geometry and the sparse
    matrix of the near corrections.

    ``padded`` (a free-space evaluator of a collection registered with
    ``pad_quantum``): the spread block and the near-correction plan take
    capacities that a turned boundary keeps, bounds from the grid, the
    window, the patch size and the sources' pair distances, zero-filled
    past what is used (``_setup_spreading``, ``_set_patches``), so that
    ``replan`` of a rebuilt evaluator holds.  A geometry past a capacity
    keeps its own shape, counted as ``plan.capacity_overflow``.  Unpadded
    evaluators keep their exact shapes."""

    padded = False

    # truncation margin between the farthest used pair distance and the
    # symbol's cutoff L, in units of h/pi: must exceed the Gaussian screen's
    # blur reach.  Tensor (Hasimoto-screened) kernels get a larger margin --
    # their complementary kernel carries eta^2-amplified polynomial factors.
    MARGIN_H = 60.0

    def _setup_box(self, grid: Grid, src_x, src_y, pad, target_bounds,
                   target_hull=None):
        self.grid = grid
        Nx, Ny = grid.Nx, grid.Ny
        hx, hy = grid.xh, grid.yh
        Lx, Ly = Nx * hx, Ny * hy
        # maximum USED-target-to-source distance.  target_hull (K, 2) gives
        # the exact extreme target points (e.g. convex hull of the physical
        # region); the bounding-box corners overestimate the Euclidean
        # distance by up to ~40% for star-shaped domains, often costing a
        # whole padding factor.
        if target_bounds is None:
            target_bounds = (grid.x_bounds, grid.y_bounds)
        (tx0, tx1), (ty0, ty1) = target_bounds
        if target_hull is not None:
            th = np.asarray(target_hull, np.float64)
            maxdist = float(np.hypot(th[:, None, 0] - src_x[None, :],
                                     th[:, None, 1] - src_y[None, :]).max())
        else:
            corners = [(tx0, ty0), (tx0, ty1), (tx1, ty0), (tx1, ty1)]
            maxdist = max(np.hypot(src_x - cx, src_y - cy).max()
                          for cx, cy in corners)
        # per-axis spans (aliasing is per image-shift direction: the nearest
        # image of s at t is offset by a full padded period along ONE axis,
        # so the pair distance is >= pad*Lx - |t_x - s_x|)
        span_x = max(tx1 - src_x.min(), src_x.max() - tx0)
        span_y = max(ty1 - src_y.min(), src_y.max() - ty0)
        # truncation radius must cover every pair WITH margin for the
        # Gaussian screen's blur width (several 1/eta), AND the nearest
        # periodic image pair must be beyond L plus the same blur margin:
        # pad_x*Lx >= L + span_x + margin (and same in y)
        marg = self.MARGIN_H * max(hx, hy) / np.pi
        # quantize the truncation radius UP in 1.5% relative steps: L only
        # needs to EXCEED every used pair distance, and a step-stable L
        # keys the radial-table cache across moving-boundary timesteps
        L = maxdist + marg
        L = float(np.exp(np.ceil(np.log(L) / 0.015) * 0.015))
        if pad is None:
            pad_x = max(int(np.ceil((L + span_x + marg) / Lx)), 2)
            pad_y = max(int(np.ceil((L + span_y + marg) / Ly)), 2)
        else:
            pad_x = pad_y = pad
        if (pad_x * Lx < L + span_x + marg - 1e-12
                or pad_y * Ly < L + span_y + marg - 1e-12):
            raise ValueError("padding insufficient to exclude periodic images")
        self.Px, self.Py = pad_x * Nx, pad_y * Ny
        self.L = L
        self.A = (pad_x * Lx) * (pad_y * Ly)
        # Gaussian screen width: kills the truncated symbol's Gibbs tail by
        # the lattice Nyquist (exp(-32.5) there); the complementary near
        # field is folded into the local corrections
        self.eta = np.pi / (11.4 * max(hx, hy))

    def _setup_spreading(self, src_x, src_y, w, wrap: bool = False):
        """The spreading plan of the (Px, Py) box.  Free space (``wrap``
        False): every source's window lies in the unpadded corner, so the
        padded box's origin is shifted instead of wrapping.  The spread
        array then has support only in a (nzx, nzy) prefix block (rounded up
        to multiples of 32): the forward transform zero-pads it
        (FourierPlan2D.rfft2), and the convolution's translation invariance
        moves the shift into the inverse transform's output window
        (irfft2_real_corner nx0/ny0).  Periodic (``wrap``): the windows wrap
        the torus, taken mod (Px, Py), and the spread array is the whole
        box."""
        grid, Px, Py = self.grid, self.Px, self.Py
        hx, hy = grid.xh, grid.yh
        dev = self.device
        beta = 2.30 * w
        half_w = w / 2.0
        gx = (src_x - grid.x_bounds[0]) / hx
        gy = (src_y - grid.y_bounds[0]) / hy
        jx = np.floor(gx).astype(np.int64) - (w // 2 - 1)
        jy = np.floor(gy).astype(np.int64) - (w // 2 - 1)
        px = jx[:, None] + np.arange(w)[None, :]
        py = jy[:, None] + np.arange(w)[None, :]
        wx = _es_kernel((gx[:, None] - px) / half_w, beta)
        wy = _es_kernel((gy[:, None] - py) / half_w, beta)
        if wrap:
            sx = sy = 0
            pxs, pys = np.mod(px, Px), np.mod(py, Py)
            nzx, nzy = Px, Py
        else:
            sx = int(max(0, -px.min()))
            sy = int(max(0, -py.min()))
            pxs = px + sx
            pys = py + sy
            nzx = int(pxs.max()) + 1
            nzy = int(pys.max()) + 1
            if nzx > Px or nzy > Py:
                raise ValueError("source windows exceed the padded box")
            nzx = min(Px, _round_up(nzx, 32))
            nzy = min(Py, _round_up(nzy, 32))
            if self.padded:
                # windows of sources within a cell of the grid reach at
                # most w cells past it, shifted or not
                nzx = capacity(nzx, min(Px, _round_up(grid.Nx + w, 32)))
                nzy = capacity(nzy, min(Py, _round_up(grid.Ny + w, 32)))
        self.sx_cells, self.sy_cells = sx, sy
        # the output window's rows and columns of the padded box, as
        # tensors: they move with the sources, and a replanned CUDA graph
        # must read them (utils/planify.py)
        self._window = (torch.arange(grid.Nx, device=dev) + sx,
                        torch.arange(grid.Ny, device=dev) + sy)
        self.spread_shape = (nzx, nzy)
        # the separable window factorizes the type-1 spread as
        #   spread[a, b] = sum_s (q_s Wx[s, a]) Wy[s, b] = Wx^T @ (q Wy)
        self._spread_mm = None
        if self.S * (nzx + nzy) * 8 / 2**20 <= SPREAD_MATMUL_MB:
            Wx = np.zeros((self.S, nzx))
            Wy = np.zeros((self.S, nzy))
            rows = np.arange(self.S)[:, None]
            np.add.at(Wx, (rows, pxs), wx)
            np.add.at(Wy, (rows, pys), wy)
            self._spread_mm = (torch.as_tensor(Wx, device=dev).T,
                               torch.as_tensor(Wy, device=dev))
        else:
            flat = pxs[:, :, None] * nzy + pys[:, None, :]
            self._spread_idx = torch.as_tensor(flat.reshape(-1), device=dev)
            self._spread_w = torch.as_tensor(
                (wx[:, :, None] * wy[:, None, :]).reshape(self.S, w * w),
                device=dev)
        # window deconvolution (continuous FT at the padded wavenumbers)
        kx = 2 * np.pi * np.fft.fftfreq(Px, hx)
        ky = 2 * np.pi * np.fft.fftfreq(Py, hy)
        xq, wq = np.polynomial.legendre.leggauss(max(200, 4 * w))
        ax, ay = half_w * hx, half_w * hy
        ker = _es_kernel(xq, beta)
        phx = (np.cos(np.outer(kx, ax * xq)) * (ker * ax * wq)).sum(1)
        phy = (np.cos(np.outer(ky, ay * xq)) * (ker * ay * wq)).sum(1)
        # the half spectrum keeps rows kx = 0..Px/2 (FourierPlan2D.rfft2);
        # the 2D symbol and deconvolution arrays are built on the device from
        # these 1D host vectors
        self.nkx = Px // 2 + 1
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        # (hx hy / (phx phy)) [type-1 deconv] / A [continuous FT norm]
        # * (Px Py) [the inverse transform divides by Px Py]
        deconv = (t(hx * hy / phx[: self.nkx])[:, None] / t(phy)[None, :]
                  / self.A * (Px * Py))
        ax_rel = np.abs(phx[: self.nkx]) / np.abs(phx).max()
        ay_rel = np.abs(phy) / np.abs(phy).max()
        keep = (t(ax_rel)[:, None] * t(ay_rel)[None, :]) >= DECONV_CLIP
        self.deconv_half = torch.where(keep, deconv, 0.0)
        self.kx_half = t(kx[: self.nkx])[:, None]
        self.ky_row = t(ky)[None, :]
        self.kk_half = torch.sqrt(self.kx_half ** 2 + self.ky_row ** 2)
        self.fft_plan = FourierPlan2D(Px, Py)

    def _spread(self, qs: torch.Tensor) -> torch.Tensor:
        """Spread the (B, S) source vectors: (B, nzx, nzy).  The matmul
        form takes all B in one product (stacked columns)."""
        B = qs.shape[0]
        nzx, nzy = self.spread_shape
        if self._spread_mm is not None:
            WxT, Wy = self._spread_mm
            rhs = torch.cat([q[:, None] * Wy for q in qs], dim=1)
            return (WxT @ rhs).reshape(nzx, B, nzy).transpose(0, 1)
        vals = (self._spread_w[None] * qs[:, :, None]).reshape(B, -1)
        out = torch.zeros(B, nzx * nzy, dtype=qs.dtype, device=qs.device)
        return out.index_add_(1, self._spread_idx, vals).reshape(B, nzx, nzy)

    def _patch_geometry(self, src_x, src_y, r_cut, wrap: bool = False):
        """Near-pair geometry on the device: every source gets one P x P
        patch of grid offsets around its nearest node; cells outside r_cut
        are masked.  Returns (S, P*P) offsets dx, dy (x varies slow, y
        fast), distances, mask, and the flat grid cell of each patch cell:
        -1 outside the grid, or with ``wrap`` (a periodic box) the cell
        taken mod (Nx, Ny), so that a source near an edge corrects the
        targets its patch reaches across it."""
        grid = self.grid
        hx, hy = grid.xh, grid.yh
        dev = self.device
        wc = int(np.ceil(r_cut / min(hx, hy))) + 1
        P = 2 * wc + 1
        self.patch_P = P
        self.margin = wc
        # analytic table bound: source-to-patch-cell distance is at most
        # (wc + 1/2) h per axis (sources live inside the grid)
        self.r_tab_max = float(np.hypot((wc + 1.0) * hx, (wc + 1.0) * hy))
        six = np.round((src_x - grid.x_bounds[0]) / hx).astype(int)
        siy = np.round((src_y - grid.y_bounds[0]) / hy).astype(int)
        if not wrap:
            six = np.clip(six, 0, grid.Nx - 1)
            siy = np.clip(siy, 0, grid.Ny - 1)
        loc = np.arange(P) - wc
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        if self.padded:
            # the sources whose patches reach one cell lie within 2 wc + 1
            # cells of each other on each axis; _patch_matrix parks a
            # block's entries off the grid on rows of their index mod Nx Ny
            self._row_bound = _most_within(
                t(src_x), t(src_y), (2 * wc + 1) * np.hypot(hx, hy)) \
                + _ceil_div(self.S * P * P, grid.Nx * grid.Ny)
        dx = t(six * hx + grid.x_bounds[0] - src_x)[:, None] \
            + t(loc * hx)[None, :]                    # (S, P)
        dy = t(siy * hy + grid.y_bounds[0] - src_y)[:, None] \
            + t(loc * hy)[None, :]
        dxf = dx.repeat_interleave(P, dim=1)          # (S, P*P), x slow
        dyf = dy.repeat(1, P)                         # (S, P*P), y fast
        rr = torch.sqrt(dxf ** 2 + dyf ** 2)
        mask = (rr <= r_cut) & (rr > 1e-13)
        cx = t(six[:, None] + loc[None, :]).repeat_interleave(P, dim=1)
        cy = t(siy[:, None] + loc[None, :]).repeat(1, P)
        if wrap:
            return dxf, dyf, rr, mask, (cx % grid.Nx) * grid.Ny + cy % grid.Ny
        inside = (cx >= 0) & (cx < grid.Nx) & (cy >= 0) & (cy < grid.Ny)
        return dxf, dyf, rr, mask, torch.where(inside, cx * grid.Ny + cy, -1)

    def _patch_matrix(self, cell, mask, blocks, n_out: int, n_in: int):
        """The near corrections as one CSR matrix (n_out Nx Ny, n_in S):
        block (o, i, vals) puts vals[s, c] (an (S, P*P) patch array) at row
        o Nx Ny + cell[s, c], column i S + s, where ``mask`` holds and the
        cell lies on the grid (``cell`` >= 0, see _patch_geometry), and an
        explicit zero everywhere else: at its own cell where the mask fails,
        at a row of its own index mod Nx Ny where the cell is off the grid
        (so that no row grows long).  The matrix thus has one entry per
        block and patch cell whatever the geometry (``utils/planify.py``'s
        ``replan`` copies a moved evaluator's matrix into a captured one of
        the same number of entries).  Entries of a row are ordered by
        column, so one sparse-dense product adds every patch in a fixed
        order.  Padded: ``_longest_row`` bounds a row's entries (the blocks
        of one output times ``_patch_geometry``'s bound for a block)."""
        nc = self.grid.Nx * self.grid.Ny
        keep = (mask & (cell >= 0)).reshape(-1)
        flat = cell.reshape(-1)
        cells = torch.where(flat >= 0, flat,
                            torch.arange(flat.numel(), device=self.device)
                            % nc)
        srcs = torch.arange(self.S, device=self.device)[:, None]\
            .expand_as(cell).reshape(-1)
        rows = torch.cat([o * nc + cells for o, _, _ in blocks])
        cols = torch.cat([i * self.S + srcs for _, i, _ in blocks])
        vals = torch.cat([torch.where(keep, v.reshape(-1), 0.0)
                          for _, _, v in blocks])
        order = torch.argsort(rows * (n_in * self.S) + cols, stable=True)
        rows, cols, vals = rows[order], cols[order], vals[order]
        crow = torch.zeros(n_out * nc + 1, dtype=torch.int64,
                           device=self.device)
        crow[1:] = torch.bincount(rows, minlength=n_out * nc).cumsum(0)
        idx = torch.int32 if vals.numel() < 2**31 else torch.int64
        if self.padded:
            self._longest_row = self._row_bound * max(
                sum(o == k for o, _, _ in blocks) for k in range(n_out))
        with warnings.catch_warnings():   # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_csr_tensor(
                crow.to(idx), cols.to(idx), vals,
                size=(n_out * nc, n_in * self.S), check_invariants=False)

    # -- the stages of one apply, in the order __call__ runs them ----------
    def _forward(self, qs: torch.Tensor) -> torch.Tensor:
        """Spread the (B, S) source vectors and transform: (B, Px, Py//2+1)
        half spectra."""
        return self.fft_plan.rfft2(self._spread(qs))

    def _inverse(self, c: torch.Tensor) -> torch.Tensor:
        """(n_out, Px, Py//2+1) spectra -> (n_out, Nx, Ny) grid fields."""
        return self.fft_plan.irfft2_real_window(c, *self._window)

    def _set_patches(self, A):
        """Keep the near-correction matrix A (``_patch_matrix``) and the
        plan that applies it with the same bits every run: cuSPARSE's CSR
        product does not repeat bit for bit once rows pass ~200 entries
        (tools/torch_csr_determinism.py), so each row is cut into pieces of
        at most CSR_ROW_CHUNK entries, the rows of a second CSR matrix over
        the same entries (``_patch_pieces``, its row count rounded up to
        CSR_ROW_QUANTUM so that a moved evaluator keeps its shape), and the
        pieces of a row are added in order through ``_patch_rows``, the
        (rows, most pieces) table of their indices (an absent piece points
        past the last, at a zero).  ``_patches`` gives A back from them.
        Padded, both take capacities that a turned boundary keeps: a piece
        for each row with entries plus one per CSR_ROW_CHUNK entries past
        them, and ``_longest_row`` / CSR_ROW_CHUNK pieces a row; the rows
        past the pieces are empty."""
        self._patch_crow = A.crow_indices()
        self._patch_shape = tuple(A.shape)
        crow = A.crow_indices().to(torch.int64)
        lens = crow.diff()
        pieces = (lens + CSR_ROW_CHUNK - 1) // CSR_ROW_CHUNK
        first = pieces.cumsum(0) - pieces          # a row's first piece
        rows_p = _round_up(max(int(pieces.sum()), 1), CSR_ROW_QUANTUM)
        width = max(int(pieces.max()), 1)
        if self.padded:
            nnz, filled = A._nnz(), min(A.shape[0], A._nnz())
            rows_p = capacity(rows_p, _round_up(
                filled + _ceil_div(nnz - filled, CSR_ROW_CHUNK),
                CSR_ROW_QUANTUM))
            width = capacity(width,
                             _ceil_div(self._longest_row, CSR_ROW_CHUNK))
        # each entry's piece: its row's first piece + its place in the row
        row_of = torch.repeat_interleave(torch.arange(lens.numel(),
                                                      device=crow.device),
                                         lens)
        place = torch.arange(A._nnz(), device=crow.device) - crow[row_of]
        piece = first[row_of] + place // CSR_ROW_CHUNK
        pcrow = torch.zeros(rows_p + 1, dtype=torch.int64, device=crow.device)
        pcrow[1:] = torch.bincount(piece, minlength=rows_p).cumsum(0)
        with warnings.catch_warnings():   # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            self._patch_pieces = torch.sparse_csr_tensor(
                pcrow.to(A.crow_indices().dtype), A.col_indices(),
                A.values(), size=(rows_p, A.shape[1]),
                check_invariants=False)
        k = torch.arange(width, device=crow.device)
        self._patch_rows = torch.where(k[None, :] < pieces[:, None],
                                       first[:, None] + k[None, :], rows_p)

    @property
    def _patches(self):
        """The near-correction matrix (``_patch_matrix``), on the entries
        ``_patch_pieces`` holds."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_csr_tensor(
                self._patch_crow, self._patch_pieces.col_indices(),
                self._patch_pieces.values(), size=self._patch_shape,
                check_invariants=False)

    def _apply_patches(self, fields: torch.Tensor,
                       q: torch.Tensor) -> torch.Tensor:
        """fields (n_out, Nx, Ny) plus the near corrections of the source
        vector q (n_in S,): ``_patches @ q``, summed piece by piece from
        the first (``_set_patches``), so that absent pieces past a row's
        last add zeros and leave its bits as they are."""
        y = self._patch_pieces @ q
        g = torch.cat([y, y.new_zeros(1)])[self._patch_rows]
        y = g[:, 0]
        for k in range(1, g.shape[1]):
            y = y + g[:, k]
        return fields + y.reshape(fields.shape)


class FreespaceGridEvaluator(_EvaluatorBase):
    """phi(grid) = sum_j G(x - s_j) q_j for fixed sources s_j inside the box.

    kernel: 'laplace' (G = -log r / 2pi) or 'yukawa' (G = K0(kappa r)/2pi).
    Returned values live on the full (Nx, Ny) grid, on ``device`` (None: the
    first CUDA card; raises without one).

    Structure: Vico-Greengard truncated-symbol convolution on a padded grid
    (exact free-space field for all pair distances < L), Gaussian-screened
    so the symbol is effectively band-limited, plus per-source local patches
    adding (exact kernel - band-limited kernel) at the static near offsets.
    The band-limited kernel is RADIAL, so the patch values come from a 1D
    Hankel-quadrature table (no 2D NUFFT in setup).
    """

    @spanned("setup.evaluators")
    def __init__(self, grid: Grid, src_x, src_y, kernel: str = "laplace",
                 kappa: float = 1.0, pad: int = None, w: int = 16,
                 r_cut_h: float = 22.0, target_bounds=None,
                 target_hull=None, *, device=None, padded: bool = False):
        """target_bounds: ((x0, x1), (y0, y1)) bounding box of the grid
        points whose values are actually USED (e.g. the physical region);
        target_hull: (K, 2) extreme target points (tighter truncation radius
        -> often one less padding factor -> 2x faster FFTs); padded: see
        _EvaluatorBase."""
        self.device = require_cuda() if device is None \
            else torch.device(device)
        self.padded = padded
        src_x = np.asarray(src_x, np.float64).ravel()
        src_y = np.asarray(src_y, np.float64).ravel()
        self.S = src_x.size
        self.kernel = kernel
        if kernel == "laplace":
            gfun = lambda r: -torch.log(r) / (2 * np.pi)  # noqa: E731
        elif kernel == "yukawa":
            gfun = lambda r: k0_split(  # noqa: E731
                kappa * r, r * r * (kappa * kappa / 4.0)) / (2 * np.pi)
        else:
            raise ValueError(kernel)
        self._setup_box(grid, src_x, src_y, pad, target_bounds, target_hull)
        self._setup_spreading(src_x, src_y, w)
        L, eta = self.L, self.eta
        if kernel == "laplace":
            symf = lambda k: (laplace_truncated_symbol_dev(k, L)  # noqa: E731
                              * torch.exp(-(k**2) / (4 * eta**2)))
        else:
            # exact Ewald screen for the Yukawa operator: the complementary
            # near part is then exponentially localized (a plain Gaussian
            # blur is exact only for HARMONIC kernels)
            kap2 = kappa**2
            symf = lambda k: (  # noqa: E731
                yukawa_truncated_symbol_dev(k, L, kappa)
                * torch.exp(-(k**2 + kap2) / (4 * eta**2)))
        self.mult = symf(self.kk_half) * self.deconv_half
        # ---- near corrections (radial table of the band-limited kernel) --
        hx, hy = grid.xh, grid.yh
        r_cut = r_cut_h * max(hx, hy)
        _, _, rr, mask, cell = self._patch_geometry(src_x, src_y, r_cut)
        kmax = 12.0 * eta
        (T,) = _radial_hankel_tables_dev(
            symf, kmax, L, self.r_tab_max, [_m_j0_dev],
            cache_key=("fs", kernel, float(kappa), float(eta)),
            device=self.device)
        rs = torch.where(mask, rr, 1.0)
        self._set_patches(self._patch_matrix(
            cell, mask, [(0, 0, torch.where(mask, gfun(rs) - T(rs), 0.0))],
            1, 1))

    def _multiply(self, F: torch.Tensor) -> torch.Tensor:
        """(1, ...) source spectrum -> (1, ...) potential spectrum."""
        return F * self.mult

    def __call__(self, q: torch.Tensor) -> torch.Tensor:
        """q: (S,) weighted charges -> (Nx, Ny) potential grid."""
        phi = self._inverse(self._multiply(self._forward(q[None])))
        return self._apply_patches(phi, q)[0]


class PeriodicGridEvaluator(_EvaluatorBase):
    """phi(grid) = sum over periodic images of G(x - s_j) q_j, the
    box-periodic counterpart of FreespaceGridEvaluator (ipde_tpu.ops.
    grid_eval.PeriodicGridEvaluator; reference:
    ipde/grid_evaluators/scalar_grid_evaluator.py:246-264).

    Ewald structure on the unpadded box (Px, Py = Nx, Ny; no _setup_box):
    the far field applies the continuous screened symbol on the periodic
    k-lattice (the periodic sum of the band-limited kernel T), the near
    correction adds (G - T)(r) at the near offsets.  G - T is
    Gaussian-localized (its reach, r_cut = r_cut_h h, is below half the
    box), so only the nearest image needs correcting: the windows and the
    patches wrap the torus, so a source within r_cut of an edge corrects
    the targets across it.

    Laplace: the k = 0 mode is pinned to zero; the result is the zero-mean
    periodic potential when sum(q) = 0, the neutralizing-background
    convention otherwise (``mean_shift``).  Yukawa: the untruncated screened
    symbol, k = 0 included.  Tensors on ``device`` (None: the first CUDA
    card; raises without one).
    """

    @spanned("setup.evaluators")
    def __init__(self, grid: Grid, src_x, src_y, kernel: str = "laplace",
                 kappa: float = 1.0, w: int = 16, r_cut_h: float = 22.0,
                 *, device=None):
        self.device = require_cuda() if device is None \
            else torch.device(device)
        src_x = np.asarray(src_x, np.float64).ravel()
        src_y = np.asarray(src_y, np.float64).ravel()
        self.S = src_x.size
        self.kernel = kernel
        self.grid = grid
        hx, hy = grid.xh, grid.yh
        self.Px, self.Py = grid.Nx, grid.Ny
        self.A = (grid.Nx * hx) * (grid.Ny * hy)
        self.eta = eta = np.pi / (11.4 * max(hx, hy))
        r_cut = r_cut_h * max(hx, hy)
        if 2 * r_cut > min(grid.Nx * hx, grid.Ny * hy):
            raise ValueError("near-correction radius exceeds half the box")
        if kernel not in ("laplace", "yukawa"):
            raise ValueError(kernel)
        self._setup_spreading(src_x, src_y, w, wrap=True)
        _, _, rr, mask, cell = self._patch_geometry(src_x, src_y, r_cut,
                                                    wrap=True)
        rs = torch.where(mask, rr, 1.0)
        if kernel == "laplace":
            # applied: e^{-k^2/4eta^2}/k^2 over k != 0.  Its complement
            # (1 - screen)/k^2 on the k != 0 lattice is, by Poisson
            # summation, sum_images Dc(|x + mL|) - Dc_hat(0)/A with
            # Dc(r) = E1(eta^2 r^2)/(4 pi) and Dc_hat(0) = 1/(4 eta^2);
            # images beyond the nearest are e^{-(eta L/2)^2} ~ 0
            def symf(k):
                nzk = torch.where(k > 0, k, 1.0)
                return torch.where(k > 0, torch.exp(-(k**2) / (4 * eta**2))
                                   / nzk**2, 0.0)
            corr = expint_e1(eta**2 * rs**2) / (4 * np.pi)
            self.mean_shift = 1.0 / (4 * eta**2 * self.A)
        else:
            # k = 0 is finite: the applied operator is the periodic sum of
            # the band-limited kernel T; correction (K0/2pi - T)(r) from the
            # 1D Hankel table of the untruncated symbol (L_eff = 0)
            kap2 = kappa**2

            def symf(k):
                return torch.exp(-(k**2 + kap2) / (4 * eta**2)) / (k**2 + kap2)
            (T,) = _radial_hankel_tables_dev(
                symf, 12.0 * eta, 0.0, self.r_tab_max, [_m_j0_dev],
                cache_key=("per-yukawa", float(kappa), float(eta)),
                device=self.device)
            corr = k0_split(kappa * rs, rs * rs * (kap2 / 4.0)) \
                / (2 * np.pi) - T(rs)
            self.mean_shift = 0.0
        self.mult = symf(self.kk_half) * self.deconv_half
        self._set_patches(self._patch_matrix(
            cell, mask, [(0, 0, torch.where(mask, corr, 0.0))], 1, 1))

    def __call__(self, q: torch.Tensor) -> torch.Tensor:
        """q: (S,) weighted charges -> (Nx, Ny) zero-mean periodic potential
        (laplace; exact when sum(q) = 0, neutralizing background otherwise)
        or periodic Yukawa potential."""
        phi = self._inverse(self._forward(q[None]) * self.mult)
        return self._apply_patches(phi, q)[0] - self.mean_shift * q.sum()


class StokesFreespaceGridEvaluator(_EvaluatorBase):
    """(u, v, p)(grid) from fixed Stokeslets: the Stokes analogue of
    FreespaceGridEvaluator (the reference evaluates this with an O(N) FMM,
    ipde/solvers/internals/stokes.py:26-35).

    Velocity symbol via the truncated biharmonic:
        uhat = Bhat_L ky (ky fx - kx fy),  vhat = -Bhat_L kx (ky fx - kx fy)
    (G = (grad grad - delta lap) B).  Pressure via the truncated Laplace
    symbol:  phat = -i (kx fx + ky fy) * Qhat_L,  Q = -G_lap.

    __call__(wfx, wfy) takes quadrature-weighted force components and
    returns (u, v, p) on the full grid, on ``device`` (None: the first CUDA
    card).
    """

    MARGIN_H = 80.0   # Hasimoto screen reaches further (see _EvaluatorBase)

    @spanned("setup.evaluators")
    def __init__(self, grid: Grid, src_x, src_y, pad: int = None, w: int = 16,
                 r_cut_h: float = 22.0, target_bounds=None, target_hull=None,
                 *, device=None, padded: bool = False):
        self.device = require_cuda() if device is None \
            else torch.device(device)
        self.padded = padded
        src_x = np.asarray(src_x, np.float64).ravel()
        src_y = np.asarray(src_y, np.float64).ravel()
        self.S = src_x.size
        self._setup_box(grid, src_x, src_y, pad, target_bounds, target_hull)
        self._setup_spreading(src_x, src_y, w)
        L, eta = self.L, self.eta
        # velocity screen: the Hasimoto/Ewald factor (1 + k^2/4eta^2) gauss.
        # A plain Gaussian leaves (1 - gauss) k_i k_j / k^4 terms that are
        # NON-smooth at k = 0 (algebraic ~1e-4 far-field tails); with the
        # Hasimoto factor every complementary term is entire in k and the
        # residual near field is Gaussian-localized (classical 2D spectral
        # Ewald for Stokes).
        screen_v = lambda k: ((1.0 + k**2 / (4 * eta**2))  # noqa: E731
                              * torch.exp(-(k**2) / (4 * eta**2)))
        screen = lambda k: torch.exp(-(k**2) / (4 * eta**2))  # noqa: E731
        bsym = lambda k: (biharmonic_truncated_symbol_dev(  # noqa: E731
            k, L) * screen_v(k))
        qsym = lambda k: (laplace_truncated_symbol_dev(  # noqa: E731
            k, L) * screen(k))
        self.multB = bsym(self.kk_half) * self.deconv_half
        self.multQ = qsym(self.kk_half) * self.deconv_half
        # ---- near corrections --------------------------------------------
        # The band-limited velocity kernel is derivatives of the RADIAL
        # band-limited biharmonic Bs:  T_xx = -(A2 dy^2 + A1 dx^2)/r^2,
        # T_xy = (A2 - A1) dx dy / r^2, T_yy = -(A2 dx^2 + A1 dy^2)/r^2 with
        # A1 = Bs'/r, A2 = Bs''; pressure T_pj = -Qs' d_j / r with Qs the
        # band-limited Q = -G_lap.
        hx, hy = grid.xh, grid.yh
        r_cut = r_cut_h * max(hx, hy)
        dx, dy, rr, mask, cell = self._patch_geometry(src_x, src_y, r_cut)
        kmax = 12.0 * eta
        # A1 = Bs'/r = -(1/2pi) int Bhat k^2 (J1(z)/z) k dk -> moment
        # _m_j1_over_z gives k^2 J1/z; Ta = (1/2pi) int Bhat k^3 J0;
        # A2 = Bs'' = -Ta + Tb where Tb = (1/2pi) int Bhat k^2 (J1/z) k dk
        Tb_t, Ta_t = _radial_hankel_tables_dev(
            bsym, kmax, L, self.r_tab_max, [_m_j1_over_z_dev, _m_k2_j0_dev],
            cache_key=("stokesB", float(eta)), device=self.device)
        (Qb_t,) = _radial_hankel_tables_dev(
            qsym, kmax, L, self.r_tab_max, [_m_j1_over_z_dev],
            cache_key=("stokesQ", float(eta)), device=self.device)
        rs = torch.where(mask, rr, 1.0)
        Tb = Tb_t(rs)
        A1 = -Tb
        A2 = -Ta_t(rs) + Tb
        # Qs'(r)/r table: -(1/2pi) int qsym k^2 (J1/z) k dk = -Qb;
        # T_pj = -Qs' d_j/r = +Qb * d_j
        Qb = Qb_t(rs)
        r2 = rs**2
        # Both the exact Stokeslet and the band-limited kernel are
        # radial-isotropic tensors K_ij = KA(r) delta_ij + KB(r) d_i d_j / r^2
        # (T_xx = -A2 + (A2 - A1) dx^2/r^2 via dy^2 = r^2 - dx^2), so the
        # correction is CA = G_A - T_A, CB2 = (G_B - T_B)/r^2 and CP
        # (pressure) per patch cell.
        #
        # Exact kernels (mu = 1 Stokeslet + its pressure).  The real-space
        # identity is G_ij = (grad grad - delta lap) B + delta_ij/(8 pi):
        # the constant comes from the distributional k=0 part of B's FT
        # (r^2 log r grows), so the FFT pipeline applies G - 1/(8 pi) on the
        # diagonal.  The corrections match that effective kernel and
        # __call__ adds sum(f)/(8 pi) back once.
        logr = torch.log(r2) * 0.5
        G_A = -logr / (4 * np.pi) - 1.0 / (8 * np.pi)   # delta_ij part
        G_B = 1.0 / (4 * np.pi)                          # d_i d_j / r^2 part
        T_A = -A2
        T_B = A2 - A1
        CA = G_A - T_A
        CB2 = (G_B - T_B) / r2
        CP = 1.0 / (2 * np.pi * r2) - Qb
        # rows (u, v, p), columns (wfx, wfy): u += (CA + CB2 dx^2) wfx
        # + CB2 dx dy wfy, v += CB2 dx dy wfx + (CA + CB2 dy^2) wfy,
        # p += CP (dx wfx + dy wfy)
        uv = CB2 * dx * dy
        self._set_patches(self._patch_matrix(
            cell, mask,
            [(0, 0, CA + CB2 * dx * dx), (0, 1, uv), (1, 0, uv),
             (1, 1, CA + CB2 * dy * dy), (2, 0, CP * dx), (2, 1, CP * dy)],
            3, 2))

    def _multiply(self, F: torch.Tensor) -> torch.Tensor:
        """(2, ...) force spectra (x, y) -> (3, ...) spectra of u, v, p."""
        Fx, Fy = F[0], F[1]
        kx, ky = self.kx_half, self.ky_row
        # w = Bhat (ky Fx - kx Fy);  u = ky w;  v = -kx w
        w = self.multB * (ky * Fx - kx * Fy)
        # p = ifft[-i (kx Fx + ky Fy) Qhat]
        s = kx * Fx + ky * Fy
        return torch.stack([ky * w, -kx * w,
                            torch.complex(self.multQ * s.imag,
                                          -self.multQ * s.real)])

    def __call__(self, wfx: torch.Tensor, wfy: torch.Tensor):
        """(S,) weighted force components -> (u, v, p) on the (Nx, Ny) grid."""
        uvp = self._inverse(self._multiply(
            self._forward(torch.stack([wfx, wfy]))))
        # restore the constant the (grad grad - delta lap) B form drops
        uvp[0] += wfx.sum() / (8 * np.pi)
        uvp[1] += wfy.sum() / (8 * np.pi)
        return tuple(self._apply_patches(uvp, torch.cat([wfx, wfy])))
