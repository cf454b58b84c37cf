// Native geometry kernel: near-curve search + Newton local coordinates.
//
// The boundary-fitted coordinate solve is the geometry-setup hot path (it
// reruns every timestep for moving boundaries; reference analogue: the
// numba-jitted near_finder package, SURVEY.md 2.2).  This C++ kernel does
// the full pipeline for uniform-grid queries:
//   1. stamp an upsampled polyline onto the grid with a disk of radius
//      (width + margin), recording the nearest node index per cell,
//   2. Newton-iterate g(t) = (p - c(t)) . c'(t) = 0 per candidate point,
//      with c, c', c'' evaluated from the curve's Fourier coefficients,
//   3. emit (ix, iy, t, r, converged) for points with |r| <= width.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC coords.cpp -o libcoords.so
// Exposed via ctypes (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <vector>
#include <algorithm>
#include <cstring>
#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct CurveEval {
    // Fourier series c(t) = sum_k (a_k + i b_k) e^{ikt} stored as packed
    // real coefficient arrays over k = 0..nk-1 (rfft layout), for x and y.
    const double *xc_re, *xc_im, *yc_re, *yc_im;
    int nk;      // n/2 + 1
    int n;       // sample count
    bool even;   // n even -> Nyquist entry gets half weight doubling rules

    inline void eval(double t, double &x, double &y, double &xp, double &yp,
                     double &xpp, double &ypp) const {
        // real signal: f(t) = (1/n)[ c_0 + 2 sum_{k=1}^{nk-2} Re(c_k e^{ikt})
        //                            + w Re(c_{nk-1} e^{i K t}) ]
        // with w = 1 for even n (Nyquist), 2 otherwise.
        double xs = xc_re[0], ys = yc_re[0];
        double xps = 0, yps = 0, xpps = 0, ypps = 0;
        double ct = std::cos(t), st = std::sin(t);
        double ck = 1.0, sk = 0.0;   // cos(kt), sin(kt) built by recurrence
        for (int k = 1; k < nk; ++k) {
            double cn = ck * ct - sk * st;
            double sn = sk * ct + ck * st;
            ck = cn; sk = sn;
            double w = (even && k == nk - 1) ? 1.0 : 2.0;
            double xr = xc_re[k], xi = xc_im[k];
            double yr = yc_re[k], yi = yc_im[k];
            // Re(c e^{ikt}) = cr ck - ci sk ; d/dt -> k * (-cr sk - ci ck)
            xs   += w * (xr * ck - xi * sk);
            ys   += w * (yr * ck - yi * sk);
            xps  += w * k * (-xr * sk - xi * ck);
            yps  += w * k * (-yr * sk - yi * ck);
            xpps += w * k * k * (-xr * ck + xi * sk);
            ypps += w * k * k * (-yr * ck + yi * sk);
        }
        double inv = 1.0 / n;
        x = xs * inv;  y = ys * inv;
        xp = xps * inv; yp = yps * inv;
        xpp = xpps * inv; ypp = ypps * inv;
    }
};

}  // namespace

extern "C" {

// Returns the number of near points found (<= capacity); fills outputs.
// Grid is uniform: x = x0 + i*hx (i < nx), y = y0 + j*hy (j < ny).
int64_t grid_near_coords(
    const double *bx, const double *by, int64_t nb,
    const double *xc_re, const double *xc_im,
    const double *yc_re, const double *yc_im,
    double x0, double hx, int64_t nx,
    double y0, double hy, int64_t ny,
    double width, double newton_tol, int max_iter, int upsample,
    int32_t *out_ix, int32_t *out_iy, double *out_t, double *out_r,
    uint8_t *out_conv, int64_t capacity)
{
    const int64_t ncell = nx * ny;
    std::vector<int32_t> guess(ncell, -1);
    std::vector<float> best(ncell, 1e30f);

    // 1. stamp the upsampled polyline
    const int64_t nf = nb * upsample;
    CurveEval ce{xc_re, xc_im, yc_re, yc_im, (int)(nb / 2 + 1), (int)nb,
                 nb % 2 == 0};
    const double two_pi = 6.283185307179586476925;
    const double margin = 2.0 * std::max(hx, hy);
    const double rad = width + margin;
    std::vector<double> fx(nf), fy(nf), ft(nf);
    #pragma omp parallel for schedule(static)
    for (int64_t s = 0; s < nf; ++s) {
        double t = two_pi * s / nf;
        double x, y, xp, yp, xpp, ypp;
        ce.eval(t, x, y, xp, yp, xpp, ypp);
        fx[s] = x; fy[s] = y; ft[s] = t;
    }
    for (int64_t s = 0; s < nf; ++s) {
        int64_t i0 = (int64_t)std::ceil((fx[s] - rad - x0) / hx);
        int64_t i1 = (int64_t)std::floor((fx[s] + rad - x0) / hx);
        int64_t j0 = (int64_t)std::ceil((fy[s] - rad - y0) / hy);
        int64_t j1 = (int64_t)std::floor((fy[s] + rad - y0) / hy);
        i0 = std::max<int64_t>(i0, 0); i1 = std::min<int64_t>(i1, nx - 1);
        j0 = std::max<int64_t>(j0, 0); j1 = std::min<int64_t>(j1, ny - 1);
        for (int64_t i = i0; i <= i1; ++i) {
            double dx = x0 + i * hx - fx[s];
            for (int64_t j = j0; j <= j1; ++j) {
                double dy = y0 + j * hy - fy[s];
                float d2 = (float)(dx * dx + dy * dy);
                int64_t c = i * ny + j;
                if (d2 < best[c]) { best[c] = d2; guess[c] = (int32_t)s; }
            }
        }
    }

    // collect candidates
    std::vector<int64_t> cand;
    cand.reserve(1 << 16);
    const float rad2 = (float)(rad * rad);
    for (int64_t c = 0; c < ncell; ++c)
        if (guess[c] >= 0 && best[c] <= rad2) cand.push_back(c);

    const int64_t m = (int64_t)cand.size();
    std::vector<double> tt(m), rr(m);
    std::vector<uint8_t> cv(m);

    // 2. Newton per candidate
    #pragma omp parallel for schedule(dynamic, 256)
    for (int64_t q = 0; q < m; ++q) {
        int64_t c = cand[q];
        double px = x0 + (c / ny) * hx;
        double py = y0 + (c % ny) * hy;
        double t = ft[guess[c]];
        double scale = 0.0;
        double x, y, xp, yp, xpp, ypp;
        bool ok = false;
        for (int it = 0; it < max_iter; ++it) {
            ce.eval(t, x, y, xp, yp, xpp, ypp);
            double dx = px - x, dy = py - y;
            double g = dx * xp + dy * yp;
            double gp = -(xp * xp + yp * yp) + dx * xpp + dy * ypp;
            if (scale == 0.0) scale = xp * xp + yp * yp;
            if (std::fabs(gp) < 1e-12 * scale)
                gp = (gp >= 0 ? 1.0 : -1.0) * 1e-12 * scale;
            double step = g / gp;
            if (step > 0.5) step = 0.5; else if (step < -0.5) step = -0.5;
            t -= step;
            if (std::fabs(g) <= newton_tol * scale) { ok = true; break; }
        }
        ce.eval(t, x, y, xp, yp, xpp, ypp);
        double sp = std::sqrt(xp * xp + yp * yp);
        double nxv = yp / sp, nyv = -xp / sp;
        tt[q] = t - two_pi * std::floor(t / two_pi);
        rr[q] = (px - x) * nxv + (py - y) * nyv;
        cv[q] = ok ? 1 : 0;
    }

    // 3. emit within-width points.  Keep counting past capacity so the
    // caller can detect overflow (returns -total_needed) instead of
    // silently receiving a truncated registration.
    int64_t count = 0;
    for (int64_t q = 0; q < m; ++q) {
        if (std::fabs(rr[q]) <= width) {
            if (count < capacity) {
                int64_t c = cand[q];
                out_ix[count] = (int32_t)(c / ny);
                out_iy[count] = (int32_t)(c % ny);
                out_t[count] = tt[q];
                out_r[count] = rr[q];
                out_conv[count] = cv[q];
            }
            ++count;
        }
    }
    return (count > capacity) ? -count : count;
}

}  // extern "C"
