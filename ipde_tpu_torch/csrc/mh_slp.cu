// Modified Helmholtz (Yukawa) single-layer potential, dense FP64 sum, for
// Hopper (sm_90a).
//
//   u(t_i) = sum_j K0(k r_ij) q_j / (2 pi),   r_ij^2 = max(|t_i - s_j|^2, 1e-30)
//
// Replaces the Pallas kernel `_mh_update` and its K0, `_k0_ds`
// (ipde_tpu/ops/pallas_ds.py), reached there through
// `pallas_ds.mh_slp_apply`.  The TPU kernel works in double-single (hi/lo
// f32) arithmetic because Mosaic has no f64; the H100 has native FP64, so
// this kernel keeps one FP64 register accumulator.  The r^2 clamp at 1e-30
// is the TPU kernel's (pallas_ds.py `_pair_geometry`).
//
// CUDA's math library has no K0, so `k0` below evaluates the TPU kernel's
// split, branching per pair (the TPU pays every branch on every lane):
//   * z < z_lo (= 2): the series K0 = sum_m H_m q^m / (m!)^2
//     - (log(z/2) + gamma) I0(z), q = z^2/4 = k^2 r^2 / 4, m = 1 .. 13;
//   * z_lo <= z <= z_hi (= 36): K0 = f(1/z) e^-z / sqrt(z), f a Chebyshev
//     series in u = 1/z evaluated by Clenshaw's recurrence (one reciprocal,
//     one FMA step per coefficient, one exp, one sqrt);
//   * z > z_hi: zero (K0(36) ~ 4e-17).
// The Chebyshev coefficients, the interval and the affine map of u onto
// [-1, 1] are arguments: the host fit (ops/kernels.py `k0_cheb_coeffs`) is
// their one source.  Each block stages the coefficients in shared memory.
//
// Bound: FP64 throughput.  A pair costs 82 FP64 operations in the series
// branch, 98 in the Chebyshev branch and 12 in the dead one (an FMA counted
// as two; log, exp, sqrt and a reciprocal as one); the data moved is O(T + S)
// doubles.  Design, simple first, as laplace_slp.cu: one thread per target,
// blocks of 256 threads, tiles of 256 sources (x, y, q) in shared memory, the
// ragged ends of both ranges masked in the kernel.  A warp whose targets
// straddle z = 2 or z = 36 for one source runs both branches one after the
// other (divergence); a later PR may sort or split the pairs by branch.
//
// C interface (bound with ctypes): returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxCheb = 64;
constexpr int kSeriesTerms = 14;  // the series sums m = 1 .. kSeriesTerms-1
constexpr double kInvTwoPi = 0.15915494309189533577;  // 1 / (2 pi)
constexpr double kGamma = 0.5772156649015328606;      // Euler's constant
constexpr double kMinR2 = 1e-30;

struct ChebFit {
  const double* c;  // shared-memory copy of the coefficients
  int n;
  double z_lo, z_hi, u_scale, u_shift;
};

// K0(z), with q = z^2 / 4 formed by the caller from r^2.
__device__ __forceinline__ double k0(double z, double q, const ChebFit& f) {
  if (z < f.z_lo) {
    double term = 1.0;
    double i0 = 1.0;
    double acc = 0.0;
    double harmonic = 0.0;
#pragma unroll
    for (int m = 1; m < kSeriesTerms; ++m) {
      term *= q * (1.0 / (m * m));  // q^m / (m!)^2
      i0 += term;
      harmonic += 1.0 / m;          // H_m, folded at compile time
      acc = fma(harmonic, term, acc);
    }
    return fma(-fma(0.5, log(q), kGamma), i0, acc);
  }
  if (z > f.z_hi) return 0.0;
  const double u = 1.0 / z;
  const double x = fma(u, f.u_scale, f.u_shift);
  const double x2 = x + x;
  double b1 = 0.0;
  double b2 = 0.0;
  for (int i = f.n - 1; i > 0; --i) {
    const double b = fma(x2, b1, f.c[i] - b2);
    b2 = b1;
    b1 = b;
  }
  return fma(x, b1, f.c[0] - b2) * exp(-z) * sqrt(u);
}

__global__ void __launch_bounds__(kBlock)
mh_slp_kernel(const double* __restrict__ sx, const double* __restrict__ sy,
              const double* __restrict__ q, int64_t S,
              const double* __restrict__ tx, const double* __restrict__ ty,
              double* __restrict__ out, int64_t T, double k,
              const double* __restrict__ cheb, int n_cheb, double z_lo,
              double z_hi, double u_scale, double u_shift) {
  __shared__ double s_x[kBlock];
  __shared__ double s_y[kBlock];
  __shared__ double s_q[kBlock];
  __shared__ double s_c[kMaxCheb];
  if (static_cast<int>(threadIdx.x) < n_cheb) {
    s_c[threadIdx.x] = cheb[threadIdx.x];
  }
  const ChebFit fit{s_c, n_cheb, z_lo, z_hi, u_scale, u_shift};
  const double kq = 0.25 * k * k;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const bool live = t < T;
  const double x = live ? tx[t] : 0.0;
  const double y = live ? ty[t] : 0.0;
  double acc = 0.0;
  for (int64_t j0 = 0; j0 < S; j0 += kBlock) {
    const int64_t j = j0 + threadIdx.x;
    if (j < S) {
      s_x[threadIdx.x] = sx[j];
      s_y[threadIdx.x] = sy[j];
      s_q[threadIdx.x] = q[j];
    }
    __syncthreads();  // also orders the first tile after the s_c stores
    const int n = static_cast<int>(S - j0 < kBlock ? S - j0 : kBlock);
    for (int jj = 0; jj < n; ++jj) {
      const double dx = x - s_x[jj];
      const double dy = y - s_y[jj];
      const double r2 = fmax(dx * dx + dy * dy, kMinR2);
      acc = fma(k0(sqrt(r2) * k, r2 * kq, fit), s_q[jj], acc);
    }
    __syncthreads();
  }
  if (live) out[t] = acc * kInvTwoPi;
}

}  // namespace

extern "C" int mh_slp_apply_f64(const double* sx, const double* sy,
                                const double* q, int64_t S, const double* tx,
                                const double* ty, double* out, int64_t T,
                                double k, const double* cheb, int n_cheb,
                                double z_lo, double z_hi, double u_scale,
                                double u_shift, int device, void* stream) {
  if (n_cheb < 1 || n_cheb > kMaxCheb) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (T + kBlock - 1) / kBlock;
  mh_slp_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      sx, sy, q, S, tx, ty, out, T, k, cheb, n_cheb, z_lo, z_hi, u_scale,
      u_shift);
  return static_cast<int>(cudaGetLastError());
}
