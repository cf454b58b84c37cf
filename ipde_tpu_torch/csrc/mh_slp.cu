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
// is the TPU kernel's (pallas_ds.py `_pair_geometry`); it is a compare and
// select, not fmax, so that a NaN coordinate gives NaN as in the plain
// version.
//
// CUDA's math library has no K0.  `k0_times` below evaluates the TPU
// kernel's split, branching per pair on q = z^2 / 4 = k^2 r^2 / 4, which
// needs no root (the TPU pays every branch on every lane):
//   * q < 1 (z < 2): K0 = R(q) - (log(q) / 2 + gamma) I0(q), with I0 and the
//     regular part R as polynomials of 9 coefficients in q (Horner) and
//     fp64::log_pos for the log;
//   * 1 <= q <= 324 (2 <= z <= 36): K0 = f(1/z) e^-z / sqrt(z), f one of
//     three polynomials of 11 coefficients in u = 1/z (Horner), one for each
//     sub-interval of z; 1/r comes from fp64::rsqrt_pos(r^2), then z = k r
//     and u = (1/r) / k, 1/sqrt(z) from a second rsqrt_pos, and e^-z from
//     fp64::exp_neg;
//   * q > 324: zero (K0(36) ~ 4e-17).
// Every coefficient and threshold is an argument: the host fits
// (ops/kernels.py `k0_fit`) are their one source, and the plain version
// uses the same numbers.  The thresholds and the series are passed by value
// (K0Head), so they sit in the constant bank.  The three fits' rows are
// staged in shared memory and each lane reads the row of its sub-interval
// (rows 13 doubles apart, so three rows never meet in a bank): no branch
// picks the sub-interval, and a warp that straddles two of them pays
// nothing.
//
// Bound: FP64 instruction issue; the data moved is O(T + S) doubles, so
// TMA, cp.async, wgmma and the FP64 tensor cores have nothing to do here.
// The counted work is 82 FP64 operations for a series pair, 98 for a fitted
// pair and 12 for a dead one; this kernel issues 36, 48 and 9 FP64
// instructions for them (its first version 71, about 125 and 18).  Design:
//   * one thread per target, blocks of 256 threads; a warp's lanes run
//     every branch that one of them takes, so the kernel is fastest when a
//     warp's 32 targets are close together (ops/kernels.py `spatial_order`)
//     and right for any order;
//   * tiles of 256 sources (x, y, q) are staged through shared memory;
//     each warp stages 32 of them and reduces their bounding box on the
//     way.  Each warp also holds the bounding box of its own targets, and
//     skips a 32-source sub-tile when k times the distance between the two
//     boxes is beyond z = 36: those pairs add exactly zero.  A box with a
//     NaN coordinate is never skipped, and a NaN or infinite charge reaches
//     every target through the sum of its sub-tile's charges times zero;
//   * a launch with few targets splits its sources across blocks
//     (fp64::plan_split) and adds the partial sums in a fixed order;
//   * the ragged ends of both ranges are masked in the kernel.
//
// C interface (bound with ctypes): the launchers return a cudaError_t.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>
#include <cstring>

#include "fp64_math.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
// Blocks differ in cost (the branch mix and the skipped sub-tiles depend on
// where a block's targets lie), so a launch is cut into many more blocks
// than the card holds at once: sixteen per SM.
constexpr int kFillBlocks = 132 * 16;
constexpr int kSeries = 9;     // coefficients of each series polynomial
constexpr int kIntervals = 3;  // sub-intervals of the fitted range
constexpr int kCheb = 11;      // coefficients of each fit
constexpr double kInvTwoPi = 0.15915494309189533577;  // 1 / (2 pi)
constexpr double kGamma = 0.5772156649015328606;      // Euler's constant
// a sub-tile is skipped only when its nearest possible pair is beyond the
// dead threshold by this factor: rounding cannot bring such a pair back
constexpr double kSkipMargin = 1.0 + 1e-12;

// ops/kernels.py `k0_fit`, in its order: K0Head, then the fits' rows
// (u scale, u shift, a_0, ..., a_10), kIntervals * kChebRow doubles.
struct K0Head {
  double q_break[kIntervals + 1];  // series below [0], dead beyond [last]
  double i0[kSeries];
  double reg[kSeries];
};
constexpr int kHeadLen = sizeof(K0Head) / sizeof(double);
constexpr int kChebRow = 2 + kCheb;
constexpr int kFitLen = kHeadLen + kIntervals * kChebRow;

template <int N>
__device__ __forceinline__ double horner(const double (&c)[N], double x) {
  double h = c[N - 1];
#pragma unroll
  for (int i = N - 2; i >= 0; --i) h = fma(h, x, c[i]);
  return h;
}

// f(u) by the row of a sub-interval (in shared memory; per lane).
__device__ __forceinline__ double fitted(const double* row, double u) {
  const double x = fma(u, row[0], row[1]);
  double h = row[2 + kCheb - 1];
#pragma unroll
  for (int i = kCheb - 2; i >= 0; --i) h = fma(h, x, row[2 + i]);
  return h;
}

// acc + K0(z) w for the pair with clamped distance^2 r2 and q = k^2 r2 / 4.
__device__ __forceinline__ double k0_times(double r2, double q, double w,
                                           double acc, double k, double inv_k,
                                           const K0Head& f,
                                           const double* s_cheb,
                                           const double2* my_log,
                                           const fp64::LogConsts& lc,
                                           const double* my_exp,
                                           const fp64::ExpConsts& ec) {
  if (q < f.q_break[0]) {
    const double lg = fp64::log_pos(q, my_log, lc);
    const double k0 =
        fma(-fma(0.5, lg, kGamma), horner(f.i0, q), horner(f.reg, q));
    return fma(k0, w, acc);
  }
  if (q <= f.q_break[kIntervals]) {
    const double inv_r = fp64::rsqrt_pos(r2);
    const double z = r2 * inv_r * k;
    const double u = inv_r * inv_k;
    const double* row =
        s_cheb + kChebRow * ((q > f.q_break[1]) + (q > f.q_break[2]));
    const double poly = fitted(row, u);
    const double ez = fp64::exp_neg(-z, my_exp, ec);
    return fma(poly * ez * fp64::rsqrt_pos(z), w, acc);
  }
  // dead, or q is NaN: a NaN must reach the sum
  return q == q ? acc : q;
}

__device__ __forceinline__ double warp_min(double v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    v = fmin(v, __shfl_xor_sync(0xffffffffu, v, d));
  }
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    v = fmax(v, __shfl_xor_sync(0xffffffffu, v, d));
  }
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// The bounding box of a warp's live lanes.  fmin and fmax pass over a NaN,
// so a box with a NaN member is made (-inf, inf) in both directions: it is
// never out of reach, and the NaN reaches the sum.  An empty box (no live
// lane) is (inf, -inf).
struct Box {
  double x_lo, x_hi, y_lo, y_hi;
};

__device__ __forceinline__ Box warp_box(double x, double y, bool live) {
  Box b;
  b.x_lo = warp_min(live ? x : CUDART_INF);
  b.x_hi = warp_max(live ? x : -CUDART_INF);
  b.y_lo = warp_min(live ? y : CUDART_INF);
  b.y_hi = warp_max(live ? y : -CUDART_INF);
  if (__any_sync(0xffffffffu, live && (x != x || y != y))) {
    b.x_lo = b.y_lo = -CUDART_INF;
    b.x_hi = b.y_hi = CUDART_INF;
  }
  return b;
}

// Block (i, j): targets [256 i, ...), sources [j chunk, ...).  With one
// source range (gridDim.y == 1) the scaled sum goes to `out`; otherwise the
// unscaled sum of range j goes to part[j T + t].
__global__ void __launch_bounds__(kBlock)
mh_slp_kernel(const double* __restrict__ sx, const double* __restrict__ sy,
              const double* __restrict__ q, int64_t S, int64_t chunk,
              const double* __restrict__ tx, const double* __restrict__ ty,
              double* __restrict__ out, double* __restrict__ part, int64_t T,
              double k, const K0Head fit, const double* __restrict__ cheb,
              const double* __restrict__ log_table,
              const double* __restrict__ exp_table) {
  __shared__ double2 s_xy[kBlock];
  __shared__ double s_q[kBlock];
  __shared__ Box s_box[kWarps];
  __shared__ double s_qsum[kWarps];
  __shared__ double2 s_log[fp64::kLogShared];
  __shared__ double s_cheb[kIntervals * kChebRow];
  __shared__ double s_exp[fp64::kExpShared];
  const int tid = threadIdx.x;
  if (tid < kIntervals * kChebRow) s_cheb[tid] = cheb[tid];
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const double2* my_log = fp64::stage_log_table(log_table, s_log, tid, kBlock);
  const fp64::LogConsts lc = fp64::load_log_consts(log_table);
  const double* my_exp = fp64::stage_exp_table(exp_table, s_exp, tid, kBlock);
  const fp64::ExpConsts ec = fp64::load_exp_consts(exp_table);
  const double kq = 0.25 * k * k;
  const double inv_k = 1.0 / k;
  const double q_dead = fit.q_break[kIntervals] * kSkipMargin;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kBlock + tid;
  const bool live = t < T;
  const double x = live ? tx[t] : 0.0;
  const double y = live ? ty[t] : 0.0;
  const Box mine = warp_box(x, y, live);
  double acc = 0.0;
  const int64_t j_begin = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t j_end = j_begin + chunk < S ? j_begin + chunk : S;
  for (int64_t j0 = j_begin; j0 < j_end; j0 += kBlock) {
    const int64_t j = j0 + tid;
    const bool have = j < j_end;
    const double jx = have ? sx[j] : 0.0;
    const double jy = have ? sy[j] : 0.0;
    const double jq = have ? q[j] : 0.0;
    s_xy[tid] = make_double2(jx, jy);
    s_q[tid] = jq;
    const Box theirs = warp_box(jx, jy, have);
    const double q_sum = warp_sum(jq);
    if (lane == 0) {
      s_box[warp] = theirs;
      s_qsum[warp] = q_sum;
    }
    __syncthreads();  // also orders the first tile after the table stores
    const int n = static_cast<int>(j_end - j0 < kBlock ? j_end - j0 : kBlock);
    for (int w = 0; w * 32 < n; ++w) {
      // what the dead pairs of this sub-tile add: 0, or NaN when one of
      // its charges is NaN or infinite (0 * q_j in the plain version)
      acc = fma(0.0, s_qsum[w], acc);
      const Box b = s_box[w];
      // the gap between the boxes along each axis (0 where they overlap)
      const double gx = fmax(fmax(b.x_lo - mine.x_hi, mine.x_lo - b.x_hi), 0.0);
      const double gy = fmax(fmax(b.y_lo - mine.y_hi, mine.y_lo - b.y_hi), 0.0);
      if (fma(gx, gx, gy * gy) * kq > q_dead) continue;  // warp-uniform
      const int jj_end = n < w * 32 + 32 ? n : w * 32 + 32;
      for (int jj = w * 32; jj < jj_end; ++jj) {
        const double2 s = s_xy[jj];
        const double dx = x - s.x;
        const double dy = y - s.y;
        double r2 = fma(dy, dy, dx * dx);
        r2 = r2 < lc.min_r2 ? lc.min_r2 : r2;
        acc = k0_times(r2, r2 * kq, s_q[jj], acc, k, inv_k, fit, s_cheb, my_log,
                       lc, my_exp, ec);
      }
    }
    __syncthreads();
  }
  if (!live) return;
  if (gridDim.y == 1) {
    out[t] = acc * kInvTwoPi;
  } else {
    part[static_cast<int64_t>(blockIdx.y) * T + t] = acc;
  }
}

}  // namespace

// The number of source ranges a launch of T targets and S sources is split
// into (1: none): the wrapper sizes the scratch array from it.
extern "C" int mh_slp_split_count(int64_t T, int64_t S) {
  return fp64::plan_split(T, S, kBlock, kFillBlocks).splits;
}

// `fit`: the n_fit doubles of ops/kernels.py `k0_fit`, in host memory;
// `fit_dev`: the same array in device memory.  `scratch` holds at least
// splits * T doubles when splits > 1.
extern "C" int mh_slp_apply_f64(const double* sx, const double* sy,
                                const double* q, int64_t S, const double* tx,
                                const double* ty, double* out, int64_t T,
                                double k, const double* fit, int n_fit,
                                const double* fit_dev,
                                const double* log_table,
                                const double* exp_table, double* scratch,
                                int64_t scratch_len, int device,
                                void* stream) {
  if (n_fit != kFitLen) return static_cast<int>(cudaErrorInvalidValue);
  K0Head f;
  std::memcpy(&f, fit, sizeof(f));
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const fp64::SplitPlan plan = fp64::plan_split(T, S, kBlock, kFillBlocks);
  if (plan.splits > 1 && scratch_len < plan.splits * T) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((T + kBlock - 1) / kBlock),
                  static_cast<unsigned>(plan.splits));
  mh_slp_kernel<<<grid, kBlock, 0, st>>>(sx, sy, q, S, plan.chunk, tx, ty, out,
                                         scratch, T, k, f, fit_dev + kHeadLen,
                                         log_table, exp_table);
  err = cudaGetLastError();
  if (err != cudaSuccess || plan.splits == 1) return static_cast<int>(err);
  const fp64::SplitOutputs<1> outs{{out}, {kInvTwoPi}};
  fp64::combine_splits_kernel<1>
      <<<static_cast<unsigned>((T + 255) / 256), 256, 0, st>>>(
          scratch, plan.splits, outs, T);
  return static_cast<int>(cudaGetLastError());
}
