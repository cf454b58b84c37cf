// Gradient of the Laplace single-layer potential, dense FP64 sum, for Hopper
// (sm_90a).
//
//   gx(t_i) = -sum_j dx_ij q_j / max(r_ij^2, 1e-30) / (2 pi)
//   gy(t_i) = -sum_j dy_ij q_j / max(r_ij^2, 1e-30) / (2 pi)
//
// with (dx, dy) = t_i - s_j.  Replaces the Pallas kernel `_grad_update`
// (ipde_tpu/ops/pallas_ds.py), reached there through
// `pallas_ds.laplace_slp_grad_apply`.  The TPU kernel works in double-single
// (hi/lo f32) arithmetic in (8, 256) target tiles because Mosaic has no f64;
// the H100 has native FP64, so none of that carries over.  The r^2 clamp at
// 1e-30 is the TPU kernel's (pallas_ds.py `_pair_geometry`): a coincident
// pair stays finite, and a NaN coordinate gives NaN as it does in the plain
// version.
//
// Bound: FP64 instruction issue.  The data moved is O(T + S) doubles (the
// pairs never touch device memory), so TMA, cp.async, wgmma and the FP64
// tensor cores have nothing to do here: there is no tile traffic to hide
// and no matrix product.  The counted work is 12 FP64 operations per pair;
// what limits the kernel is the number of FP64 instructions a pair issues
// (one warp instruction per two cycles per SM quarter, three cycles when it
// reads three different registers).  The design is laplace_slp.cu's:
//   * `fp64::rcp_pos` (fp64_math.cuh: the hardware's approximation and one
//     Newton step, 3 FP64 instructions) in place of the division (about 10):
//     ten FP64 instructions per pair in all;
//   * the loop neither clamps nor branches: it tests the high word of r^2
//     (fp64::outside_fast_range) and a thread that meets an r^2 at or below
//     the clamp, or a NaN or infinite one, only sets a flag, and redoes its
//     whole sum afterwards with the clamp and a division
//     (`laplace_grad_any`), so such inputs give what the plain version gives;
//   * the sign and 1 / (2 pi) are applied once per target;
//   * two targets per thread in blocks of 128 threads, tiles of 256 sources
//     staged through shared memory as (x, y) pairs and charges, the ragged
//     ends of both ranges masked in the kernel;
//   * a launch with few targets splits its sources across blocks
//     (fp64::plan_split) and adds the partial sums in a fixed order.
//
// C interface (bound with ctypes): the launchers return a cudaError_t.

#include <cuda_runtime.h>
#include <cstdint>

#include "fp64_math.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTargetsPerThread = 2;
constexpr int kTargetsPerBlock = kThreads * kTargetsPerThread;
constexpr int kTile = 256;  // sources per shared-memory tile
// Every block costs the same, so a few blocks per SM fill the card.
constexpr int kFillBlocks = 132 * 4;
constexpr double kNegInvTwoPi = -0.15915494309189533577;  // -1 / (2 pi)
constexpr double kMinR2 = 1e-30;

// sum_j (dx_j, dy_j) q_j / max(r_j^2, 1e-30) over sources [j_begin, j_end) with
// the clamp and a division, out of line: for a thread whose fast sum met an
// r^2 that it does not take (fp64::outside_fast_range).
__device__ __noinline__ double2 laplace_grad_any(
    const double* __restrict__ sx, const double* __restrict__ sy,
    const double* __restrict__ q, int64_t j_begin, int64_t j_end, double x,
    double y) {
  double ax = 0.0, ay = 0.0;
  for (int64_t j = j_begin; j < j_end; ++j) {
    const double dx = x - sx[j];
    const double dy = y - sy[j];
    double r2 = fma(dy, dy, dx * dx);
    r2 = r2 < kMinR2 ? kMinR2 : r2;
    const double c = (1.0 / r2) * q[j];
    ax = fma(dx, c, ax);
    ay = fma(dy, c, ay);
  }
  return make_double2(ax, ay);
}

// Block (i, j): targets [256 i, ...), sources [j chunk, ...).  With one source
// range (gridDim.y == 1) the scaled sums go to gx, gy; otherwise the unscaled
// sums of range j go to part[(2 j + c) T + t].
__global__ void __launch_bounds__(kThreads)
laplace_grad_kernel(const double* __restrict__ sx,
                    const double* __restrict__ sy,
                    const double* __restrict__ q, int64_t S, int64_t chunk,
                    const double* __restrict__ tx,
                    const double* __restrict__ ty, double* __restrict__ gx,
                    double* __restrict__ gy, double* __restrict__ part,
                    int64_t T) {
  __shared__ double2 s_xy[kTile];
  __shared__ double s_q[kTile];
  const int tid = threadIdx.x;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTargetsPerBlock + tid;
  double x[kTargetsPerThread], y[kTargetsPerThread];
  double ax[kTargetsPerThread], ay[kTargetsPerThread];
#pragma unroll
  for (int i = 0; i < kTargetsPerThread; ++i) {
    // a thread past the end repeats the last target and stores nothing
    const int64_t t = t0 + i * kThreads < T ? t0 + i * kThreads : T - 1;
    x[i] = tx[t];
    y[i] = ty[t];
    ax[i] = 0.0;
    ay[i] = 0.0;
  }
  bool odd = false;  // met an r^2 the fast sum does not take
  const int64_t j_begin = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t j_end = j_begin + chunk < S ? j_begin + chunk : S;
  for (int64_t j0 = j_begin; j0 < j_end; j0 += kTile) {
    for (int i = tid; i < kTile; i += kThreads) {
      const int64_t j = j0 + i;
      if (j < j_end) {
        s_xy[i] = make_double2(sx[j], sy[j]);
        s_q[i] = q[j];
      }
    }
    __syncthreads();
    const int n = static_cast<int>(j_end - j0 < kTile ? j_end - j0 : kTile);
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      const double2 s = s_xy[k];
      const double w = s_q[k];
#pragma unroll
      for (int i = 0; i < kTargetsPerThread; ++i) {
        const double dx = x[i] - s.x;
        const double dy = y[i] - s.y;
        const double r2 = fma(dy, dy, dx * dx);
        odd |= fp64::outside_fast_range(r2);
        const double c = fp64::rcp_pos(r2) * w;
        ax[i] = fma(dx, c, ax[i]);
        ay[i] = fma(dy, c, ay[i]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTargetsPerThread; ++i) {
    const int64_t t = t0 + i * kThreads;
    if (t >= T) continue;
    double2 sum = make_double2(ax[i], ay[i]);
    if (odd) sum = laplace_grad_any(sx, sy, q, j_begin, j_end, x[i], y[i]);
    if (gridDim.y == 1) {
      gx[t] = sum.x * kNegInvTwoPi;
      gy[t] = sum.y * kNegInvTwoPi;
    } else {
      double* mine = part + static_cast<int64_t>(blockIdx.y) * 2 * T + t;
      mine[0] = sum.x;
      mine[T] = sum.y;
    }
  }
}

}  // namespace

// The number of source ranges a launch of T targets and S sources is split
// into (1: none): the wrapper sizes the scratch array from it.
extern "C" int laplace_grad_split_count(int64_t T, int64_t S) {
  return fp64::plan_split(T, S, kTargetsPerBlock, kFillBlocks).splits;
}

// `scratch` holds at least 2 * splits * T doubles when splits > 1.
extern "C" int laplace_grad_apply_f64(const double* sx, const double* sy,
                                      const double* q, int64_t S,
                                      const double* tx, const double* ty,
                                      double* gx, double* gy, int64_t T,
                                      double* scratch, int64_t scratch_len,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const fp64::SplitPlan plan =
      fp64::plan_split(T, S, kTargetsPerBlock, kFillBlocks);
  if (plan.splits > 1 && scratch_len < 2 * plan.splits * T) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(
      static_cast<unsigned>((T + kTargetsPerBlock - 1) / kTargetsPerBlock),
      static_cast<unsigned>(plan.splits));
  laplace_grad_kernel<<<grid, kThreads, 0, st>>>(sx, sy, q, S, plan.chunk, tx,
                                                 ty, gx, gy, scratch, T);
  err = cudaGetLastError();
  if (err != cudaSuccess || plan.splits == 1) return static_cast<int>(err);
  const fp64::SplitOutputs<2> outs{{gx, gy}, {kNegInvTwoPi, kNegInvTwoPi}};
  fp64::combine_splits_kernel<2>
      <<<static_cast<unsigned>((T + 255) / 256), 256, 0, st>>>(
          scratch, plan.splits, outs, T);
  return static_cast<int>(cudaGetLastError());
}
