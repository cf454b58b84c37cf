// Laplace single-layer potential, dense FP64 sum, for Hopper (sm_90a).
//
//   u(t_i) = sum_j -log(max(|t_i - s_j|^2, 1e-30)) q_j / (4 pi)
//
// Replaces the Pallas kernel `_laplace_update` (ipde_tpu/ops/pallas_ds.py),
// reached there through `pallas_ds.laplace_slp_apply`.  The TPU kernel works
// in double-single (hi/lo f32) arithmetic in (8, 256) target tiles because
// Mosaic has no f64; the H100 has native FP64, so none of that carries over.
// The r^2 clamp at 1e-30 is the TPU kernel's (pallas_ds.py `_pair_geometry`):
// a coincident pair stays finite, and a NaN coordinate gives NaN as it does in
// the plain version.
//
// Bound: FP64 instruction issue.  The data moved is O(T + S) doubles (the
// pairs never touch device memory), so TMA, cp.async, wgmma and the FP64
// tensor cores have nothing to do here: there is no tile traffic to hide
// and no matrix product.  The counted work is 9 FP64 operations per pair;
// what limits the kernel is the instructions a pair issues: an FP64 warp
// instruction takes two cycles of its SM quarter, three when it reads three
// different registers, and the integer and load instructions around it do
// not hide behind it entirely.  Design:
//   * the log by `fp64::log_normal` (fp64_math.cuh) with an 8-bit table
//     (32 KB of shared memory, a polynomial of degree 3): seven FP64
//     instructions, no library call, no branch; its constants are a kernel
//     argument, so they are read from the constant bank and not from
//     registers; twelve FP64 instructions per pair in all;
//   * the loop neither clamps nor branches: it tests the high word of r^2
//     (fp64::outside_fast_range) and a thread that meets an r^2 at or below
//     the clamp, or a NaN or infinite one, only sets a flag, and redoes its
//     whole sum afterwards with the clamp and the library's log
//     (`laplace_sum_any`), so such inputs give what the plain version gives;
//   * the sign and 1 / (4 pi) are applied once per target;
//   * two targets per thread in blocks of 128 threads (256 targets a block):
//     a source tile's loads and the loop counter are shared by two pairs
//     (one target per thread in blocks of 256 was 10% slower, four targets
//     25%);
//   * tiles of 256 sources staged through shared memory as (x, y) pairs and
//     charges, so a source is read from device memory once per block and
//     costs a warp broadcast loads only;
//   * the ragged ends of both ranges are masked in the kernel, so nothing
//     is padded on the host;
//   * a launch with few targets (the radial groups of a solve) splits its
//     sources across blocks (fp64::plan_split) and adds the partial sums in
//     a fixed order: the same bits on every run.
//
// C interface (bound with ctypes): the launchers return a cudaError_t.

#include <cuda_runtime.h>
#include <cstdint>

#include "fp64_math.cuh"

namespace {

constexpr int kBits = 8;  // of the log table
constexpr int kThreads = 128;
constexpr int kTargetsPerThread = 2;
constexpr int kTargetsPerBlock = kThreads * kTargetsPerThread;
constexpr int kTile = 256;  // sources per shared-memory tile
// Every block costs the same, so a few blocks per SM fill the card.
constexpr int kFillBlocks = 132 * 4;
constexpr double kNegInvFourPi = -0.079577471545947667884;  // -1 / (4 pi)

// sum_j log(max(r_j^2, min_r2)) q_j over sources [j_begin, j_end) with the
// clamp and the library's log, out of line: for a thread whose fast sum met an
// r^2 that it does not take (fp64::outside_fast_range).
__device__ __noinline__ double laplace_sum_any(
    const double* __restrict__ sx, const double* __restrict__ sy,
    const double* __restrict__ q, int64_t j_begin, int64_t j_end, double x,
    double y, double min_r2) {
  double acc = 0.0;
  for (int64_t j = j_begin; j < j_end; ++j) {
    const double dx = x - sx[j];
    const double dy = y - sy[j];
    double r2 = fma(dy, dy, dx * dx);
    r2 = r2 < min_r2 ? min_r2 : r2;
    acc = fma(log(r2), q[j], acc);
  }
  return acc;
}

// Block (i, j): targets [256 i, ...), sources [j chunk, ...).  With one source
// range (gridDim.y == 1) the scaled sum goes to out; otherwise the unscaled
// sum of range j goes to part[j T + t].  `lc` is an argument so that the
// loop reads the log's constants from the constant bank.
__global__ void __launch_bounds__(kThreads)
laplace_slp_kernel(const double* __restrict__ sx, const double* __restrict__ sy,
                   const double* __restrict__ q, int64_t S, int64_t chunk,
                   const double* __restrict__ tx, const double* __restrict__ ty,
                   double* __restrict__ out, double* __restrict__ part,
                   int64_t T, const double* __restrict__ log_table,
                   const fp64::LogConsts lc) {
  __shared__ double2 s_xy[kTile];
  __shared__ double s_q[kTile];
  __shared__ double2 s_log[fp64::LogTable<kBits>::kShared];
  const int tid = threadIdx.x;
  const double2* my_log =
      fp64::stage_log_table<kBits>(log_table, s_log, tid, kThreads);
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTargetsPerBlock + tid;
  double x[kTargetsPerThread], y[kTargetsPerThread];
  double sum[kTargetsPerThread];
#pragma unroll
  for (int i = 0; i < kTargetsPerThread; ++i) {
    // a thread past the end repeats the last target and stores nothing
    const int64_t t = t0 + i * kThreads < T ? t0 + i * kThreads : T - 1;
    x[i] = tx[t];
    y[i] = ty[t];
    sum[i] = 0.0;
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
    __syncthreads();  // also orders the first tile after the s_log stores
    const int n = static_cast<int>(j_end - j0 < kTile ? j_end - j0 : kTile);
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const double2 s = s_xy[k];
      const double w = s_q[k];
#pragma unroll
      for (int i = 0; i < kTargetsPerThread; ++i) {
        const double dx = x[i] - s.x;
        const double dy = y[i] - s.y;
        const double r2 = fma(dy, dy, dx * dx);
        odd |= fp64::outside_fast_range(r2);
        sum[i] = fma(fp64::log_normal<kBits>(r2, my_log, lc), w, sum[i]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTargetsPerThread; ++i) {
    const int64_t t = t0 + i * kThreads;
    if (t >= T) continue;
    if (odd) {
      sum[i] =
          laplace_sum_any(sx, sy, q, j_begin, j_end, x[i], y[i], lc.min_r2);
    }
    if (gridDim.y == 1) {
      out[t] = sum[i] * kNegInvFourPi;
    } else {
      part[static_cast<int64_t>(blockIdx.y) * T + t] = sum[i];
    }
  }
}

}  // namespace

// The number of source ranges a launch of T targets and S sources is split
// into (1: none): the wrapper sizes the scratch array from it.
extern "C" int laplace_slp_split_count(int64_t T, int64_t S) {
  return fp64::plan_split(T, S, kTargetsPerBlock, kFillBlocks).splits;
}

// `log_table` is the host's 8-bit table in device memory and `log_table_host`
// the same array on the host (its constants become a kernel argument);
// `scratch` holds at least splits * T doubles when splits > 1.
extern "C" int laplace_slp_apply_f64(const double* sx, const double* sy,
                                     const double* q, int64_t S,
                                     const double* tx, const double* ty,
                                     double* out, int64_t T,
                                     const double* log_table,
                                     const double* log_table_host,
                                     double* scratch, int64_t scratch_len,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const fp64::SplitPlan plan =
      fp64::plan_split(T, S, kTargetsPerBlock, kFillBlocks);
  if (plan.splits > 1 && scratch_len < plan.splits * T) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(
      static_cast<unsigned>((T + kTargetsPerBlock - 1) / kTargetsPerBlock),
      static_cast<unsigned>(plan.splits));
  const fp64::LogConsts lc = fp64::log_consts_from_host<kBits>(log_table_host);
  laplace_slp_kernel<<<grid, kThreads, 0, st>>>(sx, sy, q, S, plan.chunk, tx,
                                                ty, out, scratch, T, log_table,
                                                lc);
  err = cudaGetLastError();
  if (err != cudaSuccess || plan.splits == 1) return static_cast<int>(err);
  const fp64::SplitOutputs<1> outs{{out}, {kNegInvFourPi}};
  fp64::combine_splits_kernel<1>
      <<<static_cast<unsigned>((T + 255) / 256), 256, 0, st>>>(
          scratch, plan.splits, outs, T);
  return static_cast<int>(cudaGetLastError());
}
