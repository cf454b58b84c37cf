// Stokeslet (Stokes single-layer) velocity and pressure, dense FP64 sum, for
// Hopper (sm_90a).  With dx = tx_i - sx_j, dy = ty_i - sy_j,
// r2 = max(dx^2 + dy^2, 1e-30) and ilr = -log(r2) / 2:
//
//   u(t_i) = sum_j [(ilr + dx^2/r2) fx_j + (dx dy/r2) fy_j] / (4 pi)
//   v(t_i) = sum_j [(dx dy/r2) fx_j + (ilr + dy^2/r2) fy_j] / (4 pi)
//   p(t_i) = sum_j (dx fx_j + dy fy_j) / r2 / (2 pi)
//
// evaluated per pair as d = (dx fx + dy fy) / r2 with the sums of log(r2) fx,
// dx d, log(r2) fy, dy d and d kept apart, so that the factor -1/2 of ilr is
// applied once per target: one log and one reciprocal per pair.
//
// Replaces the Pallas kernel `_stokes_update` (ipde_tpu/ops/pallas_ds.py),
// reached there through `pallas_ds.stokes_slp_apply`.  The TPU kernel works
// in double-single (hi/lo f32) arithmetic in (8, 256) target tiles with at
// most 128 sources per call in SMEM, because Mosaic has no f64; the H100 has
// native FP64, so none of that carries over.  The r^2 clamp at 1e-30 is the
// TPU kernel's (pallas_ds.py `_pair_geometry`): a coincident pair stays
// finite.  The clamp is a compare and select, not fmax, so that a NaN
// coordinate gives NaN as it does in the plain version.
//
// Bound: FP64 instruction issue.  The data moved is O(T + S) doubles (the
// pairs never touch device memory), so TMA, cp.async, wgmma and the FP64
// tensor cores have nothing to do here: there is no tile traffic to hide
// and no matrix product.  The counted work is 22 FP64 operations per pair;
// what limits the kernel is the number of FP64 instructions a pair issues
// (one warp instruction per two cycles per SM quarter).  Design:
//   * `fp64::log_pos` and `fp64::rcp_pos` (fp64_math.cuh) in place of the
//     library's log and division: 26 FP64 instructions per pair where the
//     library versions gave 51;
//   * one thread per target, blocks of 256 threads; tiles of 256 sources
//     are staged through shared memory as (x, y) and (fx, fy) pairs, so a
//     source is read from device memory once per block and costs a warp
//     two 16-byte broadcast loads (two targets per thread were no faster);
//   * five FP64 register accumulators per target, scaled once at the end;
//   * the ragged ends of both ranges are masked in the kernel, so nothing
//     is padded on the host;
//   * a launch with few targets splits its sources across blocks
//     (fp64::plan_split) and adds the partial sums in a fixed order.
//
// C interface (bound with ctypes): the launchers return a cudaError_t.

#include <cuda_runtime.h>
#include <cstdint>

#include "fp64_math.cuh"

namespace {

constexpr int kBlock = 256;
// Every block costs the same, so four blocks per SM fill the card.
constexpr int kFillBlocks = 132 * 4;
constexpr double kInvFourPi = 0.079577471545947667884;  // 1 / (4 pi)
constexpr double kInvTwoPi = 0.15915494309189533577;    // 1 / (2 pi)

// Block (i, j): targets [256 i, ...), sources [j chunk, ...).  With one source
// range (gridDim.y == 1) the scaled sums go to u, v, p; otherwise the
// unscaled sums of range j go to part[(3 j + c) T + t].
__global__ void __launch_bounds__(kBlock)
stokes_slp_kernel(const double* __restrict__ sx, const double* __restrict__ sy,
                  const double* __restrict__ fx, const double* __restrict__ fy,
                  int64_t S, int64_t chunk, const double* __restrict__ tx,
                  const double* __restrict__ ty, double* __restrict__ u,
                  double* __restrict__ v, double* __restrict__ p,
                  double* __restrict__ part, int64_t T,
                  const double* __restrict__ log_table) {
  __shared__ double2 s_xy[kBlock];
  __shared__ double2 s_f[kBlock];
  __shared__ double2 s_log[fp64::kLogShared];
  const int tid = threadIdx.x;
  const double2* my_log = fp64::stage_log_table(log_table, s_log, tid, kBlock);
  const fp64::LogConsts lc = fp64::load_log_consts(log_table);
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kBlock + tid;
  const bool live = t < T;
  const double x = live ? tx[t] : 0.0;
  const double y = live ? ty[t] : 0.0;
  // sums of log(r2) fx, dx d, log(r2) fy, dy d and d
  double ul = 0.0, ud = 0.0, vl = 0.0, vd = 0.0, pd = 0.0;
  const int64_t j_begin = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t j_end = j_begin + chunk < S ? j_begin + chunk : S;
  for (int64_t j0 = j_begin; j0 < j_end; j0 += kBlock) {
    const int64_t j = j0 + tid;
    if (j < j_end) {
      s_xy[tid] = make_double2(sx[j], sy[j]);
      s_f[tid] = make_double2(fx[j], fy[j]);
    }
    __syncthreads();  // also orders the first tile after the s_log stores
    const int n = static_cast<int>(j_end - j0 < kBlock ? j_end - j0 : kBlock);
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const double2 s = s_xy[k];
      const double2 g = s_f[k];
      const double dx = x - s.x;
      const double dy = y - s.y;
      double r2 = fma(dy, dy, dx * dx);
      r2 = r2 < lc.min_r2 ? lc.min_r2 : r2;
      const double lg = fp64::log_pos(r2, my_log, lc);
      const double d = fma(dy, g.y, dx * g.x) * fp64::rcp_pos(r2);
      ul = fma(lg, g.x, ul);
      ud = fma(dx, d, ud);
      vl = fma(lg, g.y, vl);
      vd = fma(dy, d, vd);
      pd += d;
    }
    __syncthreads();
  }
  if (!live) return;
  const double su = fma(-0.5, ul, ud);
  const double sv = fma(-0.5, vl, vd);
  if (gridDim.y == 1) {
    u[t] = su * kInvFourPi;
    v[t] = sv * kInvFourPi;
    p[t] = pd * kInvTwoPi;
  } else {
    double* mine = part + static_cast<int64_t>(blockIdx.y) * 3 * T + t;
    mine[0] = su;
    mine[T] = sv;
    mine[2 * T] = pd;
  }
}

// out[i] = log(in[i]), out[n + i] = 1 / in[i], out[2 n + i] = 1 / sqrt(in[i]),
// out[3 n + i] = exp(-min(in[i], 700)) by fp64_math.cuh: the probe that holds
// the device math to the library's.
__global__ void __launch_bounds__(kBlock)
fp64_math_probe_kernel(const double* __restrict__ in, double* __restrict__ out,
                       int64_t n, const double* __restrict__ log_table,
                       const double* __restrict__ exp_table) {
  __shared__ double2 s_log[fp64::kLogShared];
  __shared__ double s_exp[fp64::kExpShared];
  const double* my_exp =
      fp64::stage_exp_table(exp_table, s_exp, threadIdx.x, kBlock);
  const fp64::ExpConsts ec = fp64::load_exp_consts(exp_table);
  const double2* my_log =
      fp64::stage_log_table(log_table, s_log, threadIdx.x, kBlock);
  const fp64::LogConsts lc = fp64::load_log_consts(log_table);
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n) return;
  const double a = in[i];
  out[i] = fp64::log_pos(a, my_log, lc);
  out[n + i] = fp64::rcp_pos(a);
  out[2 * n + i] = fp64::rsqrt_pos(a);
  out[3 * n + i] = fp64::exp_neg(-fmin(a, 700.0), my_exp, ec);
}

}  // namespace

// The number of source ranges a launch of T targets and S sources is split
// into (1: none): the wrapper sizes the scratch array from it.
extern "C" int stokes_slp_split_count(int64_t T, int64_t S) {
  return fp64::plan_split(T, S, kBlock, kFillBlocks).splits;
}

// `scratch` holds at least 3 * splits * T doubles when splits > 1.
extern "C" int stokes_slp_apply_f64(const double* sx, const double* sy,
                                    const double* fx, const double* fy,
                                    int64_t S, const double* tx,
                                    const double* ty, double* u, double* v,
                                    double* p, int64_t T,
                                    const double* log_table, double* scratch,
                                    int64_t scratch_len, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const fp64::SplitPlan plan = fp64::plan_split(T, S, kBlock, kFillBlocks);
  if (plan.splits > 1 && scratch_len < 3 * plan.splits * T) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(
      static_cast<unsigned>((T + kBlock - 1) / kBlock),
      static_cast<unsigned>(plan.splits));
  stokes_slp_kernel<<<grid, kBlock, 0, st>>>(sx, sy, fx, fy, S, plan.chunk, tx,
                                             ty, u, v, p, scratch, T,
                                             log_table);
  err = cudaGetLastError();
  if (err != cudaSuccess || plan.splits == 1) return static_cast<int>(err);
  const fp64::SplitOutputs<3> outs{{u, v, p},
                                   {kInvFourPi, kInvFourPi, kInvTwoPi}};
  fp64::combine_splits_kernel<3>
      <<<static_cast<unsigned>((T + 255) / 256), 256, 0, st>>>(
          scratch, plan.splits, outs, T);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fp64_math_probe_f64(const double* in, double* out, int64_t n,
                                   const double* log_table,
                                   const double* exp_table, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  fp64_math_probe_kernel<<<static_cast<unsigned>((n + kBlock - 1) / kBlock),
                           kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, n, log_table, exp_table);
  return static_cast<int>(cudaGetLastError());
}
