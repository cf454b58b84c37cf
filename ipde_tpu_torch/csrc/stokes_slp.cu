// Stokeslet (Stokes single-layer) velocity and pressure, dense FP64 sum, for
// Hopper (sm_90a).  With dx = tx_i - sx_j, dy = ty_i - sy_j,
// r2 = max(dx^2 + dy^2, 1e-30) and ilr = -log(r2) / 2:
//
//   u(t_i) = sum_j [(ilr + dx^2/r2) fx_j + (dx dy/r2) fy_j] / (4 pi)
//   v(t_i) = sum_j [(dx dy/r2) fx_j + (ilr + dy^2/r2) fy_j] / (4 pi)
//   p(t_i) = sum_j (dx fx_j + dy fy_j) / r2 / (2 pi)
//
// evaluated per pair as d = (dx fx + dy fy) / r2, u += ilr fx + dx d,
// v += ilr fy + dy d, p += d: one log and one reciprocal per pair.
//
// Replaces the Pallas kernel `_stokes_update` (ipde_tpu/ops/pallas_ds.py),
// reached there through `pallas_ds.stokes_slp_apply`.  The TPU kernel works
// in double-single (hi/lo f32) arithmetic in (8, 256) target tiles with at
// most 128 sources per call in SMEM, because Mosaic has no f64; the H100 has
// native FP64, so none of that carries over.  The r^2 clamp at 1e-30 is the
// TPU kernel's (pallas_ds.py `_pair_geometry`): a coincident pair stays
// finite.
//
// Bound: FP64 throughput.  Each target-source pair costs a double log, a
// double reciprocal and about 16 adds, multiplies and FMAs, while the data
// moved is O(T + S) doubles: the pairs never touch device memory.  Design,
// simple first (the shape of laplace_slp.cu):
//   * one thread per target, blocks of 256 threads;
//   * tiles of 256 sources (x, y, fx, fy) are staged through shared memory,
//     so a source is read from device memory once per block;
//   * three FP64 register accumulators (u, v, p), scaled once at the end;
//   * the ragged ends of both ranges are masked in the kernel, so nothing is
//     padded on the host.
// A small target count (the radial-group launches, 8,400-19,200 targets)
// gives only 33-75 blocks and underfills the 132 SMs; later work splits the
// sources across blocks for such calls.
//
// C interface (bound with ctypes): returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr double kInvFourPi = 0.079577471545947667884;  // 1 / (4 pi)
constexpr double kInvTwoPi = 0.15915494309189533577;    // 1 / (2 pi)
constexpr double kMinR2 = 1e-30;

__global__ void __launch_bounds__(kBlock)
stokes_slp_kernel(const double* __restrict__ sx, const double* __restrict__ sy,
                  const double* __restrict__ fx, const double* __restrict__ fy,
                  int64_t S, const double* __restrict__ tx,
                  const double* __restrict__ ty, double* __restrict__ u,
                  double* __restrict__ v, double* __restrict__ p, int64_t T) {
  __shared__ double s_x[kBlock];
  __shared__ double s_y[kBlock];
  __shared__ double s_fx[kBlock];
  __shared__ double s_fy[kBlock];
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const bool live = t < T;
  const double x = live ? tx[t] : 0.0;
  const double y = live ? ty[t] : 0.0;
  double au = 0.0, av = 0.0, ap = 0.0;
  for (int64_t j0 = 0; j0 < S; j0 += kBlock) {
    const int64_t j = j0 + threadIdx.x;
    if (j < S) {
      s_x[threadIdx.x] = sx[j];
      s_y[threadIdx.x] = sy[j];
      s_fx[threadIdx.x] = fx[j];
      s_fy[threadIdx.x] = fy[j];
    }
    __syncthreads();
    const int n = static_cast<int>(S - j0 < kBlock ? S - j0 : kBlock);
    for (int k = 0; k < n; ++k) {
      const double dx = x - s_x[k];
      const double dy = y - s_y[k];
      const double r2 = fmax(dx * dx + dy * dy, kMinR2);
      const double ir2 = 1.0 / r2;
      const double ilr = -0.5 * log(r2);
      const double gx = s_fx[k];
      const double gy = s_fy[k];
      const double d = (dx * gx + dy * gy) * ir2;
      au += ilr * gx + dx * d;
      av += ilr * gy + dy * d;
      ap += d;
    }
    __syncthreads();
  }
  if (live) {
    u[t] = au * kInvFourPi;
    v[t] = av * kInvFourPi;
    p[t] = ap * kInvTwoPi;
  }
}

}  // namespace

extern "C" int stokes_slp_apply_f64(const double* sx, const double* sy,
                                    const double* fx, const double* fy,
                                    int64_t S, const double* tx,
                                    const double* ty, double* u, double* v,
                                    double* p, int64_t T, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (T + kBlock - 1) / kBlock;
  stokes_slp_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      sx, sy, fx, fy, S, tx, ty, u, v, p, T);
  return static_cast<int>(cudaGetLastError());
}
