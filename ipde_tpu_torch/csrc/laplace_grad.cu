// Gradient of the Laplace single-layer potential, dense FP64 sum, for Hopper
// (sm_90a).
//
//   gx(t_i) = -sum_j dx_ij q_j / max(r_ij^2, 1e-30) / (2 pi)
//   gy(t_i) = -sum_j dy_ij q_j / max(r_ij^2, 1e-30) / (2 pi)
//
// with (dx, dy) = t_i - s_j.  Replaces the Pallas kernel `_grad_update`
// (ipde_tpu/ops/pallas_ds.py), reached there through
// `pallas_ds.laplace_slp_grad_apply`.  The TPU kernel works in double-single
// (hi/lo f32) arithmetic because Mosaic has no f64; the H100 has native FP64,
// so this kernel keeps two FP64 register accumulators.  The r^2 clamp at
// 1e-30 is the TPU kernel's (pallas_ds.py `_pair_geometry`), so coincident
// pairs stay finite.
//
// Bound: FP64 throughput.  Each target-source pair costs one double
// reciprocal and a few FMAs, and the data moved is O(T + S) doubles: the
// pairs never touch device memory.  The design is laplace_slp.cu's: one
// thread per target in blocks of 256; tiles of 256 sources (x, y, q) staged
// through shared memory; the ragged ends of both ranges masked in the kernel.
//
// C interface (bound with ctypes): returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr double kInvTwoPi = 0.15915494309189533577;  // 1 / (2 pi)
constexpr double kMinR2 = 1e-30;

__global__ void __launch_bounds__(kBlock)
laplace_grad_kernel(const double* __restrict__ sx,
                    const double* __restrict__ sy,
                    const double* __restrict__ q, int64_t S,
                    const double* __restrict__ tx,
                    const double* __restrict__ ty, double* __restrict__ gx,
                    double* __restrict__ gy, int64_t T) {
  __shared__ double s_x[kBlock];
  __shared__ double s_y[kBlock];
  __shared__ double s_q[kBlock];
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const bool live = t < T;
  const double x = live ? tx[t] : 0.0;
  const double y = live ? ty[t] : 0.0;
  double ax = 0.0;
  double ay = 0.0;
  for (int64_t j0 = 0; j0 < S; j0 += kBlock) {
    const int64_t j = j0 + threadIdx.x;
    if (j < S) {
      s_x[threadIdx.x] = sx[j];
      s_y[threadIdx.x] = sy[j];
      s_q[threadIdx.x] = q[j];
    }
    __syncthreads();
    const int n = static_cast<int>(S - j0 < kBlock ? S - j0 : kBlock);
    for (int k = 0; k < n; ++k) {
      const double dx = x - s_x[k];
      const double dy = y - s_y[k];
      const double c = (1.0 / fmax(dx * dx + dy * dy, kMinR2)) * s_q[k];
      ax -= dx * c;
      ay -= dy * c;
    }
    __syncthreads();
  }
  if (live) {
    gx[t] = ax * kInvTwoPi;
    gy[t] = ay * kInvTwoPi;
  }
}

}  // namespace

extern "C" int laplace_grad_apply_f64(const double* sx, const double* sy,
                                      const double* q, int64_t S,
                                      const double* tx, const double* ty,
                                      double* gx, double* gy, int64_t T,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (T + kBlock - 1) / kBlock;
  laplace_grad_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(sx, sy, q, S, tx,
                                                             ty, gx, gy, T);
  return static_cast<int>(cudaGetLastError());
}
