// Laplace single-layer potential, dense FP64 sum, for Hopper (sm_90a).
//
//   u(t_i) = sum_j -log(max(|t_i - s_j|^2, 1e-30)) q_j / (4 pi)
//
// Replaces the Pallas kernel `_laplace_update` (ipde_tpu/ops/pallas_ds.py),
// reached there through `pallas_ds.laplace_slp_apply`.  The TPU kernel works
// in double-single (hi/lo f32) arithmetic because Mosaic has no f64; the H100
// has native FP64, so this kernel accumulates in one FP64 register with
// CUDA's double `log`.  The r^2 clamp at 1e-30 is the TPU kernel's
// (pallas_ds.py `_pair_geometry`), so coincident pairs stay finite.
//
// Bound: FP64 throughput.  Each target-source pair costs one double log and a
// few FMAs, and the data moved is O(T + S) doubles: the pairs never touch
// device memory.  Design, simple first:
//   * one thread per target, blocks of 256 threads;
//   * tiles of 256 sources (x, y, q) are staged through shared memory, so a
//     source is read from device memory once per block, not once per thread;
//   * the ragged ends of both the target and the source ranges are masked in
//     the kernel, so nothing is padded on the host.
// A small target count, such as the 1,200 interface targets of the Poisson
// solve at nb=1200, gives only 5 blocks and underfills the 132 SMs.  Later
// work splits the sources across blocks for such calls, and tunes the tile.
//
// C interface (bound with ctypes): returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr double kInvFourPi = 0.079577471545947667884;  // 1 / (4 pi)
constexpr double kMinR2 = 1e-30;

__global__ void __launch_bounds__(kBlock)
laplace_slp_kernel(const double* __restrict__ sx, const double* __restrict__ sy,
                   const double* __restrict__ q, int64_t S,
                   const double* __restrict__ tx, const double* __restrict__ ty,
                   double* __restrict__ out, int64_t T) {
  __shared__ double s_x[kBlock];
  __shared__ double s_y[kBlock];
  __shared__ double s_q[kBlock];
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
    __syncthreads();
    const int n = static_cast<int>(S - j0 < kBlock ? S - j0 : kBlock);
    for (int k = 0; k < n; ++k) {
      const double dx = x - s_x[k];
      const double dy = y - s_y[k];
      const double r2 = fmax(dx * dx + dy * dy, kMinR2);
      acc -= log(r2) * s_q[k];
    }
    __syncthreads();
  }
  if (live) out[t] = acc * kInvFourPi;
}

}  // namespace

extern "C" int laplace_slp_apply_f64(const double* sx, const double* sy,
                                     const double* q, int64_t S,
                                     const double* tx, const double* ty,
                                     double* out, int64_t T, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (T + kBlock - 1) / kBlock;
  laplace_slp_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(sx, sy, q, S, tx,
                                                            ty, out, T);
  return static_cast<int>(cudaGetLastError());
}
