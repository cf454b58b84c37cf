"""What an FP64 instruction costs on the card, beside what the kernels' inner
loops put around it.

    python3 tools/torch_fp64_issue_probe.py [--blocks-per-sm 8] [--iters 20000]

Builds one small CUDA program (nvcc, sm_90a, into ``build/``) and runs it:
every thread runs a loop of 8 independent DFMA chains, alone and with one
more piece per iteration, and the program prints the cycles one scheduler
(one SM quarter) spends per iteration, from the kernel's time, the SM clock
that ``nvidia-smi`` reports under that load and the card's SM count:
  * uniform: x = fma(x, a, b) with a, b kernel arguments (constant bank);
  * registers: x = fma(x, p, q) with p, q in registers, three different
    register operands per instruction;
  * registers + one I2F.F64, one MUFU.RCP64H, one 16-byte shared-memory load
    at a per-lane address (the log table's lookup, with its three integer
    instructions), one DSETP and two selects (the clamp of r^2), or one
    broadcast 16-byte shared-memory load (a source tile's).
The kernels of ``ipde_tpu_torch/csrc`` are bound by the schedulers' instruction
rate, and
this is the measurement behind their designs: which operands an FP64
instruction may take at its full rate, and what the instructions beside it
add.  Needs the CUDA toolkit and one card; no torch.
"""

import argparse
import os
import shutil
import subprocess
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r"""
#include <cstdio>
#include <cstdlib>
#include <cuda_runtime.h>
constexpr int C = 8;
template <int MODE>
__global__ void __launch_bounds__(128)
probe(double* out, const double* in, int n, double a, double b, int m) {
  __shared__ double2 tab[512];
  for (int i = threadIdx.x; i < 512; i += 128) {
    tab[i] = make_double2(in[i % 64], in[(i + 7) % 64]);
  }
  __syncthreads();
  double x[C], p[C], q[C];
  for (int i = 0; i < C; ++i) {
    x[i] = in[threadIdx.x % 64] + i;
    p[i] = in[(threadIdx.x + i) % 64];
    q[i] = in[(threadIdx.x + 2 * i + 1) % 64];
  }
  int y = threadIdx.x + m;
  double extra = 0.0;
  const double2* mine = tab + (threadIdx.x & 7);
  for (int it = 0; it < n; ++it) {
#pragma unroll
    for (int i = 0; i < C; ++i) {
      x[i] = MODE == 0 ? fma(x[i], a, b) : fma(x[i], p[i], q[i]);
    }
    if (MODE == 2) { y = (y ^ m) + 3; extra += __int2double_rn(y >> 20); }
    if (MODE == 3) {
      double r;
      asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x[0]));
      extra += r;
    }
    if (MODE == 4) {
      y = (__double2hiint(x[1]) >> 3) & 63;
      const double2 t = mine[y * 8];
      extra += t.x;
      p[2] = t.y;
    }
    if (MODE == 5) { extra += x[3] < a ? a : x[3]; }
    if (MODE == 6) {
      const double2 t = tab[it & 255];
      extra += t.x;
      p[2] = t.y;
    }
  }
  double s = extra + y;
  for (int i = 0; i < C; ++i) s += x[i];
  out[blockIdx.x * 128 + threadIdx.x] = s;
}
template <int MODE>
void run(const char* name, int blocks, int n, double hz, int sms,
         const double* in) {
  double* out;
  cudaMalloc(&out, sizeof(double) * blocks * 128);
  probe<MODE><<<blocks, 128>>>(out, in, 100, 0.999, 1e-3, 5);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  probe<MODE><<<blocks, 128>>>(out, in, n, 0.999, 1e-3, 5);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double warp_iters = 4.0 * blocks * n;
  printf("%-46s %8.3f ms  %6.2f cycles per iteration of 8 DFMA\n", name, ms,
         ms * 1e-3 * hz * 4 * sms / warp_iters);
  cudaFree(out);
}
int main(int argc, char** argv) {
  const int per_sm = atoi(argv[1]), n = atoi(argv[2]);
  const double hz = atof(argv[3]) * 1e6;
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  const int sms = prop.multiProcessorCount, blocks = sms * per_sm;
  double h[64];
  for (int i = 0; i < 64; ++i) h[i] = 0.5 + 0.001 * i;
  double* in;
  cudaMalloc(&in, sizeof h);
  cudaMemcpy(in, h, sizeof h, cudaMemcpyHostToDevice);
  printf("%s, %d SMs, %d blocks of 128 threads, %d iterations, %.0f MHz\n",
         prop.name, sms, blocks, n, hz * 1e-6);
  run<0>("uniform operands", blocks, n, hz, sms, in);
  run<1>("three register operands", blocks, n, hz, sms, in);
  run<2>("registers + I2F.F64 (+ 2 integer, 1 DADD)", blocks, n, hz, sms, in);
  run<3>("registers + MUFU.RCP64H (+ 1 DADD)", blocks, n, hz, sms, in);
  run<4>("registers + per-lane LDS.128 (+ 3 integer, 1 DADD)", blocks, n, hz,
         sms, in);
  run<5>("registers + DSETP, 2 FSEL (+ 1 DADD)", blocks, n, hz, sms, in);
  run<6>("registers + broadcast LDS.128 (+ 1 DADD)", blocks, n, hz, sms, in);
  return cudaDeviceSynchronize() == cudaSuccess ? 0 : 1;
}
"""


def tool(name):
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found")
    return path


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader,nounits"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks-per-sm", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20000)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        src, exe = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "probe")
        with open(src, "w") as fh:
            fh.write(SOURCE)
        subprocess.run([tool("nvcc"), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-O3", "-o", exe, src],
                       check=True)
        # the SM clock under this load: sampled while a long run is going
        load = subprocess.Popen([exe, str(args.blocks_per_sm),
                                 str(args.iters * 400), "1"],
                                stdout=subprocess.DEVNULL)
        try:
            clocks = []
            while load.poll() is None:
                clocks.append(float(smi("clocks.sm")))
        finally:
            load.wait()
        mhz = max(clocks)
        print(f"# SM clock under load {mhz:.0f} MHz ({len(clocks)} samples)")
        subprocess.run([exe, str(args.blocks_per_sm), str(args.iters),
                        str(mhz)], check=True)


if __name__ == "__main__":
    main()
