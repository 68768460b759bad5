#!/usr/bin/env python3
"""What ``mma.sync`` and shared memory can deliver on this card.

The port's attention kernels multiply with warp-level ``mma.sync`` and feed
it from shared memory with ``ldmatrix``. Their bounds in ``chip_smoke.py`` use
the data-sheet peaks, which only ``wgmma`` reaches; this script measures the
ceilings the present route has, so that a kernel's distance from its bound
can be split into what the route costs and what the kernel leaves:

* ``mma.sync`` m16n8k16 bf16 and m16n8k8 TF32, 8 independent accumulators a
  warp, 4 to 32 warps per SM: TFLOP/s and ns per mma per scheduler;
* ``ldmatrix.x4`` (plain and ``.trans``) at the kernels' two row pitches (208
  and 400 bytes at D = 96), ``ld.shared.v4`` and ``ld.shared.u32``: bytes per
  clock per SM at the card's maximum SM clock.

Two small CUDA programs are written to ``build/card_ceilings/``, compiled with
nvcc for sm_90a and run. Needs an NVIDIA GPU and nvcc:

    python3 card_ceilings.py
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

from versband_tpu_torch.ops._build import find_nvcc

MMA = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
template <int TF32>
__global__ void k(float* out, int iters) {
  float c[8][4];
  for (int i = 0; i < 8; ++i) for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  uint32_t b0 = threadIdx.x * 3, b1 = threadIdx.x * 5;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (TF32)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0;
  for (int i = 0; i < 8; ++i) for (int j = 0; j < 4; ++j) s += c[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main() {
  cudaDeviceProp prop; cudaGetDeviceProperties(&prop, 0);
  const int sms = prop.multiProcessorCount;
  float* out; cudaMalloc(&out, sms * 1024 * 4);
  for (int tf32 = 0; tf32 < 2; ++tf32)
    for (int warps = 4; warps <= 32; warps *= 2) {
      const int iters = 20000;
      cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
      for (int rep = 0; rep < 2; ++rep) {  // the second run is the warm one
        cudaEventRecord(e0);
        if (tf32) k<1><<<sms, warps * 32>>>(out, iters); else k<0><<<sms, warps * 32>>>(out, iters);
        cudaEventRecord(e1); cudaEventSynchronize(e1);
      }
      float ms; cudaEventElapsedTime(&ms, e0, e1);
      const double mmas = (double)iters * 8 * warps;  // per SM
      printf("[mma] %s %2d warps/SM: %.3f ms, %.1f TFLOP/s, %.2f ns per mma per scheduler\n",
             tf32 ? "m16n8k8 tf32 " : "m16n8k16 bf16", warps, ms,
             mmas * sms * (tf32 ? 2048.0 : 4096.0) / ms / 1e9, ms * 1e6 / (mmas / 4));
    }
  return cudaGetLastError() != cudaSuccess;
}
"""

LDS = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
template <int MODE>
__global__ void k(uint32_t* out, int iters, int pitch) {
  extern __shared__ __align__(16) unsigned char smem[];
  for (int i = threadIdx.x; i < 64 * 1024 / 4; i += blockDim.x) ((uint32_t*)smem)[i] = i;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem) + (warp & 3) * 16 * pitch;
  const uint32_t addr = base + (lane & 15) * pitch + (lane >> 4) * 16;
  uint32_t acc = 0;
  for (int it = 0; it < iters; ++it) {
    const uint32_t o = (it & 3) * 16 * pitch + ((it >> 2) & 1) * 256;  // no load is loop-invariant
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      uint32_t r[4] = {0, 0, 0, 0};
      if (MODE == 0)
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr + o + u * 32));
      else if (MODE == 1)
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr + o + u * 32));
      else if (MODE == 2)
        asm volatile("ld.volatile.shared.v4.u32 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                     : "r"(base + o + lane * 16 + u * 512));
      else
        asm volatile("ld.volatile.shared.u32 %0, [%1];\n"
                     : "=r"(r[0]) : "r"(base + o + lane * 4 + u * 128));
      acc ^= r[0] ^ r[1] ^ r[2] ^ r[3];
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
int main() {
  cudaDeviceProp prop; cudaGetDeviceProperties(&prop, 0);
  const int sms = prop.multiProcessorCount;
  int khz; cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  uint32_t* out; cudaMalloc(&out, sms * 1024 * 4);
  const char* names[] = {"ldmatrix.x4", "ldmatrix.x4.trans", "ld.shared.v4", "ld.shared.u32"};
  for (int mode = 0; mode < 4; ++mode)
    for (int pitch : {208, 400})
      for (int warps = 8; warps <= 32; warps *= 2) {
        const int iters = 20000;
        auto fn = mode == 0 ? k<0> : mode == 1 ? k<1> : mode == 2 ? k<2> : k<3>;
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, 64 * 1024);
        cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
        for (int rep = 0; rep < 2; ++rep) {
          cudaEventRecord(e0);
          fn<<<sms, warps * 32, 64 * 1024>>>(out, iters, pitch);
          cudaEventRecord(e1); cudaEventSynchronize(e1);
        }
        float ms; cudaEventElapsedTime(&ms, e0, e1);
        const double bytes = (double)iters * 8 * warps * (mode == 3 ? 128 : 512);  // per SM
        printf("[smem] %-17s pitch %3d B, %2d warps/SM: %.3f ms, %.1f B/clk/SM at %d MHz\n",
               names[mode], pitch, warps, ms, bytes / (ms * 1e-3 * khz * 1e3), khz / 1000);
      }
  return cudaGetLastError() != cudaSuccess;
}
"""


def main() -> int:
    out = Path("build") / "card_ceilings"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    jobs = []
    for name, src in (("mma_peak", MMA), ("smem_peak", LDS)):
        (out / f"{name}.cu").write_text(src)
        jobs.append((name, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o", str(out / name),
             str(out / f"{name}.cu")])))
    rc = 0
    for name, job in jobs:
        rc |= job.wait()
    for name, _ in jobs:
        if rc == 0:
            rc |= subprocess.run([str(out / name)], timeout=300).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
