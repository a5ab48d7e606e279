#!/usr/bin/env python3
"""The issue rate of ``mma.sync.m16n8k8`` TF32 with fp32 accumulation, the
tensor-core instruction of the trunk kernels, on one NVIDIA GPU:
``python3 scripts/torch_mma_rate.py`` from the root of a checkout.

One block per SM, W warps a block, each warp issuing ``iters`` rounds of C
independent mma (C accumulator sets, no loads, no other work). Each block
times its rounds with ``clock64`` between two barriers; the script prints,
for each (W, C), the mma a clock an SM (the block's mma over its cycles,
the slowest block) and the TF32 rate they give at the clock CUDA events
show (2048 FLOP an mma), beside the 495 TFLOP/s of the data sheet. That is
the most any kernel made of these instructions can reach; the trunk
kernels' products are bound by it.
"""

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r'''
#include <cuda_runtime.h>

template <int C>
__global__ void mma_rate_kernel(float* out, long long* cycles, int iters) {
  float acc[C][4];
#pragma unroll
  for (int j = 0; j < C; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // TF32 operands (low 13 bits clear), different in each lane
  const unsigned a = __float_as_uint(1.f + 1e-3f * threadIdx.x) & 0xFFFFE000u;
  const unsigned b = __float_as_uint(1.f - 1e-3f * threadIdx.x) & 0xFFFFE000u;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a), "r"(a), "r"(a), "r"(a), "r"(b), "r"(b));
  }
  __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < C; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s += acc[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int mma_rate(int chains, int blocks, int threads, int iters,
                        float* out, long long* cycles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chains) {
    case 2:
      mma_rate_kernel<2><<<blocks, threads, 0, s>>>(out, cycles, iters);
      break;
    case 4:
      mma_rate_kernel<4><<<blocks, threads, 0, s>>>(out, cycles, iters);
      break;
    case 8:
      mma_rate_kernel<8><<<blocks, threads, 0, s>>>(out, cycles, iters);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
'''

WARPS = (4, 8, 12, 16, 32)
CHAINS = (2, 4, 8)
ITERS = 4096


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit('torch_mma_rate: no CUDA device')
    sys.path.insert(0, REPO)
    import chip_smoke as c
    from handyrl_tpu_torch.ops import cuda_build
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(cuda_build.BUILD_DIR, 'mma_rate.cu')
    lib_path = os.path.join(cuda_build.BUILD_DIR, 'libmma_rate.so')
    with open(src, 'w') as f:
        f.write(SOURCE)
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, '-o',
                    lib_path, src], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mma_rate.argtypes = [i, i, i, i, p, p, p]
    lib.mma_rate.restype = ctypes.c_int
    print(c.nvidia_smi_line(), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for warps in WARPS:
        for chains in CHAINS:
            out = torch.empty(sms * 32 * warps, device='cuda')
            cycles = torch.empty(sms, device='cuda', dtype=torch.int64)

            def launch():
                err = lib.mma_rate(chains, sms, 32 * warps, ITERS,
                                   out.data_ptr(), cycles.data_ptr(), stream)
                if err:
                    sys.exit('torch_mma_rate: launch failed (%d)' % err)
            ms = c.cuda_time_ms(torch, launch, 5)
            mma = warps * chains * ITERS   # a block's (one SM's)
            per_clock = mma / cycles.max().item()
            tflops = sms * mma * 2048 / (ms * 1e-3) / 1e12
            print('warps %2d chains %d: %.4f mma a clock an SM (%d cycles); '
                  '%.4f ms a launch, %.1f TFLOP/s TF32 (%.1f%% of 495)' % (
                      warps, chains, per_clock, cycles.max().item(), ms,
                      tflops, tflops / 4.95), flush=True)


if __name__ == '__main__':
    main()
