// Helpers shared by the flash-attention forward (flash_attention.cu) and
// backward (flash_attention_bwd.cu) kernels: the base-2 exponential the
// softmax runs on, the logsumexp in that base, the aligned start of dynamic
// shared memory for SW128 tiles, the bf16 store of an m64nN accumulator,
// the cp.async load of an f32 tile, and the opt-in to more than 48 KB of
// dynamic shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace ptt {
namespace sm90 {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x by the SFU alone (ex2.approx.ftz: about 2 ulp, results below 2^-126
// flushed to 0); exp2f wraps the same instruction in a subnormal-safe scaling
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// lse in the exp2 domain; +inf for a row that sees no key, so that p = 0
__device__ __forceinline__ float lse_log2(float lse) {
  return lse == -INFINITY ? INFINITY : lse * kLog2e;
}

// the 1024-byte-aligned start of dynamic shared memory (tiles are SW128)
__device__ __forceinline__ __nv_bfloat16* smem_base(unsigned char* raw) {
  return reinterpret_cast<__nv_bfloat16*>(raw + ((1024 - (smem_u32(raw) & 1023)) & 1023));
}

// rows r and r + 8 of an m64nN accumulator, columns [0, d), rounded to bf16
// and stored at dst + row * stride; rows >= rows_valid are not stored
template <int R>
__device__ __forceinline__ void store_acc(const float (&acc)[R], __nv_bfloat16* dst,
                                          int64_t stride, int r, int rows_valid, int d,
                                          int quad) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r + 8 * i >= rows_valid) continue;
    __nv_bfloat16* row = dst + (r + 8 * i) * stride;
#pragma unroll
    for (int j = 0; j < R / 4; ++j) {
      const int c = 8 * j + 2 * quad;
      if (c < d)
        *reinterpret_cast<__nv_bfloat162*>(row + c) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

// ROWS x DP floats of src (row stride `stride` floats) into a [ROWS][DP + 4]
// tile by cp.async, 16 bytes a copy, neighbouring threads on neighbouring
// chunks; rows >= rows_valid and columns >= d are zero
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void load_f32_tile(float* tile, const float* src, int64_t stride,
                                              int rows_valid, int d, int tid) {
  constexpr int kChunks = DP / 4;
  static_assert((ROWS * kChunks) % THREADS == 0, "whole tiles a pass");
#pragma unroll
  for (int n = 0; n < ROWS * kChunks / THREADS; ++n) {
    const int e = tid + n * THREADS;
    const int r = e / kChunks, c = (e % kChunks) * 4;
    const bool valid = r < rows_valid && c < d;
    cp_async16(smem_u32(tile + r * (DP + 4) + c), valid ? src + r * stride + c : src, valid);
  }
}

// allow `smem` bytes of dynamic shared memory (above the default 48 KB) and
// prefer the largest shared-memory carveout
template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              static_cast<int>(cudaSharedmemCarveoutMaxShared));
}

}  // namespace sm90
}  // namespace ptt
