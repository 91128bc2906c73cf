// Shared helpers of the port's Hopper kernels: element conversion (bf16,
// int8 and e4m3 to f32), warp and block sums, and the error-string export that
// every kernel library carries for its ctypes wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ptt {

// dtype codes passed by the Python wrappers
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// N consecutive elements at p (aligned to N elements) into f32 registers,
// in one vector load where N * sizeof(T) allows
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[N]) {
  const Vec<T, N> x = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32(x.v[i]);
}

// N f32 registers rounded to T and stored at p (aligned to N elements) in
// one vector store
template <typename T, int N>
__device__ __forceinline__ void store_f32(T* p, const float (&in)[N]) {
  Vec<T, N> x;
#pragma unroll
  for (int i = 0; i < N; ++i) x.v[i] = from_f32<T>(in[i]);
  *reinterpret_cast<Vec<T, N>*>(p) = x;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block; blockDim.x a multiple of 32, at most 1024.  Call once
// per kernel (the partials array is reused without a trailing barrier).
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    v = warp_sum(lane < nwarps ? part[lane] : 0.f);
    if (lane == 0) part[0] = v;
  }
  __syncthreads();
  return part[0];
}

}  // namespace ptt

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
