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

// ---------------------------------------------------------------------------
// The norm backwards B1b (rms_norm.cu) and B11b (fused_ln_swiglu.cu) share
// their layout.  A block owns one row at a time and walks rows blockIdx.x,
// blockIdx.x + gridDim.x, ... of a persistent grid.  Each thread owns fixed
// column slots, 8 or 16 columns in all (16-byte vectors where h and the
// pointers allow, else single elements): it keeps the row's inputs in
// registers between the row sum and the dx write, loads the next row before
// this row's sum, and accumulates its columns' share of dw (and db) in f32
// registers.  A row wider than kNormBwdMaxThreads times a thread's columns
// is cut into segments (blockIdx.y), whose row sums a pre-pass computes.
// Each block writes one f32 partial row; norm_bwd_col_sum_kernel sums them.
// ---------------------------------------------------------------------------
constexpr int kNormBwdElems = 16;        // most columns a thread owns in a segment
constexpr int kNormBwdMaxThreads = 512;  // threads a row segment (<= 128 registers)
constexpr int kColSumCols = 16;          // columns a block of the column sum
constexpr int kColSumLanes = 16;         // threads summing one column

struct NormBwdGeom {
  int threads, segs;
};

// threads a block and segments a row for h columns in vectors of n
// elements, `elems` columns a thread
inline NormBwdGeom norm_bwd_geom(int h, int n, int elems) {
  const int nvec = h / n, v = elems / n;
  const int need = (nvec + v - 1) / v;  // threads for the row in one segment
  if (need <= kNormBwdMaxThreads) return {(need + 31) / 32 * 32, 1};
  return {kNormBwdMaxThreads, (nvec + kNormBwdMaxThreads * v - 1) / (kNormBwdMaxThreads * v)};
}

// Each of K values summed over the block, returned to every thread.  part is
// [2][K][32] in shared memory and parity flips a call, so one barrier a call
// suffices: a thread writes part[p] again only two calls later, after every
// thread has passed the barrier of the call in between.
template <int K>
__device__ __forceinline__ void block_sums(float (&v)[K], float (*part)[K][32], int& parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = warp_sum(v[k]);
    if (lane == 0) part[parity][k][warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float t = 0.f;
    for (int i = 0; i < nw; ++i) t += part[parity][k][i];
    v[k] = t;
  }
  parity ^= 1;
}

// out[c] (c < h) or out2[c - h] (h <= c < cols) = the sum of column c of
// part [parts][cols] in a fixed order: kColSumLanes threads take every
// kColSumLanes-th row, then one adds their sums in lane order.  Grid:
// ceil(cols / kColSumCols) blocks of kColSumCols * kColSumLanes threads.
template <typename W>
__global__ void __launch_bounds__(kColSumCols * kColSumLanes)
norm_bwd_col_sum_kernel(const float* __restrict__ part, W* __restrict__ out,
                        W* __restrict__ out2, int parts, int cols, int h) {
  __shared__ float sums[kColSumLanes][kColSumCols];
  const int col = threadIdx.x % kColSumCols, lane = threadIdx.x / kColSumCols;
  const int c = blockIdx.x * kColSumCols + col;
  float s = 0.f;
  if (c < cols) {
#pragma unroll 4
    for (int i = lane; i < parts; i += kColSumLanes) s += part[static_cast<int64_t>(i) * cols + c];
  }
  sums[lane][col] = s;
  __syncthreads();
  if (lane == 0 && c < cols) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kColSumLanes; ++i) t += sums[i][col];
    if (c < h) out[c] = from_f32<W>(t);
    else out2[c - h] = from_f32<W>(t);
  }
}

template <typename W>
cudaError_t launch_col_sum(const float* part, W* out, W* out2, int parts, int cols, int h,
                           cudaStream_t s) {
  norm_bwd_col_sum_kernel<W><<<(cols + kColSumCols - 1) / kColSumCols,
                               kColSumCols * kColSumLanes, 0, s>>>(part, out, out2, parts,
                                                                   cols, h);
  return cudaGetLastError();
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace ptt

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
