// B1: RMSNorm forward over the last axis, and B1b, its backward.
//
// Replaces paddle_tpu/ops/pallas/fused_norm.py: fused_rms_norm -> _rms_fwd
// -> _fwd_kernel (pallas_call at fused_norm.py:88).  Same function: the sum
// of squares in f32, rstd = rsqrt(mean + eps), out = x * rstd * w in f32,
// cast to x's dtype last; rstd [n] in f32 is returned for the backward.
//
// Bound on the H100: bytes.  Per row it reads H elements and writes H, for
// about 4 operations an element, far below the ~20 f32 operations per byte
// where the card's arithmetic would become the limit.  Design: one block of
// 256 threads per row, so that every SM holds several rows in flight and
// neighbouring threads read neighbouring elements (coalesced).  The second
// sweep over the row re-reads it from L1/L2, not from device memory.  The
// TPU kernel's row blocks sized to VMEM do not carry over: rows are
// independent, so the grid is simply the rows.
//
// B1b replaces fused_norm.py: _rms_bwd -> _bwd_kernel (pallas_call at
// fused_norm.py:112).  Same function, in f32: x^ = x * rstd,
// dx = rstd * (dy*w - x^ * mean(dy*w*x^)) cast to x's dtype, and
// dw = sum over rows of dy*x^ cast to w's dtype.  Bound on the H100: bytes
// (x and dy read, dx written; a few operations an element).  The TPU kernel
// carries dw in VMEM scratch across a sequential grid; blocks on the card
// run in parallel and in no order, so each block takes a contiguous run of
// rows, accumulates its dw in f32 in shared memory (each thread owns its
// columns, so no atomics and no barrier), and writes one f32 partial row;
// a second kernel sums the partial rows per column in block order.  The sum
// is therefore deterministic for a given block count.  The per-row
// reduction for dx uses a double-buffered warp-partials array, so one
// barrier a row suffices.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, float* __restrict__ rstd, int h, float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * h;
  T* orow = out + row * h;
  float ss = 0.f;
  for (int i = threadIdx.x; i < h; i += kThreads) {
    const float v = ptt::to_f32(xr[i]);
    ss += v * v;
  }
  ss = ptt::block_sum(ss);
  const float r = rsqrtf(ss / static_cast<float>(h) + eps);
  if (threadIdx.x == 0) rstd[row] = r;
  for (int i = threadIdx.x; i < h; i += kThreads) {
    orow[i] = ptt::from_f32<T>(ptt::to_f32(xr[i]) * r * ptt::to_f32(w[i]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ rstd, const T* __restrict__ dy,
                    T* __restrict__ dx, float* __restrict__ dw_part, long long n,
                    int h, long long rows_per_block) {
  extern __shared__ float dw_acc[];  // [h]: this block's dw, f32
  __shared__ float part[2][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < h; c += kThreads) dw_acc[c] = 0.f;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  int parity = 0;
  for (long long row = r0; row < r1; ++row) {
    const T* xr = x + row * h;
    const T* dyr = dy + row * h;
    const float r = rstd[row];
    float loc = 0.f;
    for (int c = threadIdx.x; c < h; c += kThreads) {
      const float xhat = ptt::to_f32(xr[c]) * r;
      const float dyv = ptt::to_f32(dyr[c]);
      loc += dyv * ptt::to_f32(w[c]) * xhat;
      dw_acc[c] += dyv * xhat;
    }
    loc = ptt::warp_sum(loc);
    if (lane == 0) part[parity][warp] = loc;
    __syncthreads();
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) tot += part[parity][i];
    parity ^= 1;
    const float m = tot / static_cast<float>(h);
    T* dxr = dx + row * h;
    for (int c = threadIdx.x; c < h; c += kThreads) {
      const float xhat = ptt::to_f32(xr[c]) * r;
      const float dyw = ptt::to_f32(dyr[c]) * ptt::to_f32(w[c]);
      dxr[c] = ptt::from_f32<T>(r * (dyw - xhat * m));
    }
  }
  float* out = dw_part + static_cast<long long>(blockIdx.x) * h;
  for (int c = threadIdx.x; c < h; c += kThreads) out[c] = dw_acc[c];
}

// dw[c] = sum of the partial rows' column c, in block order
template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_norm_dw_reduce_kernel(const float* __restrict__ dw_part, T* __restrict__ dw,
                          int blocks, int h) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= h) return;
  float s = 0.f;
  for (int i = 0; i < blocks; ++i) s += dw_part[static_cast<long long>(i) * h + c];
  dw[c] = ptt::from_f32<T>(s);
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* rstd, const void* dy,
               void* dx, void* dw, void* dw_part, long long n, int h, int blocks,
               cudaStream_t s) {
  const size_t smem = static_cast<size_t>(h) * sizeof(float);
  auto kernel = rms_norm_bwd_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long per = (n + blocks - 1) / blocks;
  kernel<<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(rstd),
      static_cast<const T*>(dy), static_cast<T*>(dx), static_cast<float*>(dw_part), n, h, per);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rms_norm_dw_reduce_kernel<T><<<(h + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(dw_part), static_cast<T*>(dw), blocks, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out [n, h] and w [h] of one dtype (0 = f32, 1 = bf16); rstd [n] f32.
extern "C" int ptt_rms_norm_fwd(const void* x, const void* w, void* out, void* rstd,
                                long long n, int h, float eps, int dtype,
                                void* stream) {
  if (n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(static_cast<unsigned>(n));
    if (dtype == ptt::kBF16) {
      rms_norm_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
          static_cast<__nv_bfloat16*>(out), static_cast<float*>(rstd), h, eps);
    } else {
      rms_norm_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<float*>(out), static_cast<float*>(rstd), h, eps);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// x, dy, dx [n, h] and w, dw [h] of one dtype (0 = f32, 1 = bf16); rstd [n]
// f32; dw_part [blocks, h] f32 scratch, blocks in [1, n].
extern "C" int ptt_rms_norm_bwd(const void* x, const void* w, const void* rstd,
                                const void* dy, void* dx, void* dw, void* dw_part,
                                long long n, int h, int blocks, int dtype,
                                void* stream) {
  if (n == 0 || blocks < 1) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16)
    return launch_bwd<__nv_bfloat16>(x, w, rstd, dy, dx, dw, dw_part, n, h, blocks, s);
  return launch_bwd<float>(x, w, rstd, dy, dx, dw, dw_part, n, h, blocks, s);
}
