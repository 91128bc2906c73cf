// B1: RMSNorm forward over the last axis.
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
