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
// run in parallel and in no order.  Design (the layout in common.cuh): a
// persistent grid of a few blocks an SM, each owning one row at a time;
// each thread holds its 16 columns of x and dy in registers (two 16-byte
// loads each in bf16), so the row is read from device memory once, and the
// next row's loads are issued before this row's sum, one barrier a row;
// w is read once a block; dw accumulates in f32 registers, one f32 partial
// row a block, summed per column by norm_bwd_col_sum_kernel over 256
// blocks.  Rows are taken in a fixed order and sums run in a fixed order,
// so two launches give the same bits.  h not a multiple of 8, or
// misaligned pointers, take single-element slots; rows wider than 8192
// columns (4096 in single-element slots) are cut into segments, with the
// row sums from a pre-pass.  At [8192, 4096] bf16: 0.0730 ms of device
// time a call, 1.21x its bytes bound (NVIDIA H100 80GB HBM3, 700 W).
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

// x^ and dy of one row: the thread's slots k, N elements each (only slots
// with ok[k] set are read)
template <typename T, int N, int V>
struct RmsRow {
  ptt::Vec<T, N> x[V], dy[V];
  float rstd;
};

template <typename T, int N, int V>
__device__ __forceinline__ void load_rms_row(RmsRow<T, N, V>& r, const T* __restrict__ x,
                                             const T* __restrict__ dy,
                                             const float* __restrict__ rstd, long long row,
                                             int h, const int (&col)[V], const bool (&ok)[V]) {
  const long long off = row * h;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (!ok[k]) continue;
    r.x[k] = *reinterpret_cast<const ptt::Vec<T, N>*>(x + off + col[k]);
    r.dy[k] = *reinterpret_cast<const ptt::Vec<T, N>*>(dy + off + col[k]);
  }
  r.rstd = rstd[row];
}

// columns a thread owns: 16 in 16-byte vectors; 8 in single elements, whose
// 16 x and dy registers a row would spill (rows of odd h are rare)
template <int N>
constexpr int kRmsBwdElems = N == 1 ? ptt::kNormBwdElems / 2 : ptt::kNormBwdElems;

// B1b, one segment of every row of this block (see common.cuh): dx of the
// row and this block's f32 dw partial row.  row_dot [n] holds each row's
// sum of dy*w*x^ when the row has more than one segment, else NULL.
template <typename T, int N>
__global__ void __launch_bounds__(ptt::kNormBwdMaxThreads)
rms_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ rstd, const T* __restrict__ dy,
                    T* __restrict__ dx, float* __restrict__ dw_part,
                    const float* __restrict__ row_dot, long long n, int h) {
  constexpr int V = kRmsBwdElems<N> / N;
  __shared__ float red[2][1][32];
  int col[V];
  bool ok[V];
  float wv[V][N], acc[V][N];
  const int first = blockIdx.y * blockDim.x * V + threadIdx.x;  // this thread's first slot
#pragma unroll
  for (int k = 0; k < V; ++k) {
    col[k] = (first + k * blockDim.x) * N;
    ok[k] = col[k] < h;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      wv[k][e] = ok[k] ? ptt::to_f32(w[col[k] + e]) : 0.f;
      acc[k][e] = 0.f;
    }
  }
  const float inv_h = 1.f / static_cast<float>(h);
  int parity = 0;
  RmsRow<T, N, V> cur;
  long long row = blockIdx.x;
  if (row < n) load_rms_row(cur, x, dy, rstd, row, h, col, ok);
  for (; row < n; row += gridDim.x) {
    RmsRow<T, N, V> next;  // in flight during this row's sum
    if (row + gridDim.x < n) load_rms_row(next, x, dy, rstd, row + gridDim.x, h, col, ok);
    const float r = cur.rstd;
    float loc[1] = {0.f};
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (!ok[k]) continue;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float d = ptt::to_f32(cur.dy[k].v[e]);
        const float xh = ptt::to_f32(cur.x[k].v[e]) * r;
        loc[0] += d * wv[k][e] * xh;
        acc[k][e] += d * xh;
      }
    }
    if (row_dot != nullptr) loc[0] = row_dot[row];
    else ptt::block_sums<1>(loc, red, parity);
    const float m = loc[0] * inv_h;
    const long long off = row * h;
#pragma unroll
    for (int k = 0; k < V; ++k) {  // x^ and dy*w again from the row's registers
      if (!ok[k]) continue;
      float o[N];
#pragma unroll
      for (int e = 0; e < N; ++e)
        o[e] = r * (ptt::to_f32(cur.dy[k].v[e]) * wv[k][e] -
                    ptt::to_f32(cur.x[k].v[e]) * r * m);
      ptt::store_f32<T, N>(dx + off + col[k], o);
    }
    cur = next;
  }
  float* out = dw_part + static_cast<long long>(blockIdx.x) * h;
#pragma unroll
  for (int k = 0; k < V; ++k)
    if (ok[k]) ptt::store_f32<float, N>(out + col[k], acc[k]);
}

// row_dot[row] = sum over the row of dy*w*x^, for rows of several segments
template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_row_dot_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const float* __restrict__ rstd, const T* __restrict__ dy,
                            float* __restrict__ row_dot, int h) {
  const long long off = static_cast<long long>(blockIdx.x) * h;
  const float r = rstd[blockIdx.x];
  float loc = 0.f;
  for (int c = threadIdx.x; c < h; c += kThreads)
    loc += ptt::to_f32(dy[off + c]) * ptt::to_f32(w[c]) * (ptt::to_f32(x[off + c]) * r);
  loc = ptt::block_sum(loc);
  if (threadIdx.x == 0) row_dot[blockIdx.x] = loc;
}

template <typename T, int N>
int launch_bwd(const void* x, const void* w, const void* rstd, const void* dy, void* dx,
               void* dw, void* scratch, long long n, int h, int blocks, cudaStream_t s) {
  const ptt::NormBwdGeom g = ptt::norm_bwd_geom(h, N, kRmsBwdElems<N>);
  float* part = static_cast<float*>(scratch);
  float* row_dot = nullptr;
  if (g.segs > 1) {
    row_dot = part + static_cast<long long>(blocks) * h;
    rms_norm_bwd_row_dot_kernel<T><<<static_cast<unsigned>(n), kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(rstd),
        static_cast<const T*>(dy), row_dot, h);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rms_norm_bwd_kernel<T, N><<<dim3(blocks, g.segs), g.threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(rstd),
      static_cast<const T*>(dy), static_cast<T*>(dx), part, row_dot, n, h);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(ptt::launch_col_sum<T>(part, static_cast<T*>(dw), nullptr, blocks,
                                                 h, h, s));
}

template <typename T>
int launch_bwd_any(const void* x, const void* w, const void* rstd, const void* dy, void* dx,
                   void* dw, void* scratch, long long n, int h, int blocks, cudaStream_t s) {
  constexpr int N = 16 / sizeof(T);
  if (h % N == 0 && ptt::aligned16(x) && ptt::aligned16(dy) && ptt::aligned16(dx))
    return launch_bwd<T, N>(x, w, rstd, dy, dx, dw, scratch, n, h, blocks, s);
  return launch_bwd<T, 1>(x, w, rstd, dy, dx, dw, scratch, n, h, blocks, s);
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
// f32; scratch: blocks * h + n f32 (the blocks' dw partial rows, then the
// row sums of rows wider than one segment); blocks in [1, n].
extern "C" int ptt_rms_norm_bwd(const void* x, const void* w, const void* rstd,
                                const void* dy, void* dx, void* dw, void* scratch,
                                long long n, int h, int blocks, int dtype,
                                void* stream) {
  if (n == 0 || blocks < 1) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16)
    return launch_bwd_any<__nv_bfloat16>(x, w, rstd, dy, dx, dw, scratch, n, h, blocks, s);
  return launch_bwd_any<float>(x, w, rstd, dy, dx, dw, scratch, n, h, blocks, s);
}
