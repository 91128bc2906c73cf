// B4: fused SwiGLU forward and backward; B5: the one-sweep AdamW update;
// B11 and B11b: residual add + LayerNorm forward and backward.
//
// Replaces paddle_tpu/ops/pallas/fused_ln_swiglu.py, whole:
//   B11  fused_add_layer_norm -> _ln_fwd -> _ln_fwd_kernel (pallas_call :92)
//   B11b _ln_bwd -> _ln_bwd_kernel (pallas_call :124)
//   B4   fused_swiglu -> _swiglu_fwd / _swiglu_bwd -> _elementwise_call
//        (pallas_call :193, run with _swiglu_fwd_kernel and _swiglu_bwd_kernel)
//   B5   fused_adamw -> _adamw_kernel (pallas_call :280)
//
// All four are bound by bytes on the H100: each element is read once and
// written once for a handful of f32 operations, far below the ~20 f32
// operations per byte where the card's arithmetic would become the limit.
// So the designs only keep every byte to one trip through device memory
// and keep the loads wide:
//
// - B4 and B5 are grid-stride elementwise sweeps with 16-byte vector loads
//   (8 bf16 or 4 f32 values a thread) when every pointer is 16-byte
//   aligned, and a scalar tail for the last n % N elements.  The TPU
//   kernels' (8, 128) row blocks do not carry over: the data is flat.
// - B5 updates p, m and v in place (the TPU kernel returns new arrays), so
//   a step moves 28 bytes an f32 parameter and allocates nothing.  lr,
//   1 - beta1^t and 1 - beta2^t arrive as f32 arguments computed in f32 by
//   the wrapper, as the TPU wrapper computes them (fused_ln_swiglu.py:273-276).
//   With ZeRO offload p (the f32 master), m and v lie in pinned host memory
//   and the kernel reads and writes them over the host link in place
//   (zero-copy: the wrapper passes their device addresses under unified
//   addressing), 12 bytes each way a parameter.  The optional out is the
//   card's copy of the parameter (bf16 under AMP O2): the kernel writes the
//   new p rounded to out's dtype there, so the refreshed weight does not
//   cross the link a second time (an extra output of this kernel; the TPU
//   kernel has none, the reference's XLA program casts after the update).
// - B11 takes one block of 256 threads per row.  Each thread keeps the f32
//   sums of its own columns in shared memory (the same columns in every
//   pass, so no barrier is needed for them), so the variance is taken in
//   two passes, mean((s - mu)^2) as the TPU kernel does, without a second
//   read of x and r from device memory.  The weight and bias may be f32
//   while x is bf16 (AMP O2 keeps LayerNorm parameters in f32).
// - B11b: the TPU kernel carries dw and db in VMEM across a sequential
//   grid; blocks on the card run in parallel and in no order.  As B1b
//   (rms_norm.cu; the layout in common.cuh): a persistent grid of a few
//   blocks an SM, one row a block at a time; each thread holds its columns
//   of s, dy and dpre in registers (16-byte loads), so the row is read from
//   device memory once, issues the next row's loads before this row's two
//   sums (one barrier a row), and accumulates dw and db in f32 registers;
//   one f32 partial row of each a block, summed per column by
//   norm_bwd_col_sum_kernel over 256 blocks in a fixed order: two launches
//   give the same bits.  x^ is recomputed from the stored, rounded sum with
//   the forward's f32 mu and rstd, as _ln_bwd_kernel does.  No shared-memory
//   row, so no cap on h: rows wider than one segment take their two sums
//   from a pre-pass.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

using ptt::aligned16;

int grid_for(long long work) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = (work + kThreads - 1) / kThreads;
  return static_cast<int>(std::max(1LL, std::min(blocks, static_cast<long long>(sms) * 16)));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// Sum over the block into part[32]; each call site passes its own part
// array of 33 floats, so calls follow each other without a barrier.
__device__ __forceinline__ float block_sum_in(float v, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = ptt::warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = ptt::warp_sum(lane < (kThreads >> 5) ? part[lane] : 0.f);
    if (lane == 0) part[32] = v;
  }
  __syncthreads();
  return part[32];
}

// ---------------------------------------------------------------------------
// B4: SwiGLU.  fwd: out = silu(g) * u.  bwd: dg = dy*u*(sig + silu*(1 - sig)),
// du = dy*silu.  f32 inside, every output in g's dtype.
// ---------------------------------------------------------------------------
template <int N>
__device__ __forceinline__ void swiglu_fwd_vals(const float (&g)[N], const float (&u)[N],
                                                float (&o)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) o[k] = g[k] * sigmoid(g[k]) * u[k];
}

template <int N>
__device__ __forceinline__ void swiglu_bwd_vals(const float (&g)[N], const float (&u)[N],
                                                const float (&dy)[N], float (&dg)[N],
                                                float (&du)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float sig = sigmoid(g[k]);
    const float silu = g[k] * sig;
    dg[k] = dy[k] * u[k] * (sig + silu * (1.f - sig));
    du[k] = dy[k] * silu;
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
swiglu_fwd_kernel(const T* __restrict__ g, const T* __restrict__ u, T* __restrict__ out,
                  long long n) {
  const long long nvec = n / N;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = first; i < nvec; i += stride) {
    float gv[N], uv[N], ov[N];
    ptt::load_f32<T, N>(g + i * N, gv);
    ptt::load_f32<T, N>(u + i * N, uv);
    swiglu_fwd_vals<N>(gv, uv, ov);
    ptt::store_f32<T, N>(out + i * N, ov);
  }
  const long long j = nvec * N + first;  // the tail: fewer than N elements
  if (j < n) {
    float gv[1] = {ptt::to_f32(g[j])}, uv[1] = {ptt::to_f32(u[j])}, ov[1];
    swiglu_fwd_vals<1>(gv, uv, ov);
    out[j] = ptt::from_f32<T>(ov[0]);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
swiglu_bwd_kernel(const T* __restrict__ g, const T* __restrict__ u, const T* __restrict__ dy,
                  T* __restrict__ dg, T* __restrict__ du, long long n) {
  const long long nvec = n / N;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = first; i < nvec; i += stride) {
    float gv[N], uv[N], dyv[N], dgv[N], duv[N];
    ptt::load_f32<T, N>(g + i * N, gv);
    ptt::load_f32<T, N>(u + i * N, uv);
    ptt::load_f32<T, N>(dy + i * N, dyv);
    swiglu_bwd_vals<N>(gv, uv, dyv, dgv, duv);
    ptt::store_f32<T, N>(dg + i * N, dgv);
    ptt::store_f32<T, N>(du + i * N, duv);
  }
  const long long j = nvec * N + first;
  if (j < n) {
    float gv[1] = {ptt::to_f32(g[j])}, uv[1] = {ptt::to_f32(u[j])},
          dyv[1] = {ptt::to_f32(dy[j])}, dgv[1], duv[1];
    swiglu_bwd_vals<1>(gv, uv, dyv, dgv, duv);
    dg[j] = ptt::from_f32<T>(dgv[0]);
    du[j] = ptt::from_f32<T>(duv[0]);
  }
}

template <typename T>
int launch_swiglu(const void* g, const void* u, const void* dy, void* out, void* du,
                  long long n, cudaStream_t s) {
  constexpr int N = 16 / sizeof(T);
  const bool vec = aligned16(g) && aligned16(u) && aligned16(out) &&
                   (dy == nullptr || (aligned16(dy) && aligned16(du)));
  const int grid = grid_for(vec ? (n + N - 1) / N : n);
  if (dy == nullptr) {
    auto k = vec ? &swiglu_fwd_kernel<T, N> : &swiglu_fwd_kernel<T, 1>;
    k<<<grid, kThreads, 0, s>>>(static_cast<const T*>(g), static_cast<const T*>(u),
                                static_cast<T*>(out), n);
  } else {
    auto k = vec ? &swiglu_bwd_kernel<T, N> : &swiglu_bwd_kernel<T, 1>;
    k<<<grid, kThreads, 0, s>>>(static_cast<const T*>(g), static_cast<const T*>(u),
                                static_cast<const T*>(dy), static_cast<T*>(out),
                                static_cast<T*>(du), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// B5: decoupled AdamW, in place.  p and g of one dtype (the f32 master and
// its f32 gradient on the training path), m and v in f32.
// ---------------------------------------------------------------------------
struct AdamArgs {
  float lr, bc1, bc2, b1, omb1, b2, omb2, eps, lr_wd;
  int decay;
};

// The guarded form's device inputs: ok (int32, 0 skips the step: every
// block returns before it loads anything), t (int32, the parameter's
// update count before this step) and bc ([rows, 2] f32: row t holds
// 1 - beta1^(t+1) and 1 - beta2^(t+1), as the host rounds them).
struct AdamGate {
  const int* ok;
  const int* t;
  const float* bc;
};

__device__ __forceinline__ void adamw_val(float& p, float g, float& m, float& v,
                                          const AdamArgs& a) {
  m = a.b1 * m + a.omb1 * g;
  v = a.b2 * v + a.omb2 * (g * g);
  const float update = (m / a.bc1) / (sqrtf(v / a.bc2) + a.eps);
  const float old = p;
  p = old - a.lr * update;
  if (a.decay) p = p - a.lr_wd * old;
}

template <typename T, typename O, int N, bool Guarded>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(T* __restrict__ p, const T* __restrict__ g, float* __restrict__ m,
             float* __restrict__ v, O* __restrict__ out, long long n, AdamArgs a,
             AdamGate gate) {
  if (Guarded) {
    if (*gate.ok == 0) return;
    const int t = *gate.t;
    a.bc1 = gate.bc[2 * t];
    a.bc2 = gate.bc[2 * t + 1];
  }
  const long long nvec = n / N;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = first; i < nvec; i += stride) {
    float pv[N], gv[N], mv[N], vv[N];
    ptt::load_f32<T, N>(p + i * N, pv);
    ptt::load_f32<T, N>(g + i * N, gv);
    ptt::load_f32<float, N>(m + i * N, mv);
    ptt::load_f32<float, N>(v + i * N, vv);
#pragma unroll
    for (int k = 0; k < N; ++k) adamw_val(pv[k], gv[k], mv[k], vv[k], a);
    ptt::store_f32<T, N>(p + i * N, pv);
    ptt::store_f32<float, N>(m + i * N, mv);
    ptt::store_f32<float, N>(v + i * N, vv);
    if (out != nullptr) ptt::store_f32<O, N>(out + i * N, pv);
  }
  const long long j = nvec * N + first;
  if (j < n) {
    float pv = ptt::to_f32(p[j]), mv = m[j], vv = v[j];
    adamw_val(pv, ptt::to_f32(g[j]), mv, vv, a);
    p[j] = ptt::from_f32<T>(pv);
    m[j] = mv;
    v[j] = vv;
    if (out != nullptr) out[j] = ptt::from_f32<O>(pv);
  }
}

template <typename T, typename O>
int launch_adamw_to(void* p, const void* g, void* m, void* v, void* out, long long n,
                 const AdamArgs& a, const AdamGate& gate, cudaStream_t s) {
  constexpr int N = 4;  // 16 bytes of m and v; 8 or 16 bytes of p, g and out
  const bool vec = aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v) &&
                   (out == nullptr || aligned16(out));
  const bool guarded = gate.ok != nullptr;
  auto k = vec ? (guarded ? &adamw_kernel<T, O, N, true> : &adamw_kernel<T, O, N, false>)
               : (guarded ? &adamw_kernel<T, O, 1, true> : &adamw_kernel<T, O, 1, false>);
  k<<<grid_for(vec ? (n + N - 1) / N : n), kThreads, 0, s>>>(
      static_cast<T*>(p), static_cast<const T*>(g), static_cast<float*>(m),
      static_cast<float*>(v), static_cast<O*>(out), n, a, gate);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_adamw(void* p, const void* g, void* m, void* v, void* out, int out_dtype,
                 long long n, const AdamArgs& a, const AdamGate& gate, cudaStream_t s) {
  if (out != nullptr && out_dtype == ptt::kBF16)
    return launch_adamw_to<T, __nv_bfloat16>(p, g, m, v, out, n, a, gate, s);
  if (out != nullptr) return launch_adamw_to<T, float>(p, g, m, v, out, n, a, gate, s);
  return launch_adamw_to<T, T>(p, g, m, v, nullptr, n, a, gate, s);
}

// ---------------------------------------------------------------------------
// B11: s = x + r in f32; out = (s - mu) * rstd * w + b in x's dtype; s in
// x's dtype; mu and rstd [n] in f32.  One block a row.
// ---------------------------------------------------------------------------
template <typename T, typename W, int N>
__global__ void __launch_bounds__(kThreads)
add_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r, const W* __restrict__ w,
                  const W* __restrict__ b, T* __restrict__ out, T* __restrict__ sum,
                  float* __restrict__ mu, float* __restrict__ rstd, int h, float eps) {
  extern __shared__ float srow[];  // [h]: the f32 sum, each thread its own columns
  __shared__ float part[2][33];
  const long long off = static_cast<long long>(blockIdx.x) * h;
  float loc = 0.f;
  for (int c = threadIdx.x * N; c < h; c += kThreads * N) {
    float xv[N], rv[N], sv[N];
    ptt::load_f32<T, N>(x + off + c, xv);
    ptt::load_f32<T, N>(r + off + c, rv);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      sv[k] = xv[k] + rv[k];
      srow[c + k] = sv[k];
      loc += sv[k];
    }
    ptt::store_f32<T, N>(sum + off + c, sv);
  }
  const float mean = block_sum_in(loc, part[0]) / static_cast<float>(h);
  float sq = 0.f;
  for (int c = threadIdx.x * N; c < h; c += kThreads * N) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float d = srow[c + k] - mean;
      sq += d * d;
    }
  }
  const float var = block_sum_in(sq, part[1]) / static_cast<float>(h);
  const float rs = rsqrtf(var + eps);
  if (threadIdx.x == 0) {
    mu[blockIdx.x] = mean;
    rstd[blockIdx.x] = rs;
  }
  for (int c = threadIdx.x * N; c < h; c += kThreads * N) {
    float ov[N];
#pragma unroll
    for (int k = 0; k < N; ++k)
      ov[k] = (srow[c + k] - mean) * rs * ptt::to_f32(w[c + k]) + ptt::to_f32(b[c + k]);
    ptt::store_f32<T, N>(out + off + c, ov);
  }
}

template <typename T, typename W>
int launch_add_ln_fwd(const void* x, const void* r, const void* w, const void* b, void* out,
                      void* sum, void* mu, void* rstd, long long n, int h, float eps,
                      cudaStream_t s) {
  constexpr int N = 16 / sizeof(T);
  const bool vec = h % N == 0 && aligned16(x) && aligned16(r) && aligned16(out) &&
                   aligned16(sum);
  auto k = vec ? &add_ln_fwd_kernel<T, W, N> : &add_ln_fwd_kernel<T, W, 1>;
  const size_t smem = static_cast<size_t>(h) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  k<<<static_cast<unsigned>(n), kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const W*>(w),
      static_cast<const W*>(b), static_cast<T*>(out), static_cast<T*>(sum),
      static_cast<float*>(mu), static_cast<float*>(rstd), h, eps);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// B11b: x^ = (s - mu) * rstd, dyw = dy * w, c1 = mean(dyw), c2 = mean(dyw * x^),
// dx = rstd * (dyw - c1 - x^ * c2) + dpre (dpre may be NULL: zero);
// dw = sum over rows of dy * x^, db = sum over rows of dy, in w's dtype.
// ---------------------------------------------------------------------------
// s, dy and dpre of one row: the thread's slots k, N elements each (only
// slots with ok[k] set are read; dpre only when given)
template <typename T, int N, int V>
struct LnRow {
  ptt::Vec<T, N> s[V], dy[V], dpre[V];
  float mu, rstd;
};

template <typename T, int N, int V>
__device__ __forceinline__ void load_ln_row(LnRow<T, N, V>& r, const T* __restrict__ s,
                                            const T* __restrict__ dy,
                                            const T* __restrict__ dpre,
                                            const float* __restrict__ mu,
                                            const float* __restrict__ rstd, long long row,
                                            int h, const int (&col)[V], const bool (&ok)[V]) {
  const long long off = row * h;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (!ok[k]) continue;
    r.s[k] = *reinterpret_cast<const ptt::Vec<T, N>*>(s + off + col[k]);
    r.dy[k] = *reinterpret_cast<const ptt::Vec<T, N>*>(dy + off + col[k]);
    if (dpre != nullptr) r.dpre[k] = *reinterpret_cast<const ptt::Vec<T, N>*>(dpre + off + col[k]);
  }
  r.mu = mu[row];
  r.rstd = rstd[row];
}

// columns a thread owns: 8, half of B1b's.  At 16, s, dy and dpre of two
// rows, w, dw and db filled the 128 registers and spilled, and a
// 2048-column row took 4 warps: 0.0985 ms of device time a call at
// [8192, 2048] against 0.0592 at 8 (NVIDIA H100 80GB HBM3, 700 W, two
// blocks an SM).  Rows wider than 4096 columns take the pre-pass.
constexpr int kLnBwdElems = ptt::kNormBwdElems / 2;

// B11b, one segment of every row of this block (the layout in common.cuh):
// dx of the row and this block's f32 partial rows of dw and db, [2][h] at
// part + blockIdx.x * 2h.  row_sums [n][2] holds each row's sums of dy*w and
// dy*w*x^ when the row has more than one segment, else NULL.
template <typename T, typename W, int N>
__global__ void __launch_bounds__(ptt::kNormBwdMaxThreads)
add_ln_bwd_kernel(const T* __restrict__ s, const W* __restrict__ w,
                  const float* __restrict__ mu, const float* __restrict__ rstd,
                  const T* __restrict__ dy, const T* __restrict__ dpre, T* __restrict__ dx,
                  float* __restrict__ part, const float* __restrict__ row_sums, long long n,
                  int h) {
  constexpr int V = kLnBwdElems / N;
  __shared__ float red[2][2][32];
  int col[V];
  bool ok[V];
  float wv[V][N], dw[V][N], db[V][N];
  const int first = blockIdx.y * blockDim.x * V + threadIdx.x;  // this thread's first slot
#pragma unroll
  for (int k = 0; k < V; ++k) {
    col[k] = (first + k * blockDim.x) * N;
    ok[k] = col[k] < h;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      wv[k][e] = ok[k] ? ptt::to_f32(w[col[k] + e]) : 0.f;
      dw[k][e] = 0.f;
      db[k][e] = 0.f;
    }
  }
  const float inv_h = 1.f / static_cast<float>(h);
  int parity = 0;
  LnRow<T, N, V> cur;
  long long row = blockIdx.x;
  if (row < n) load_ln_row(cur, s, dy, dpre, mu, rstd, row, h, col, ok);
  for (; row < n; row += gridDim.x) {
    LnRow<T, N, V> next;  // in flight during this row's sums
    if (row + gridDim.x < n)
      load_ln_row(next, s, dy, dpre, mu, rstd, row + gridDim.x, h, col, ok);
    const float m = cur.mu, rs = cur.rstd;
    float c[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (!ok[k]) continue;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float xhat = (ptt::to_f32(cur.s[k].v[e]) - m) * rs;
        const float d = ptt::to_f32(cur.dy[k].v[e]);
        const float dyw = d * wv[k][e];
        c[0] += dyw;
        c[1] += dyw * xhat;
        dw[k][e] += d * xhat;
        db[k][e] += d;
      }
    }
    if (row_sums != nullptr) {
      c[0] = row_sums[2 * row];
      c[1] = row_sums[2 * row + 1];
    } else {
      ptt::block_sums<2>(c, red, parity);
    }
    const float c1 = c[0] * inv_h, c2 = c[1] * inv_h;
    const long long off = row * h;
#pragma unroll
    for (int k = 0; k < V; ++k) {  // x^ and dy*w again from the row's registers
      if (!ok[k]) continue;
      float o[N];
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float xhat = (ptt::to_f32(cur.s[k].v[e]) - m) * rs;
        o[e] = rs * (ptt::to_f32(cur.dy[k].v[e]) * wv[k][e] - c1 - xhat * c2);
        if (dpre != nullptr) o[e] += ptt::to_f32(cur.dpre[k].v[e]);
      }
      ptt::store_f32<T, N>(dx + off + col[k], o);
    }
    cur = next;
  }
  float* out = part + static_cast<long long>(blockIdx.x) * 2 * h;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (!ok[k]) continue;
    ptt::store_f32<float, N>(out + col[k], dw[k]);
    ptt::store_f32<float, N>(out + h + col[k], db[k]);
  }
}

// row_sums[row] = (sum of dy*w, sum of dy*w*x^) over the row, for rows of
// several segments
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
add_ln_bwd_row_sums_kernel(const T* __restrict__ s, const W* __restrict__ w,
                           const float* __restrict__ mu, const float* __restrict__ rstd,
                           const T* __restrict__ dy, float* __restrict__ row_sums, int h) {
  __shared__ float part[2][33];
  const long long off = static_cast<long long>(blockIdx.x) * h;
  const float m = mu[blockIdx.x], rs = rstd[blockIdx.x];
  float l1 = 0.f, l2 = 0.f;
  for (int c = threadIdx.x; c < h; c += kThreads) {
    const float dyw = ptt::to_f32(dy[off + c]) * ptt::to_f32(w[c]);
    l1 += dyw;
    l2 += dyw * ((ptt::to_f32(s[off + c]) - m) * rs);
  }
  l1 = block_sum_in(l1, part[0]);
  l2 = block_sum_in(l2, part[1]);
  if (threadIdx.x == 0) {
    row_sums[2 * static_cast<long long>(blockIdx.x)] = l1;
    row_sums[2 * static_cast<long long>(blockIdx.x) + 1] = l2;
  }
}

template <typename T, typename W, int N>
int launch_add_ln_bwd_n(const void* sum, const void* w, const void* mu, const void* rstd,
                        const void* dy, const void* dpre, void* dx, void* dw, void* db,
                        void* scratch, long long n, int h, int blocks, cudaStream_t st) {
  const ptt::NormBwdGeom g = ptt::norm_bwd_geom(h, N, kLnBwdElems);
  float* part = static_cast<float*>(scratch);
  float* row_sums = nullptr;
  if (g.segs > 1) {
    row_sums = part + static_cast<long long>(blocks) * 2 * h;
    add_ln_bwd_row_sums_kernel<T, W><<<static_cast<unsigned>(n), kThreads, 0, st>>>(
        static_cast<const T*>(sum), static_cast<const W*>(w), static_cast<const float*>(mu),
        static_cast<const float*>(rstd), static_cast<const T*>(dy), row_sums, h);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  add_ln_bwd_kernel<T, W, N><<<dim3(blocks, g.segs), g.threads, 0, st>>>(
      static_cast<const T*>(sum), static_cast<const W*>(w), static_cast<const float*>(mu),
      static_cast<const float*>(rstd), static_cast<const T*>(dy), static_cast<const T*>(dpre),
      static_cast<T*>(dx), part, row_sums, n, h);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(ptt::launch_col_sum<W>(part, static_cast<W*>(dw),
                                                 static_cast<W*>(db), blocks, 2 * h, h, st));
}

template <typename T, typename W>
int launch_add_ln_bwd(const void* sum, const void* w, const void* mu, const void* rstd,
                      const void* dy, const void* dpre, void* dx, void* dw, void* db,
                      void* scratch, long long n, int h, int blocks, cudaStream_t st) {
  constexpr int N = 16 / sizeof(T);
  if (h % N == 0 && aligned16(sum) && aligned16(dy) && aligned16(dx) &&
      (dpre == nullptr || aligned16(dpre)))
    return launch_add_ln_bwd_n<T, W, N>(sum, w, mu, rstd, dy, dpre, dx, dw, db, scratch, n, h,
                                        blocks, st);
  return launch_add_ln_bwd_n<T, W, 1>(sum, w, mu, rstd, dy, dpre, dx, dw, db, scratch, n, h,
                                      blocks, st);
}

}  // namespace

// g, u, out: n contiguous elements of one dtype (0 = f32, 1 = bf16).
extern "C" int ptt_swiglu_fwd(const void* g, const void* u, void* out, long long n, int dtype,
                              void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16) return launch_swiglu<__nv_bfloat16>(g, u, nullptr, out, nullptr, n, s);
  return launch_swiglu<float>(g, u, nullptr, out, nullptr, n, s);
}

// g, u, dy, dg, du: n contiguous elements of one dtype.
extern "C" int ptt_swiglu_bwd(const void* g, const void* u, const void* dy, void* dg, void* du,
                              long long n, int dtype, void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16) return launch_swiglu<__nv_bfloat16>(g, u, dy, dg, du, n, s);
  return launch_swiglu<float>(g, u, dy, dg, du, n, s);
}

// p, g: n contiguous elements of one dtype (the update's); m, v: n f32,
// all updated in place; out (or NULL): n elements of out_dtype receiving
// the new p.  Any of p, m and v may be the device address of pinned host
// memory.  omb1 = 1 - beta1 and omb2 = 1 - beta2 as the caller rounds
// them; lr_wd = lr * weight_decay in f32.
extern "C" int ptt_adamw(void* p, const void* g, void* m, void* v, void* out, long long n,
                         float lr, float bc1, float bc2, float b1, float omb1, float b2,
                         float omb2, float eps, float lr_wd, int decay, int dtype,
                         int out_dtype, void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AdamArgs a{lr, bc1, bc2, b1, omb1, b2, omb2, eps, lr_wd, decay};
  const AdamGate gate{nullptr, nullptr, nullptr};
  if (dtype == ptt::kBF16)
    return launch_adamw<__nv_bfloat16>(p, g, m, v, out, out_dtype, n, a, gate, s);
  return launch_adamw<float>(p, g, m, v, out, out_dtype, n, a, gate, s);
}

// ptt_adamw's guarded form: the same update with the bias corrections read
// from bc at row *t and nothing done where *ok is 0 (see AdamGate); ok, t
// and bc lie on the card.
extern "C" int ptt_adamw_guarded(void* p, const void* g, void* m, void* v, void* out,
                                 long long n, float lr, float b1, float omb1, float b2,
                                 float omb2, float eps, float lr_wd, int decay, int dtype,
                                 int out_dtype, const void* ok, const void* t,
                                 const void* bc, void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AdamArgs a{lr, 0.f, 0.f, b1, omb1, b2, omb2, eps, lr_wd, decay};
  const AdamGate gate{static_cast<const int*>(ok), static_cast<const int*>(t),
                      static_cast<const float*>(bc)};
  if (dtype == ptt::kBF16)
    return launch_adamw<__nv_bfloat16>(p, g, m, v, out, out_dtype, n, a, gate, s);
  return launch_adamw<float>(p, g, m, v, out, out_dtype, n, a, gate, s);
}

// The address under which the current card reaches host memory at host:
// 0 and *dev set when host lies in pinned (page-locked, mapped) memory,
// cudaErrorInvalidValue when it is ordinary pageable memory.
extern "C" int ptt_host_device_ptr(const void* host, void** dev) {
  cudaPointerAttributes attr;
  const cudaError_t rc = cudaPointerGetAttributes(&attr, host);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (attr.type != cudaMemoryTypeHost || attr.devicePointer == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  *dev = attr.devicePointer;
  return 0;
}

// x, r, out, sum [n, h] of dtype; w, b [h] of w_dtype; mu, rstd [n] f32.
extern "C" int ptt_add_layer_norm_fwd(const void* x, const void* r, const void* w,
                                      const void* b, void* out, void* sum, void* mu,
                                      void* rstd, long long n, int h, float eps, int dtype,
                                      int w_dtype, void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16) {
    if (w_dtype == ptt::kBF16)
      return launch_add_ln_fwd<__nv_bfloat16, __nv_bfloat16>(x, r, w, b, out, sum, mu, rstd,
                                                             n, h, eps, s);
    return launch_add_ln_fwd<__nv_bfloat16, float>(x, r, w, b, out, sum, mu, rstd, n, h,
                                                   eps, s);
  }
  if (w_dtype == ptt::kBF16)
    return launch_add_ln_fwd<float, __nv_bfloat16>(x, r, w, b, out, sum, mu, rstd, n, h,
                                                   eps, s);
  return launch_add_ln_fwd<float, float>(x, r, w, b, out, sum, mu, rstd, n, h, eps, s);
}

// sum, dy, dpre (or NULL), dx [n, h] of dtype; w, dw, db [h] of w_dtype;
// mu, rstd [n] f32; scratch: blocks * 2h + 2n f32 (the blocks' dw and db
// partial rows, then the row sums of rows wider than one segment); blocks
// in [1, n].
extern "C" int ptt_add_layer_norm_bwd(const void* sum, const void* w, const void* mu,
                                      const void* rstd, const void* dy, const void* dpre,
                                      void* dx, void* dw, void* db, void* scratch, long long n,
                                      int h, int blocks, int dtype, int w_dtype,
                                      void* stream) {
  if (n == 0 || blocks < 1) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16) {
    if (w_dtype == ptt::kBF16)
      return launch_add_ln_bwd<__nv_bfloat16, __nv_bfloat16>(sum, w, mu, rstd, dy, dpre, dx,
                                                             dw, db, scratch, n, h, blocks, s);
    return launch_add_ln_bwd<__nv_bfloat16, float>(sum, w, mu, rstd, dy, dpre, dx, dw, db,
                                                   scratch, n, h, blocks, s);
  }
  if (w_dtype == ptt::kBF16)
    return launch_add_ln_bwd<float, __nv_bfloat16>(sum, w, mu, rstd, dy, dpre, dx, dw, db,
                                                   scratch, n, h, blocks, s);
  return launch_add_ln_bwd<float, float>(sum, w, mu, rstd, dy, dpre, dx, dw, db, scratch, n, h,
                                         blocks, s);
}
