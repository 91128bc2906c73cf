// B3: flash-attention forward (FA2 online softmax), causal or not, with an
// optional per-row left padding (the varlen prefill).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py: flash_attention and
// flash_attention_varlen -> _fwd -> _fwd_kernel (pallas_call at
// flash_attention.py:181).  Same function in the public [b, s, h, d] layout:
// scores in f32 times scale; causal masking bottom-right aligned (query row i
// sees keys <= i + sk - sq); with pad_lens, keys below pad_lens[b] are masked
// and a row with no valid key is exact zeros, never NaN (the m_ok guard of
// flash_attention.py:140-146); GQA reads kv head h / (hq / hkv) without
// repeating K/V.  Returns out and the f32 logsumexp lse [b, hq, sq].
//
// Bound on the H100: causal attention does about s/4 operations per byte of
// q, k, v and out, so at the serving prompt of 512 it is bound by bytes
// (below the card's ~295 bf16 operations per byte) and from a few thousand
// tokens by the tensor cores.  Either way the kernel must not re-read K/V
// from device memory per query row and must keep the scores out of it.
// Design: one block per (query tile, head, batch row); the TPU's sequential
// grid axis over key blocks becomes a loop inside the block that stages
// 64-row K/V tiles through shared memory; the online-softmax state stays on
// chip.  Key tiles wholly above the causal diagonal or left of the padding
// are never loaded, and the ragged edges are masked here, so no shape gate
// survives from the TPU kernel.
//
// bf16 (the serving dtype) runs on the tensor cores through WMMA 16x16x16
// fragments: four warps each own 16 query rows of a 64-row tile; S = Q K^T
// and O += P V are fragment products from shared memory with f32
// accumulation, and P is rounded to bf16 for the PV product as the TPU
// kernel does (p.astype(v.dtype)).  Two lanes share each row's softmax.  The
// O accumulator lives in shared memory in f32 so it can be rescaled row by
// row.  f32 inputs run a SIMT kernel (no tensor-core path keeps full f32):
// four threads share a query row, each holding a quarter of q and of the
// accumulator in registers (interleaved columns, four banks) and summing
// partial scores with two shuffles.  wgmma and TMA are later work (ROADMAP).
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowThreads = 4;                       // threads per query row
constexpr int kBlockQ = kThreads / kRowThreads;      // query rows per block

template <typename T, int DPT, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ pad_lens,
                 T* __restrict__ out, float* __restrict__ lse, int sq, int sk,
                 int hq, int hkv, int d, float scale, int causal) {
  extern __shared__ float smem[];
  float* ks = smem;           // [BK][d]
  float* vs = smem + BK * d;  // [BK][d]
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int hk = h / (hq / hkv);
  const int sub = threadIdx.x % kRowThreads;
  const int row = q0 + threadIdx.x / kRowThreads;
  const bool row_ok = row < sq;
  const int offset = sk - sq;
  const int pad = pad_lens != nullptr ? pad_lens[b] : 0;

  // this thread's columns of the query row: sub, sub + 4, sub + 8, ...
  float qr[DPT], acc[DPT];
  const T* qp = q + ((static_cast<int64_t>(b) * sq + row) * hq + h) * d;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int c = sub + kRowThreads * i;
    qr[i] = (row_ok && c < d) ? ptt::to_f32(qp[c]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const int last_row = min(q0 + kBlockQ, sq) - 1;
  const int k_end = causal ? min(sk, last_row + offset + 1) : sk;
  const int k_begin = (pad / BK) * BK;
  const int64_t kv_stride = static_cast<int64_t>(hkv) * d;  // between key rows
  const int64_t kv_base = static_cast<int64_t>(b) * sk * kv_stride +
                          static_cast<int64_t>(hk) * d;

  for (int t0 = k_begin; t0 < k_end; t0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < BK * d; e += kThreads) {
      const int jr = e / d, c = e - jr * d;
      const int kr = t0 + jr;
      float kval = 0.f, vval = 0.f;
      if (kr < sk) {
        const int64_t off = kv_base + kr * kv_stride + c;
        kval = ptt::to_f32(k[off]);
        vval = ptt::to_f32(v[off]);
      }
      ks[e] = kval;
      vs[e] = vval;
    }
    __syncthreads();

    float p[BK];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        const int c = sub + kRowThreads * i;
        if (c < d) part += qr[i] * ks[j * d + c];
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int col = t0 + j;
      const bool ok = col < sk && col >= pad && (!causal || col <= row + offset);
      p[j] = ok ? part * scale : -INFINITY;
      m_tile = fmaxf(m_tile, p[j]);
    }
    // a row with every score masked so far keeps m == -inf; a finite
    // reference point turns p and alpha into exact zeros instead of NaN
    const float m_new = fmaxf(m, m_tile);
    const float m_ok = (m_new == -INFINITY) ? 0.f : m_new;
    const float alpha = expf(m - m_ok);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      p[j] = expf(p[j] - m_ok);
      psum += p[j];
    }
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int c = sub + kRowThreads * i;
      float a = acc[i] * alpha;
      if (c < d) {
#pragma unroll
        for (int j = 0; j < BK; ++j) a += p[j] * vs[j * d + c];
      }
      acc[i] = a;
    }
  }

  if (row_ok) {
    const float ld = (l == 0.f) ? 1.f : l;  // rows with no valid key: zeros
    T* op = out + ((static_cast<int64_t>(b) * sq + row) * hq + h) * d;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int c = sub + kRowThreads * i;
      if (c < d) op[c] = ptt::from_f32<T>(acc[i] / ld);
    }
    if (sub == 0) lse[(static_cast<int64_t>(b) * hq + h) * sq + row] = m + logf(ld);
  }
}

template <typename T, int DPT>
int launch(const void* q, const void* k, const void* v, const void* pad_lens,
           void* out, void* lse, int b, int sq, int sk, int hq, int hkv, int d,
           float scale, int causal, cudaStream_t stream) {
  constexpr int BK = DPT >= 64 ? 32 : 64;  // keeps p[BK] + q + acc in registers
  const size_t smem = 2 * static_cast<size_t>(BK) * d * sizeof(float);
  auto kernel = flash_fwd_kernel<T, DPT, BK>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, hq, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(pad_lens), static_cast<T*>(out), static_cast<float*>(lse),
      sq, sk, hq, hkv, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(const void* q, const void* k, const void* v, const void* pad_lens,
                 void* out, void* lse, int b, int sq, int sk, int hq, int hkv, int d,
                 float scale, int causal, cudaStream_t s) {
  using T = float;
  const int dpt = (d + kRowThreads - 1) / kRowThreads;
  if (dpt <= 2) return launch<T, 2>(q, k, v, pad_lens, out, lse, b, sq, sk, hq, hkv, d, scale, causal, s);
  if (dpt <= 4) return launch<T, 4>(q, k, v, pad_lens, out, lse, b, sq, sk, hq, hkv, d, scale, causal, s);
  if (dpt <= 8) return launch<T, 8>(q, k, v, pad_lens, out, lse, b, sq, sk, hq, hkv, d, scale, causal, s);
  if (dpt <= 16) return launch<T, 16>(q, k, v, pad_lens, out, lse, b, sq, sk, hq, hkv, d, scale, causal, s);
  if (dpt <= 32) return launch<T, 32>(q, k, v, pad_lens, out, lse, b, sq, sk, hq, hkv, d, scale, causal, s);
  return launch<T, 64>(q, k, v, pad_lens, out, lse, b, sq, sk, hq, hkv, d, scale, causal, s);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;        // four warps
constexpr int kTcBQ = 64;              // query rows per block, 16 per warp
constexpr int kTcBK = 64;              // key rows per tile

// Shared-memory layout for head_dim d, padded to dp (a multiple of 16): the
// Q, K, V tiles in bf16, the scores S in f32, the probabilities P in bf16 and
// the accumulator O in f32.  Row strides are padded off a multiple of 128
// bytes against bank conflicts; every region starts on a 128-byte boundary,
// and every fragment on a 32-byte one, as WMMA loads require.
struct TcLayout {
  int dp, ldh, lds, ldp, ldo;
  size_t q, k, v, s, p, o, bytes;
};

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

__host__ __device__ inline TcLayout tc_layout(int d) {
  TcLayout t;
  t.dp = (d + 15) / 16 * 16;
  t.ldh = t.dp + 8;
  t.lds = kTcBK + 4;
  t.ldp = kTcBK + 8;
  t.ldo = t.dp + 4;
  t.q = 0;
  t.k = align128(t.q + sizeof(bf16) * kTcBQ * t.ldh);
  t.v = align128(t.k + sizeof(bf16) * kTcBK * t.ldh);
  t.s = align128(t.v + sizeof(bf16) * kTcBK * t.ldh);
  t.p = align128(t.s + sizeof(float) * kTcBQ * t.lds);
  t.o = align128(t.p + sizeof(bf16) * kTcBQ * t.ldp);
  t.bytes = align128(t.o + sizeof(float) * kTcBQ * t.ldo);
  return t;
}

// 64 rows of d bf16 (row stride src_stride elements) into a [64][ld] tile,
// 16 bytes a thread per load; rows >= rows_valid and columns [d, dp) zero.
__device__ inline void load_tile(bf16* dst, int ld, const bf16* src, int64_t src_stride,
                                 int rows_valid, int d, int dp) {
  const int vecs = dp / 8;
  for (int e = threadIdx.x; e < 64 * vecs; e += kTcThreads) {
    const int r = e / vecs, c = (e - r * vecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid && c < d) val = *reinterpret_cast<const uint4*>(src + r * src_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ pad_lens,
                    bf16* __restrict__ out, float* __restrict__ lse, int sq, int sk,
                    int hq, int hkv, int d, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const TcLayout L = tc_layout(d);
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + L.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw + L.v);
  float* Ss = reinterpret_cast<float*>(smem_raw + L.s);
  bf16* Ps = reinterpret_cast<bf16*>(smem_raw + L.p);
  float* Os = reinterpret_cast<float*>(smem_raw + L.o);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTcBQ;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int offset = sk - sq;
  const int pad = pad_lens != nullptr ? pad_lens[b] : 0;
  const int64_t q_stride = static_cast<int64_t>(hq) * d;   // between query rows
  const int64_t kv_stride = static_cast<int64_t>(hkv) * d; // between key rows

  load_tile(Qs, L.ldh, q + (static_cast<int64_t>(b) * sq + q0) * q_stride +
            static_cast<int64_t>(h) * d, q_stride, sq - q0, d, L.dp);
  for (int e = threadIdx.x; e < kTcBQ * L.dp; e += kTcThreads) {
    const int r = e / L.dp;
    Os[r * L.ldo + (e - r * L.dp)] = 0.f;
  }

  // lanes 2i and 2i+1 of a warp share its query row i: half the columns each
  const int r_loc = warp * 16 + (lane >> 1);
  const int row = q0 + r_loc;
  const int half = lane & 1;
  float m = -INFINITY, l = 0.f;

  const int last_row = min(q0 + kTcBQ, sq) - 1;
  const int k_end = causal ? min(sk, last_row + offset + 1) : sk;
  const int k_begin = (pad / kTcBK) * kTcBK;
  const int64_t kv_base = static_cast<int64_t>(b) * sk * kv_stride +
                          static_cast<int64_t>(hk) * d;

  for (int t0 = k_begin; t0 < k_end; t0 += kTcBK) {
    __syncthreads();  // the previous tiles are consumed (and Q, O are ready)
    load_tile(Ks, L.ldh, k + kv_base + t0 * kv_stride, kv_stride, sk - t0, d, L.dp);
    load_tile(Vs, L.ldh, v + kv_base + t0 * kv_stride, kv_stride, sk - t0, d, L.dp);
    __syncthreads();

    {  // S = Q K^T for this warp's 16 rows and the tile's 64 keys
      wm::fragment<wm::accumulator, 16, 16, 16, float> acc[kTcBK / 16];
#pragma unroll
      for (int n = 0; n < kTcBK / 16; ++n) wm::fill_fragment(acc[n], 0.f);
      for (int kk = 0; kk < L.dp; kk += 16) {
        wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
        wm::load_matrix_sync(a, Qs + warp * 16 * L.ldh + kk, L.ldh);
#pragma unroll
        for (int n = 0; n < kTcBK / 16; ++n) {
          wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> kf;
          wm::load_matrix_sync(kf, Ks + n * 16 * L.ldh + kk, L.ldh);
          wm::mma_sync(acc[n], a, kf, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < kTcBK / 16; ++n)
        wm::store_matrix_sync(Ss + warp * 16 * L.lds + n * 16, acc[n], L.lds,
                              wm::mem_row_major);
    }
    __syncwarp();

    // online softmax of row r_loc over the tile; a row with every score
    // masked so far keeps m == -inf and a finite reference point turns p
    // and alpha into exact zeros instead of NaN
    const float* srow = Ss + r_loc * L.lds + half * 32;
    float sv[32];
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = t0 + half * 32 + j;
      const bool ok = col < sk && col >= pad && (!causal || col <= row + offset);
      sv[j] = ok ? srow[j] * scale : -INFINITY;
      mt = fmaxf(mt, sv[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    const float m_new = fmaxf(m, mt);
    const float m_ok = (m_new == -INFINITY) ? 0.f : m_new;
    const float alpha = expf(m - m_ok);
    bf16* prow = Ps + r_loc * L.ldp + half * 32;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = expf(sv[j] - m_ok);
      psum += p;
      prow[j] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    float* orow = Os + r_loc * L.ldo;
    for (int c = half; c < L.dp; c += 2) orow[c] *= alpha;
    __syncwarp();

    {  // O += P V for this warp's rows
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> pa[kTcBK / 16];
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk)
        wm::load_matrix_sync(pa[kk], Ps + warp * 16 * L.ldp + kk * 16, L.ldp);
      for (int n = 0; n < L.dp; n += 16) {
        wm::fragment<wm::accumulator, 16, 16, 16, float> acc;
        float* o_tile = Os + warp * 16 * L.ldo + n;
        wm::load_matrix_sync(acc, o_tile, L.ldo, wm::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < kTcBK / 16; ++kk) {
          wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> vf;
          wm::load_matrix_sync(vf, Vs + kk * 16 * L.ldh + n, L.ldh);
          wm::mma_sync(acc, pa[kk], vf, acc);
        }
        wm::store_matrix_sync(o_tile, acc, L.ldo, wm::mem_row_major);
      }
    }
    __syncwarp();
  }
  __syncthreads();  // O's zeros are visible even when no tile ran

  if (row < sq) {
    const float ld = (l == 0.f) ? 1.f : l;  // rows with no valid key: zeros
    bf16* op = out + (static_cast<int64_t>(b) * sq + row) * q_stride +
               static_cast<int64_t>(h) * d;
    const float* orow = Os + r_loc * L.ldo;
    for (int c = half; c < d; c += 2) op[c] = __float2bfloat16(orow[c] / ld);
    if (half == 0) lse[(static_cast<int64_t>(b) * hq + h) * sq + row] = m + logf(ld);
  }
}

int launch_bf16(const void* q, const void* k, const void* v, const void* pad_lens,
                void* out, void* lse, int b, int sq, int sk, int hq, int hkv, int d,
                float scale, int causal, cudaStream_t stream) {
  const size_t smem = tc_layout(d).bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((sq + kTcBQ - 1) / kTcBQ, hq, b);
  flash_fwd_tc_kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(pad_lens), static_cast<bf16*>(out), static_cast<float*>(lse),
      sq, sk, hq, hkv, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out [b, sq, hq, d]; k, v [b, sk, hkv, d]; one dtype (0 = f32, 1 = bf16,
// then 16-byte aligned); d % 8 == 0, d <= 256; pad_lens [b] int32 or NULL;
// lse [b, hq, sq] f32.
extern "C" int ptt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* pad_lens, void* out, void* lse,
                                       int b, int sq, int sk, int hq, int hkv, int d,
                                       float scale, int causal, int dtype,
                                       void* stream) {
  if (b == 0 || sq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16)
    return launch_bf16(q, k, v, pad_lens, out, lse, b, sq, sk, hq, hkv, d, scale, causal, s);
  return dispatch_f32(q, k, v, pad_lens, out, lse, b, sq, sk, hq, hkv, d, scale, causal, s);
}
