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
// grid axis over key blocks becomes a loop inside the block that stages K/V
// tiles through shared memory; the online-softmax state stays on chip.  Key
// tiles wholly above the causal diagonal or left of the padding are never
// loaded, and the ragged edges are masked here, so no shape gate survives
// from the TPU kernel.
//
// bf16 with head_dim <= 128 (every model of the repo: fwd_wg, the head dim
// padded with zero columns to DP = 64 or 128) runs on Hopper's wgmma, as the
// backward's bwd_dq_wg does (flash_attention_bwd.cu; wgmma.cuh has the
// layouts).  Each block is one warpgroup of 128 threads owning 64 query
// rows, wgmma's m:
//   * Q is read once from device memory straight into registers, in the
//     layout of wgmma's register A operand (DP / 4 32-bit registers a
//     thread); S = Q K^T is a wgmma of that operand against the K tile in
//     shared memory (K-major), into f32 registers.  The online softmax runs
//     in that accumulator layout: a thread holds two rows, so a row's max
//     and sum are two shuffles across its quad; exp2 with scale * log2(e)
//     folded in (ex2.approx); only a tile that crosses the diagonal, the
//     last key or the pad masks per element.  The row sum l is kept per
//     thread and summed across the quad once, at the end.
//   * P, rounded to bf16x2 in place, is the register A operand of
//     O += P V, whose B is the V tile read through the transpose bit (no
//     transposed copy).  O stays in registers (DP / 2 f32 a thread) and is
//     rescaled there; Q, S, P and O never touch shared memory.
//   * K and V tiles stream through a ring of cp.async stages (16-byte copies
//     with zero fill for ragged rows and the DP - d columns, in the
//     128-byte-swizzled layout the descriptors name): the next tile lands
//     while the current one is multiplied, one block barrier a tile.
//   * Causal query tiles launch heaviest first, so the light ones fill the
//     tail of the grid.
// Nothing is summed across blocks: two launches give the same bits.
// Tile sizes: 64 query rows against 64-key tiles, two stages, 65 KB of
// shared memory and at most 170 registers a thread (ptxas: 168 at DP 128),
// so three blocks share an SM; with only one warpgroup a block, the blocks'
// products and softmaxes interleave.  Rejected, in two A/B calls on an H100
// (chip_smoke.py's flash_fwd_times over trees that differed only in these
// choices; PERF.md section 6): Q in a shared-memory tile read through its
// descriptor (two blocks an SM: 0.41 ms at the training shape
// [4, 2048, 32, 128] causal against 0.36); two warpgroups a block sharing
// each K/V stage (0.48 against 0.42 for the same design with Q in shared
// memory), 128-key tiles (0.60), and issuing tile it's Q K^T beside tile
// it - 1's P V with a third stage (0.51).
//
// bf16 with 128 < d <= 256 keeps WMMA 16x16x16 fragments
// (flash_fwd_tc_kernel): S and P through shared memory, O in shared memory
// in f32.  f32 inputs run a SIMT kernel (no tensor-core path keeps full
// f32): four threads share a query row, each holding a quarter of q and of
// the accumulator in registers (interleaved columns, four banks) and
// summing partial scores with two shuffles.
#include <mma.h>

#include "common.cuh"
#include "flash_common.cuh"

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
  const cudaError_t e = ptt::sm90::set_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
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
  const cudaError_t e = ptt::sm90::set_smem(flash_fwd_tc_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((sq + kTcBQ - 1) / kTcBQ, hq, b);
  flash_fwd_tc_kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(pad_lens), static_cast<bf16*>(out), static_cast<float*>(lse),
      sq, sk, hq, hkv, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16, head_dim <= 128: wgmma, S, P and O in registers, cp.async tile ring
// ---------------------------------------------------------------------------
namespace hw = ptt::sm90;

// One warpgroup of 128 threads a block; its accumulators' 64 rows (wgmma's
// m) are the block's query tile, and the streamed K/V tiles are 64 rows too
constexpr int kWgThreads = 128;
constexpr int kBR = 64;      // rows of a query tile or a streamed K/V tile
constexpr int kStages = 2;   // depth of the ring of K/V tiles

// Online softmax of the key tile at t0 over s, for this thread's rows row0
// and row0 + 8 (the accumulator layout: element 4 j + 2 i + e of s is key
// t0 + 8 j + 2 quad + e of row row0 + 8 i).  m is the running max of the
// scores times scale * log2(e), l this thread's share of the running sum;
// s becomes p = 2^(s scale log2(e) - m), alpha the rescaling of the rows'
// earlier sums.  A row with every key masked so far keeps m = -inf; a finite
// reference point turns p and alpha into exact zeros.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int t0, int row0, int quad,
                                             bool edge, int pad, int sk, int causal, int offset,
                                             float sl2) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (edge) {  // keys [lo, hi) of the tile are live for this row
      const int lo = pad - t0;
      const int hi = min(sk, causal ? row0 + 8 * i + offset + 1 : sk) - t0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * quad + e;
          if (c < lo || c >= hi) s[4 * j + 2 * i + e] = -INFINITY;
        }
    }
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) mt = fmaxf(mt, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m[i], mt * sl2);
    const float m_ok = m_new == -INFINITY ? 0.f : m_new;
    alpha[i] = hw::exp2_approx(m[i] - m_ok);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * i + e];
        x = hw::exp2_approx(fmaf(x, sl2, -m_ok));
        ps += x;
      }
    l[i] = l[i] * alpha[i] + ps;
    m[i] = m_new;
  }
}

// B3: one block per (tile of 64 query rows, q head, batch row).  Q stays in
// registers; K and V stream through a ring of kStages stages.
template <int DP>
__global__ void __launch_bounds__(kWgThreads, 3)
fwd_wg(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
       const int* __restrict__ pad_lens, bf16* __restrict__ out, float* __restrict__ lse,
       int sq, int sk, int hq, int hkv, int d, float scale, int causal) {
  constexpr int kBQ = kBR, kBK = kBR, kThreads = kWgThreads;
  extern __shared__ unsigned char smem_raw[];
  bf16* KVs = hw::smem_base(smem_raw);  // stage st: K at KVs + 2 st kBK DP, V after it

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad = lane & 3;
  // the last query tiles see the most keys under the causal mask: launched
  // first, they leave the light ones for the end of the grid
  const int b = blockIdx.z, h = blockIdx.y, q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int hk = h / (hq / hkv);
  const int offset = sk - sq;
  const int pad = pad_lens != nullptr ? pad_lens[b] : 0;
  const int64_t q_stride = static_cast<int64_t>(hq) * d;
  const int64_t kv_stride = static_cast<int64_t>(hkv) * d;
  const int64_t q_base = static_cast<int64_t>(b) * sq * q_stride + static_cast<int64_t>(h) * d;
  const int64_t kv_base = static_cast<int64_t>(b) * sk * kv_stride + static_cast<int64_t>(hk) * d;

  // key tiles [k_begin, k_end): none wholly left of the pad or above the
  // diagonal is loaded
  const int last_row = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(sk, last_row + offset + 1) : sk;
  const int k_begin = (pad / kBK) * kBK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  auto load_kv = [&](int it) {
    bf16* Kt = KVs + 2 * (it % kStages) * kBK * DP;
    const int t0 = k_begin + it * kBK;
    const int64_t at = kv_base + static_cast<int64_t>(t0) * kv_stride;
    hw::load_tile_sw128<kBK, DP, kThreads>(Kt, k + at, kv_stride, sk - t0, d, tid);
    hw::load_tile_sw128<kBK, DP, kThreads>(Kt + kBK * DP, v + at, kv_stride, sk - t0, d, tid);
  };
  if (n_tiles > 0) load_kv(0);
  hw::cp_async_commit();
  // Q in bf16 as the A operand of each 16-column k step of S = Q K^T, read
  // once from device memory while tile 0 lands; rows >= sq and columns >= d
  // are zero
  uint32_t qa[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = q0 + warp * 16 + (lane >> 2) + 8 * (x & 1);
      const int c = 16 * kk + 2 * quad + 8 * (x >> 1);
      qa[kk][x] = r < sq && c < d
                      ? *reinterpret_cast<const uint32_t*>(q + q_base + r * q_stride + c)
                      : 0u;
    }

  float o[DP / 2];
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) o[x] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  const float sl2 = scale * hw::kLog2e;
  const int row0 = q0 + warp * 16 + (lane >> 2);  // this thread's rows: row0, row0 + 8
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = k_begin + it * kBK;
    const bf16* Kt = KVs + 2 * (it % kStages) * kBK * DP;
    const bf16* Vt = Kt + kBK * DP;
    hw::cp_async_wait<0>();
    __syncthreads();  // tile it has landed; tile it - 1's stage is free
    if (it + 1 < n_tiles) load_kv(it + 1);
    hw::cp_async_commit();

    float s[32];  // S = Q K^T, [64 rows][64 keys]
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      hw::wgmma_rs_m64n64(s, qa[kk], hw::desc_kmajor(Kt, kBK, kk), kk);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(s);

    // only a tile that crosses the pad, the diagonal or the last key masks
    // per element
    const bool edge = t0 < pad || t0 + kBK > sk || (causal && t0 + kBK - 1 > q0 + offset);
    softmax_tile(s, m, l, alpha, t0, row0, quad, edge, pad, sk, causal, offset, sl2);
#pragma unroll
    for (int x = 0; x < DP / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
    uint32_t a[4][4];  // P in bf16 as the A operand
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hw::acc_to_a(s, kk, a[kk]);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)  // O += P V
      hw::wgmma_rs_tb<DP>(o, a[kk], hw::desc_mnmajor(Vt, kBK, kk), 1);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(o);
    hw::fence_regs(a);
  }
  hw::cp_async_wait<0>();

  float ld[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    ld[i] = l[i] == 0.f ? 1.f : l[i];  // rows with no valid key: zeros
  }
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) o[x] /= ld[(x >> 1) & 1];
  hw::store_acc(o, out + q_base, q_stride, row0, sq, d, quad);
  if (quad == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row0 + 8 * i < sq)  // natural log: lse = (m + log2 l) ln 2
        lse[(static_cast<int64_t>(b) * hq + h) * sq + row0 + 8 * i] =
            (m[i] + log2f(ld[i])) * hw::kLn2;
  }
}

template <int DP>
int launch_wg(const void* q, const void* k, const void* v, const void* pad_lens, void* out,
              void* lse, int b, int sq, int sk, int hq, int hkv, int d, float scale,
              int causal, cudaStream_t stream) {
  // the stages of K, V; 1024 bytes of alignment slack
  const size_t smem = 2 * kStages * kBR * DP * sizeof(bf16) + 1024;
  auto kernel = fwd_wg<DP>;
  const cudaError_t e = hw::set_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3((sq + kBR - 1) / kBR, hq, b), kWgThreads, smem, stream>>>(
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
  if (dtype != ptt::kBF16)
    return dispatch_f32(q, k, v, pad_lens, out, lse, b, sq, sk, hq, hkv, d, scale, causal, s);
  if (d <= 64)
    return launch_wg<64>(q, k, v, pad_lens, out, lse, b, sq, sk, hq, hkv, d, scale, causal, s);
  if (d <= 128)
    return launch_wg<128>(q, k, v, pad_lens, out, lse, b, sq, sk, hq, hkv, d, scale, causal, s);
  return launch_bf16(q, k, v, pad_lens, out, lse, b, sq, sk, hq, hkv, d, scale, causal, s);
}
