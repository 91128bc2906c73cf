// B3b and B3c: flash-attention backward (FA2), causal or not, no padding.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py: _flash_bwd -> _bwd,
// whose two pallas_calls are _bwd_dq_kernel (flash_attention.py:315) and
// _bwd_dkv_kernel (flash_attention.py:350).  Same function and the same
// split, in the public [b, s, h, d] layout: probabilities are recomputed from
// the forward's f32 logsumexp, p = exp(s * scale - lse); with
// delta = rowsum(dO * O) in f32 and dp = dO V^T,
// ds = p * (dp - delta) * scale; dQ = ds K, dK = ds^T Q, dV = p^T dO, each
// accumulated in f32 and cast to the input dtype last; P and dS are rounded
// to bf16 before their products, as the TPU kernel does (p.astype(do.dtype)
// :292, ds.astype(k.dtype) :255, :298).  Causal masking is bottom-right
// aligned (query row i sees keys <= i + sk - sq), and tiles wholly above
// the diagonal are skipped, as _causal_live does.  A row whose lse is -inf
// (no valid key) has p = 0.
//
// Why the split and not atomics: the dq kernel is one block per (query
// tile, q head, batch row) and loops over key tiles; it computes delta for
// its rows first and exports it (delta_out, as _bwd_dq_kernel does at
// flash_attention.py:228-234).  The dkv kernel is one block per (key tile,
// kv head, batch row) and loops over the rep = hq / hkv query heads of its
// GQA group and over their query tiles, so the group sum of dK and dV stays
// inside one block (the TPU grid's (rep, nq) axes at :352).  Every sum runs
// in one block in a fixed order, so two launches give the same bits.  One
// fused pass with dQ summed by atomics would do 5 products instead of 7,
// at the cost of that reproducibility.
//
// Bound on the H100: the tensor cores.  B3b recomputes S and dP and does
// dQ (three products of the causal [s, s] by d work), B3c recomputes S and
// dP and does dV and dK (four): at the training shape [4, 2048, 32, 128]
// causal 0.2086 and 0.2781 ms at 989 TFLOP/s, together 0.487 ms.  The
// whole function needs 5 products (SDPA's fused backward: 0.906 ms on this
// card), the yardstick, not the bound of this split.
//
// bf16 with head_dim <= 128 (bwd_dq_wg, bwd_dkv_wg; the head dim padded
// with zero columns to DP = 64 or 128): each warpgroup of 128 threads owns
// 64 rows of the block's resident operand, and every product is a Hopper
// wgmma (m64nNk16, f32 accumulators in registers; wgmma.cuh).
//   * S and dP never leave registers.  B3b: S = Q K^T and dP = dO V^T are
//     wgmma with Q/dO (resident) and K/V (streamed) from shared memory,
//     both K-major; p and ds are computed in the accumulators, whose
//     (row, column) each thread knows from the wgmma layout, with its rows'
//     lse and delta in registers; ds, rounded to bf16x2, is already the
//     register A operand of dQ += dS K, whose B is the K tile read through
//     the transpose bit.  B3c computes S^T = K Q^T and dP^T = V dO^T (K/V
//     resident), so P^T and dS^T are born as the A operands of
//     dV += P^T dO and dK += dS^T Q; a column's lse and delta come from
//     shared memory beside its Q tile.  No S, dP or P tile exists in shared
//     memory, and no f32 -> bf16 pass over dS.  exp(s * scale - lse) is
//     ex2.approx of the same argument in base 2.
//   * Loads are asynchronous: the streamed tiles (K, V in B3b; Q, dO and
//     their lse, delta rows in B3c) come through a ring of kStages = 2
//     shared-memory stages by cp.async 16-byte copies with zero fill for
//     ragged rows and the DP - d columns, written in the 128-byte-swizzled
//     layout the wgmma descriptors name.  The next tile lands while the
//     current one is multiplied; one block barrier per tile frees its stage,
//     and the wgmma fence/commit/wait discipline orders the products (exp(S)
//     runs while dP's wgmma is in flight).
//   * Only tiles the causal mask leaves live are visited, and only a tile
//     that crosses the diagonal or the ragged edge masks per element.
// Tile sizes: one warpgroup a block in both kernels, 64 rows of the
// resident operand against 64-row streamed tiles, 97-98 KB of shared
// memory, so two blocks fit an SM; ptxas reports no spill (chip_smoke.py
// prints its report).  Rejected: two warpgroups a block (128 resident rows
// sharing each streamed tile, one block an SM); in chip_smoke.py's timing
// on an H100, B3c at two warpgroups took 0.7313-0.7456 ms at the training
// shape, at one 0.6889-0.6944 ms, in separate runs.  Not taken, for
// reasons rather than a committed timing: a third stage (B3b's 129 KB
// would fit one block an SM, not two), and Q held in registers as S's A
// operand in B3b (32 more registers a thread for an operand that its
// shared-memory descriptor already serves).
//
// bf16 with 128 < d <= 256 keeps the WMMA kernels (bwd_dq_tc, bwd_dkv_tc):
// 16x16x16 fragments, 32-key tiles, S and dP through shared memory in f32.
// f32 inputs run SIMT kernels (no tensor-core path keeps full f32): eight
// threads share a row, each holding an eighth of its vectors in registers,
// and stream the other operand through shared memory.
#include <mma.h>

#include "common.cuh"
#include "flash_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: SIMT
// ---------------------------------------------------------------------------
constexpr int kThreads = 128;
constexpr int kRT = 8;                  // threads per row
constexpr int kRows = kThreads / kRT;   // rows per block
constexpr int kTile = 32;               // rows of the streamed operand per tile

__device__ __forceinline__ float row_sum(float v) {  // over a row's kRT lanes
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}

template <int DPT>
__global__ void __launch_bounds__(kThreads)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ o,
           const float* __restrict__ dout, const float* __restrict__ lse,
           float* __restrict__ dq, float* __restrict__ delta_out, int sq, int sk,
           int hq, int hkv, int d, float scale, int causal) {
  extern __shared__ float smem[];
  float* ks = smem;              // [kTile][d]
  float* vs = smem + kTile * d;  // [kTile][d]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int hk = h / (hq / hkv);
  const int sub = threadIdx.x % kRT;
  const int row = q0 + threadIdx.x / kRT;
  const bool row_ok = row < sq;
  const int offset = sk - sq;
  const int64_t qoff = ((static_cast<int64_t>(b) * sq + row) * hq + h) * d;

  float qr[DPT], dor[DPT], acc[DPT];
  float delta = 0.f;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int c = sub + kRT * i;
    const bool ok = row_ok && c < d;
    qr[i] = ok ? q[qoff + c] : 0.f;
    dor[i] = ok ? dout[qoff + c] : 0.f;
    delta += ok ? dor[i] * o[qoff + c] : 0.f;
    acc[i] = 0.f;
  }
  delta = row_sum(delta);
  const int64_t lrow = (static_cast<int64_t>(b) * hq + h) * sq + row;
  const float lse_r = row_ok ? lse[lrow] : 0.f;
  if (row_ok && sub == 0) delta_out[lrow] = delta;

  const int last_row = min(q0 + kRows, sq) - 1;
  const int k_end = causal ? min(sk, last_row + offset + 1) : sk;
  const int64_t kv_stride = static_cast<int64_t>(hkv) * d;
  const int64_t kv_base = static_cast<int64_t>(b) * sk * kv_stride +
                          static_cast<int64_t>(hk) * d;
  for (int t0 = 0; t0 < k_end; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < kTile * d; e += kThreads) {
      const int jr = e / d, c = e - jr * d;
      const int kr = t0 + jr;
      const bool ok = kr < sk;
      const int64_t off = kv_base + kr * kv_stride + c;
      ks[e] = ok ? k[off] : 0.f;
      vs[e] = ok ? v[off] : 0.f;
    }
    __syncthreads();
    const int jn = min(kTile, k_end - t0);
    for (int j = 0; j < jn; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        const int c = sub + kRT * i;
        if (c < d) {
          s += qr[i] * ks[j * d + c];
          dp += dor[i] * vs[j * d + c];
        }
      }
      s = row_sum(s);
      dp = row_sum(dp);
      const int col = t0 + j;
      const bool ok = row_ok && (!causal || col <= row + offset) && lse_r != -INFINITY;
      const float p = ok ? expf(s * scale - lse_r) : 0.f;
      const float ds = p * (dp - delta) * scale;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        const int c = sub + kRT * i;
        if (c < d) acc[i] += ds * ks[j * d + c];
      }
    }
  }
  if (row_ok) {
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int c = sub + kRT * i;
      if (c < d) dq[qoff + c] = acc[i];
    }
  }
}

template <int DPT>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int sq, int sk, int hq,
            int hkv, int d, float scale, int causal) {
  extern __shared__ float smem[];
  float* qs = smem;                 // [kTile][d]
  float* dos = smem + kTile * d;    // [kTile][d]
  float* ls = dos + kTile * d;      // [kTile] lse of the tile's rows
  float* dls = ls + kTile;          // [kTile] delta of the tile's rows
  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * kRows;
  const int rep = hq / hkv;
  const int sub = threadIdx.x % kRT;
  const int key = k0 + threadIdx.x / kRT;
  const bool key_ok = key < sk;
  const int offset = sk - sq;
  const int64_t koff = ((static_cast<int64_t>(b) * sk + key) * hkv + hk) * d;

  float kr[DPT], vr[DPT], dka[DPT], dva[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int c = sub + kRT * i;
    const bool ok = key_ok && c < d;
    kr[i] = ok ? k[koff + c] : 0.f;
    vr[i] = ok ? v[koff + c] : 0.f;
    dka[i] = 0.f;
    dva[i] = 0.f;
  }
  // the first query row that sees key k0 is k0 - offset
  const int q_begin = causal ? max(0, k0 - offset) : 0;
  const int64_t q_stride = static_cast<int64_t>(hq) * d;
  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    const int64_t q_base = static_cast<int64_t>(b) * sq * q_stride +
                           static_cast<int64_t>(h) * d;
    const int64_t l_base = (static_cast<int64_t>(b) * hq + h) * sq;
    for (int t0 = q_begin; t0 < sq; t0 += kTile) {
      __syncthreads();  // the previous tile is consumed
      for (int e = threadIdx.x; e < kTile * d; e += kThreads) {
        const int ir = e / d, c = e - ir * d;
        const int qr_ = t0 + ir;
        const bool ok = qr_ < sq;
        const int64_t off = q_base + qr_ * q_stride + c;
        qs[e] = ok ? q[off] : 0.f;
        dos[e] = ok ? dout[off] : 0.f;
      }
      for (int i = threadIdx.x; i < kTile; i += kThreads) {
        const bool ok = t0 + i < sq;
        ls[i] = ok ? lse[l_base + t0 + i] : -INFINITY;
        dls[i] = ok ? delta[l_base + t0 + i] : 0.f;
      }
      __syncthreads();
      const int in = min(kTile, sq - t0);
      for (int i = 0; i < in; ++i) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const int c = sub + kRT * j;
          if (c < d) {
            s += kr[j] * qs[i * d + c];
            dp += vr[j] * dos[i * d + c];
          }
        }
        s = row_sum(s);
        dp = row_sum(dp);
        const int row = t0 + i;
        const bool ok = key_ok && (!causal || key <= row + offset) && ls[i] != -INFINITY;
        const float p = ok ? expf(s * scale - ls[i]) : 0.f;
        const float ds = p * (dp - dls[i]) * scale;
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const int c = sub + kRT * j;
          if (c < d) {
            dva[j] += p * dos[i * d + c];
            dka[j] += ds * qs[i * d + c];
          }
        }
      }
    }
  }
  if (key_ok) {
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int c = sub + kRT * i;
      if (c < d) {
        dk[koff + c] = dka[i];
        dv[koff + c] = dva[i];
      }
    }
  }
}

using ptt::sm90::set_smem;  // the largest carveout: two ~100 KB blocks an SM

template <int DPT>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* dq, void* dk, void* dv,
               void* delta, int b, int sq, int sk, int hq, int hkv, int d,
               float scale, int causal, bool dq_pass, cudaStream_t s) {
  if (dq_pass) {
    const size_t smem = 2 * static_cast<size_t>(kTile) * d * sizeof(float);
    auto kernel = bwd_dq_f32<DPT>;
    cudaError_t e = set_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<dim3((sq + kRows - 1) / kRows, hq, b), kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<float*>(dq), static_cast<float*>(delta), sq, sk, hq, hkv, d, scale,
        causal);
  } else {
    const size_t smem = (2 * static_cast<size_t>(kTile) * d + 2 * kTile) * sizeof(float);
    auto kernel = bwd_dkv_f32<DPT>;
    cudaError_t e = set_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<dim3((sk + kRows - 1) / kRows, hkv, b), kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv), sq, sk, hq, hkv, d, scale,
        causal);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const void* lse, void* dq, void* dk, void* dv,
                 void* delta, int b, int sq, int sk, int hq, int hkv, int d, float scale,
                 int causal, bool dq_pass, cudaStream_t s) {
  const int dpt = (d + kRT - 1) / kRT;
#define PTT_F32(N)                                                                 \
  return launch_f32<N>(q, k, v, o, dout, lse, dq, dk, dv, delta, b, sq, sk, hq, hkv, \
                       d, scale, causal, dq_pass, s)
  if (dpt <= 2) PTT_F32(2);
  if (dpt <= 4) PTT_F32(4);
  if (dpt <= 8) PTT_F32(8);
  if (dpt <= 16) PTT_F32(16);
  PTT_F32(32);
#undef PTT_F32
}

// ---------------------------------------------------------------------------
// bf16, 128 < head_dim <= 256: WMMA fragments (launch_tc<32>)
// ---------------------------------------------------------------------------
namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;
using Acc = wm::fragment<wm::accumulator, 16, 16, 16, float>;

constexpr int kTcThreads = 128;  // four warps
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcBQ = 64;        // query rows per tile, 16 per warp

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Shared-memory layout for head_dim d padded to dp (a multiple of 16) and a
// key tile of bk rows: the K, V, Q and dO tiles in bf16, S and dP in f32,
// and one bf16 tile X for the products' left operand (dS in the dq kernel;
// P, then dS, in the dkv kernel).  The accumulators live in registers; at
// d <= 256 with 32-key tiles a block stays inside the SM's 227 KB.  Row
// strides are padded off a multiple of 128 bytes against bank conflicts;
// every region starts on a 128-byte boundary and every fragment on a
// 32-byte one, as WMMA loads require.  K and V are adjacent, so the dq
// kernel's 64-row O tile fits over them while delta is computed.
struct TcLayout {
  int dp, ldh, lds, ldp;
  size_t k, v, q, dout, s, dp_, x, lse, delta, bytes;
};

__host__ __device__ inline TcLayout tc_layout(int d, int bk, bool dkv) {
  TcLayout t;
  t.dp = (d + 15) / 16 * 16;
  t.ldh = t.dp + 8;
  t.lds = bk + 4;
  t.ldp = bk + 8;
  size_t at = 0;
  auto take = [&at](size_t bytes) {
    const size_t here = at;
    at = align128(at + bytes);
    return here;
  };
  t.k = take(sizeof(bf16) * bk * t.ldh);
  t.v = take(sizeof(bf16) * bk * t.ldh);
  t.q = take(sizeof(bf16) * kTcBQ * t.ldh);
  t.dout = take(sizeof(bf16) * kTcBQ * t.ldh);
  t.s = take(sizeof(float) * kTcBQ * t.lds);
  t.dp_ = take(sizeof(float) * kTcBQ * t.lds);
  t.x = take(sizeof(bf16) * kTcBQ * t.ldp);
  t.lse = dkv ? take(sizeof(float) * kTcBQ) : 0;
  t.delta = dkv ? take(sizeof(float) * kTcBQ) : 0;
  t.bytes = at;
  return t;
}

// `rows` rows of d bf16 (row stride src_stride elements) into a [rows][ld]
// tile, 16 bytes a thread per load; rows >= rows_valid and columns [d, dp)
// are zero.
__device__ inline void load_tile(bf16* dst, int ld, const bf16* src, int64_t src_stride,
                                 int rows, int rows_valid, int d, int dp) {
  const int vecs = dp / 8;
  for (int e = threadIdx.x; e < rows * vecs; e += kTcThreads) {
    const int r = e / vecs, c = (e - r * vecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid && c < d) val = *reinterpret_cast<const uint4*>(src + r * src_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// out[16 rows of this warp][BK] = A[warp rows][dp] . B[BK][dp]^T, in f32
template <int BK>
__device__ inline void warp_abt(float* out, int lds, const bf16* A, const bf16* B, int ldh,
                                int dp, int warp) {
  Acc acc[BK / 16];
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) wm::fill_fragment(acc[n], 0.f);
  for (int kk = 0; kk < dp; kk += 16) {
    wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
    wm::load_matrix_sync(a, A + warp * 16 * ldh + kk, ldh);
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> bt;
      wm::load_matrix_sync(bt, B + n * 16 * ldh + kk, ldh);
      wm::mma_sync(acc[n], a, bt, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < BK / 16; ++n)
    wm::store_matrix_sync(out + warp * 16 * lds + n * 16, acc[n], lds, wm::mem_row_major);
}

// Write a 16x16 f32 fragment as bf16 into rows [r0, r0 + 16) and columns
// [c0, c0 + 16) of a [rows][d] global tensor with row stride `stride`,
// through the warp's 16x16 staging area; rows >= rows_valid and columns
// >= d are not written.
__device__ inline void store_frag(const Acc& f, float* stage, bf16* dst, int64_t stride,
                                  int r0, int c0, int rows_valid, int d, int lane) {
  wm::store_matrix_sync(stage, f, 16, wm::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 256; e += 32) {
    const int r = r0 + (e >> 4), c = c0 + (e & 15);
    if (r < rows_valid && c < d) dst[r * stride + c] = __float2bfloat16(stage[e]);
  }
  __syncwarp();
}

// p (and ds) of row r_loc of the 64-row query tile (row `row` of the
// sequence), over the half `half` of the BK key columns starting at key
// `key0`, from S and dP.  The dq kernel writes dS in bf16 to X; the dkv
// kernel writes P in bf16 to X and ds in f32 over dP, for X later.
template <int BK, bool kDkv>
__device__ inline void probs_and_ds(const float* S, float* dP, int lds, bf16* X, int ldp,
                                    int r_loc, int half, int row, int sq, int key0, int sk,
                                    float lse_r, float delta_r, float scale, int causal,
                                    int offset) {
  const int c0 = half * (BK / 2);
  const float* srow = S + r_loc * lds + c0;
  float* dprow = dP + r_loc * lds + c0;
  bf16* xrow = X + r_loc * ldp + c0;
  const bool row_ok = row < sq && lse_r != -INFINITY;
#pragma unroll 8
  for (int j = 0; j < BK / 2; ++j) {
    const int col = key0 + c0 + j;
    const bool ok = row_ok && col < sk && (!causal || col <= row + offset);
    const float p = ok ? expf(srow[j] * scale - lse_r) : 0.f;
    const float ds = p * (dprow[j] - delta_r) * scale;
    if (kDkv) {
      xrow[j] = __float2bfloat16(p);
      dprow[j] = ds;
    } else {
      xrow[j] = __float2bfloat16(ds);
    }
  }
}

template <int BK>
__global__ void __launch_bounds__(kTcThreads)
bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ o, const bf16* __restrict__ dout,
          const float* __restrict__ lse, bf16* __restrict__ dq,
          float* __restrict__ delta_out, int sq, int sk, int hq, int hkv, int d,
          float scale, int causal) {
  constexpr int kFrags = BK == 64 ? 8 : 16;  // dQ column tiles of a warp (dp <= 128 / 256)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const TcLayout L = tc_layout(d, BK, false);
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + L.q);
  bf16* dOs = reinterpret_cast<bf16*>(smem_raw + L.dout);
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw + L.v);
  float* Ss = reinterpret_cast<float*>(smem_raw + L.s);
  float* dPs = reinterpret_cast<float*>(smem_raw + L.dp_);
  bf16* dSs = reinterpret_cast<bf16*>(smem_raw + L.x);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTcBQ;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int offset = sk - sq;
  const int64_t q_stride = static_cast<int64_t>(hq) * d;
  const int64_t kv_stride = static_cast<int64_t>(hkv) * d;
  const int64_t q_base = static_cast<int64_t>(b) * sq * q_stride + static_cast<int64_t>(h) * d;

  load_tile(Qs, L.ldh, q + q_base + q0 * q_stride, q_stride, kTcBQ, sq - q0, d, L.dp);
  load_tile(dOs, L.ldh, dout + q_base + q0 * q_stride, q_stride, kTcBQ, sq - q0, d, L.dp);
  load_tile(Ks, L.ldh, o + q_base + q0 * q_stride, q_stride, kTcBQ, sq - q0, d, L.dp);  // O over K|V
  __syncthreads();

  // lanes 2i and 2i+1 of a warp share its query row i: half the columns each
  const int r_loc = warp * 16 + (lane >> 1);
  const int row = q0 + r_loc;
  const int half = lane & 1;
  float delta_r = 0.f;
  for (int c = half; c < d; c += 2)
    delta_r += __bfloat162float(dOs[r_loc * L.ldh + c]) * __bfloat162float(Ks[r_loc * L.ldh + c]);
  delta_r += __shfl_xor_sync(0xffffffffu, delta_r, 1);
  const int64_t lrow = (static_cast<int64_t>(b) * hq + h) * sq + row;
  const float lse_r = row < sq ? lse[lrow] : 0.f;
  if (row < sq && half == 0) delta_out[lrow] = delta_r;

  Acc acc[kFrags];  // dQ of this warp's 16 rows, 16 columns each
#pragma unroll
  for (int n = 0; n < kFrags; ++n) wm::fill_fragment(acc[n], 0.f);

  const int last_row = min(q0 + kTcBQ, sq) - 1;
  const int k_end = causal ? min(sk, last_row + offset + 1) : sk;
  const int64_t kv_base = static_cast<int64_t>(b) * sk * kv_stride + static_cast<int64_t>(hk) * d;
  for (int t0 = 0; t0 < k_end; t0 += BK) {
    __syncthreads();  // the previous tiles (and the O tile) are consumed
    load_tile(Ks, L.ldh, k + kv_base + t0 * kv_stride, kv_stride, BK, sk - t0, d, L.dp);
    load_tile(Vs, L.ldh, v + kv_base + t0 * kv_stride, kv_stride, BK, sk - t0, d, L.dp);
    __syncthreads();
    warp_abt<BK>(Ss, L.lds, Qs, Ks, L.ldh, L.dp, warp);   // S = Q K^T
    warp_abt<BK>(dPs, L.lds, dOs, Vs, L.ldh, L.dp, warp); // dP = dO V^T
    __syncwarp();
    probs_and_ds<BK, false>(Ss, dPs, L.lds, dSs, L.ldp, r_loc, half, row, sq, t0, sk,
                            lse_r, delta_r, scale, causal, offset);
    __syncwarp();
    // dQ += dS K for this warp's rows
    wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> da[BK / 16];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wm::load_matrix_sync(da[kk], dSs + warp * 16 * L.ldp + kk * 16, L.ldp);
#pragma unroll
    for (int n = 0; n < kFrags; ++n) {
      if (n * 16 < L.dp) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> kf;
          wm::load_matrix_sync(kf, Ks + kk * 16 * L.ldh + n * 16, L.ldh);
          wm::mma_sync(acc[n], da[kk], kf, acc[n]);
        }
      }
    }
  }
  // stage each fragment through this warp's own rows of S (no other warp
  // reads them any more) and write dQ in bf16
  float* stage = Ss + warp * 16 * L.lds;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < kFrags; ++n)
    if (n * 16 < L.dp)
      store_frag(acc[n], stage, dq + q_base, q_stride, q0 + warp * 16, n * 16, sq, d, lane);
}

// C[j] += X^T Y for the 16x16 output tiles t = warp + 4j of [BK][dp], with
// X [64][BK] (query rows by keys) and Y [64][dp] in shared memory
template <int BK, int kTiles>
__device__ inline void acc_xty(Acc (&C)[kTiles], const bf16* X, int ldp, const bf16* Y,
                               int ldh, int dp, int warp) {
  const int nt = dp / 16;
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const int t = warp + kTcWarps * j;
    if (t < (BK / 16) * nt) {
      const int i0 = (t / nt) * 16, n0 = (t % nt) * 16;
#pragma unroll
      for (int kk = 0; kk < kTcBQ; kk += 16) {
        // X^T's 16x16 tile at (i0, kk), read column-major from X
        wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::col_major> xt;
        wm::load_matrix_sync(xt, X + kk * ldp + i0, ldp);
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> y;
        wm::load_matrix_sync(y, Y + kk * ldh + n0, ldh);
        wm::mma_sync(C[j], xt, y, C[j]);
      }
    }
  }
}

template <int BK>
__global__ void __launch_bounds__(kTcThreads)
bwd_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const bf16* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
           int sq, int sk, int hq, int hkv, int d, float scale, int causal) {
  // output tiles of a warp per accumulator: (BK/16)(dp/16)/4 <= 8 for
  // BK 32 with dp <= 256
  constexpr int kTiles = 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const TcLayout L = tc_layout(d, BK, true);
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + L.q);
  bf16* dOs = reinterpret_cast<bf16*>(smem_raw + L.dout);
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw + L.v);
  float* Ss = reinterpret_cast<float*>(smem_raw + L.s);
  float* dPs = reinterpret_cast<float*>(smem_raw + L.dp_);
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw + L.x);
  float* lse_s = reinterpret_cast<float*>(smem_raw + L.lse);
  float* delta_s = reinterpret_cast<float*>(smem_raw + L.delta);

  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * BK;
  const int rep = hq / hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int offset = sk - sq;
  const int64_t q_stride = static_cast<int64_t>(hq) * d;
  const int64_t kv_stride = static_cast<int64_t>(hkv) * d;
  const int64_t kv_base = static_cast<int64_t>(b) * sk * kv_stride + static_cast<int64_t>(hk) * d;

  load_tile(Ks, L.ldh, k + kv_base + k0 * kv_stride, kv_stride, BK, sk - k0, d, L.dp);
  load_tile(Vs, L.ldh, v + kv_base + k0 * kv_stride, kv_stride, BK, sk - k0, d, L.dp);
  Acc dk_acc[kTiles], dv_acc[kTiles];
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    wm::fill_fragment(dk_acc[j], 0.f);
    wm::fill_fragment(dv_acc[j], 0.f);
  }

  const int r_loc = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  // the first query row that sees key k0 is k0 - offset
  const int q_begin = causal ? max(0, k0 - offset) : 0;
  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    const int64_t q_base = static_cast<int64_t>(b) * sq * q_stride + static_cast<int64_t>(h) * d;
    const int64_t l_base = (static_cast<int64_t>(b) * hq + h) * sq;
    for (int t0 = q_begin; t0 < sq; t0 += kTcBQ) {
      __syncthreads();  // the previous tiles are consumed
      load_tile(Qs, L.ldh, q + q_base + t0 * q_stride, q_stride, kTcBQ, sq - t0, d, L.dp);
      load_tile(dOs, L.ldh, dout + q_base + t0 * q_stride, q_stride, kTcBQ, sq - t0, d, L.dp);
      if (threadIdx.x < kTcBQ) {
        const bool ok = t0 + threadIdx.x < sq;
        lse_s[threadIdx.x] = ok ? lse[l_base + t0 + threadIdx.x] : 0.f;
        delta_s[threadIdx.x] = ok ? delta[l_base + t0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
      warp_abt<BK>(Ss, L.lds, Qs, Ks, L.ldh, L.dp, warp);   // S = Q K^T
      warp_abt<BK>(dPs, L.lds, dOs, Vs, L.ldh, L.dp, warp); // dP = dO V^T
      __syncwarp();
      probs_and_ds<BK, true>(Ss, dPs, L.lds, Xs, L.ldp, r_loc, half, t0 + r_loc, sq, k0, sk,
                             lse_s[r_loc], delta_s[r_loc], scale, causal, offset);
      __syncthreads();  // dV reads every warp's rows of P
      acc_xty<BK>(dv_acc, Xs, L.ldp, dOs, L.ldh, L.dp, warp);   // dV += P^T dO
      __syncthreads();  // P is consumed; X takes dS
      for (int e = threadIdx.x; e < kTcBQ * BK; e += kTcThreads) {
        const int i = e / BK, j = e - i * BK;
        Xs[i * L.ldp + j] = __float2bfloat16(dPs[i * L.lds + j]);
      }
      __syncthreads();
      acc_xty<BK>(dk_acc, Xs, L.ldp, Qs, L.ldh, L.dp, warp);    // dK += dS^T Q
    }
  }
  __syncthreads();  // S is free: each warp stages its fragments in its rows
  float* stage = Ss + warp * 16 * L.lds;
  const int nt = L.dp / 16;
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const int t = warp + kTcWarps * j;
    if (t < (BK / 16) * nt) {
      const int i0 = (t / nt) * 16, n0 = (t % nt) * 16;
      store_frag(dk_acc[j], stage, dk + kv_base, kv_stride, k0 + i0, n0, sk, d, lane);
      store_frag(dv_acc[j], stage, dv + kv_base, kv_stride, k0 + i0, n0, sk, d, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, head_dim <= 128: wgmma, S and dP in registers, cp.async tile ring
// ---------------------------------------------------------------------------
namespace hw = ptt::sm90;
// One warpgroup of 128 threads a block; its accumulators' 64 rows (wgmma's
// m) are the block's resident tile, and the streamed tiles are 64 rows too
constexpr int kWgThreads = 128;
constexpr int kBR = 64;      // rows of a resident or a streamed tile
constexpr int kStages = 2;   // depth of the ring of streamed tiles

// B3b: one block per (tile of 64 query rows, q head, batch row).  Q and dO
// stay in shared memory; K and V stream through a ring of kStages stages.
template <int DP>
__global__ void __launch_bounds__(kWgThreads, 2)
bwd_dq_wg(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ o, const bf16* __restrict__ dout,
          const float* __restrict__ lse, bf16* __restrict__ dq,
          float* __restrict__ delta_out, int sq, int sk, int hq, int hkv, int d,
          float scale, int causal) {
  constexpr int kBQ = kBR, kBK = kBR, kThreads = kWgThreads;
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = hw::smem_base(smem_raw);  // [kBQ][DP] SW128
  bf16* dOs = Qs + kBQ * DP;       // [kBQ][DP]
  bf16* KVs = dOs + kBQ * DP;      // stage st: K at KVs + 2 st kBK DP, V after it

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad = lane & 3;
  // the last query tiles see the most keys: launched first, they leave the
  // light ones for the end of the grid
  const int b = blockIdx.z, h = blockIdx.y, q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int hk = h / (hq / hkv);
  const int offset = sk - sq;
  const int64_t q_stride = static_cast<int64_t>(hq) * d;
  const int64_t kv_stride = static_cast<int64_t>(hkv) * d;
  const int64_t q_base = static_cast<int64_t>(b) * sq * q_stride + static_cast<int64_t>(h) * d;
  const int64_t kv_base = static_cast<int64_t>(b) * sk * kv_stride + static_cast<int64_t>(hk) * d;

  const int last_row = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(sk, last_row + offset + 1) : sk;
  const int n_tiles = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;
  auto load_kv = [&](int it) {
    bf16* Kt = KVs + 2 * (it % kStages) * kBK * DP;
    const int64_t at = kv_base + static_cast<int64_t>(it) * kBK * kv_stride;
    hw::load_tile_sw128<kBK, DP, kThreads>(Kt, k + at, kv_stride, sk - it * kBK, d, tid);
    hw::load_tile_sw128<kBK, DP, kThreads>(Kt + kBK * DP, v + at, kv_stride, sk - it * kBK, d,
                                           tid);
  };
  hw::load_tile_sw128<kBQ, DP, kThreads>(Qs, q + q_base + q0 * q_stride, q_stride, sq - q0, d,
                                         tid);
  hw::load_tile_sw128<kBQ, DP, kThreads>(dOs, dout + q_base + q0 * q_stride, q_stride, sq - q0,
                                         d, tid);
  for (int t = 0; t < kStages - 1; ++t) {  // Q and dO land with tile 0
    if (t < n_tiles) load_kv(t);
    hw::cp_async_commit();
  }

  // this thread's accumulator rows: r_lo and r_lo + 8 of the block's tile.
  // delta = rowsum(dO O) from global memory while the tiles land, the four
  // lanes of a row taking every fourth 8-column chunk
  const int r_lo = warp * 16 + (lane >> 2);
  float delta_r[2], lse_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r_lo + 8 * i;
    float acc = 0.f;
    if (row < sq) {
      const bf16* orow = o + q_base + row * q_stride;
      const bf16* drow = dout + q_base + row * q_stride;
      for (int c = quad * 8; c < d; c += 32) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]), df = __bfloat1622float2(d2[e]);
          acc = fmaf(df.x, of.x, acc);
          acc = fmaf(df.y, of.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    delta_r[i] = acc;
    const int64_t lrow = (static_cast<int64_t>(b) * hq + h) * sq + row;
    lse_r[i] = row < sq ? hw::lse_log2(lse[lrow]) : INFINITY;
    if (row < sq && quad == 0) delta_out[lrow] = acc;
  }

  float dq_acc[DP / 2];
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) dq_acc[x] = 0.f;
  const float sl2 = scale * hw::kLog2e;
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * kBK;
    const bf16* Kt = KVs + 2 * (it % kStages) * kBK * DP;
    const bf16* Vt = Kt + kBK * DP;
    hw::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile it has landed; tile it - 1's stage is free
    if (it + kStages - 1 < n_tiles) load_kv(it + kStages - 1);
    hw::cp_async_commit();
    if (causal && t0 > q0 + kBQ - 1 + offset) continue;

    float s[32], dp[32];  // S = Q K^T and dP = dO V^T, [64 rows][64 keys]
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      hw::wgmma_ss_m64n64(s, hw::desc_kmajor(Qs, kBQ, kk), hw::desc_kmajor(Kt, kBK, kk), kk);
    hw::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      hw::wgmma_ss_m64n64(dp, hw::desc_kmajor(dOs, kBQ, kk), hw::desc_kmajor(Vt, kBK, kk), kk);
    hw::wgmma_commit();
    hw::wgmma_wait<1>();  // S is done; p is computed while dP runs
    hw::fence_regs(s);

    // p over s, then ds = p (dp - delta) scale; only a tile that crosses
    // the diagonal or the last key masks per element
    const bool edge = (causal && t0 + kBK - 1 > q0 + offset) || t0 + kBK > sk;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int lim = min(sk, causal ? q0 + r_lo + 8 * i + offset + 1 : sk) - t0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * i + e;
          const float p = hw::exp2_approx(fmaf(s[x], sl2, -lse_r[i]));
          s[x] = edge && 8 * j + 2 * quad + e >= lim ? 0.f : p;
        }
    }
    hw::wgmma_wait<0>();
    hw::fence_regs(dp);
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = s[x] * (dp[x] - delta_r[(x >> 1) & 1]) * scale;
    uint32_t a[4][4];  // dS in bf16 as the A operand
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hw::acc_to_a(s, kk, a[kk]);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)  // dQ += dS K
      hw::wgmma_rs_tb<DP>(dq_acc, a[kk], hw::desc_mnmajor(Kt, kBK, kk), 1);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(dq_acc);
    hw::fence_regs(a);
  }
  hw::cp_async_wait<0>();
  hw::store_acc(dq_acc, dq + q_base, q_stride, q0 + r_lo, sq, d, quad);
}

// B3c: one block per (tile of 64 keys, kv head, batch row).  K and V stay in
// shared memory; the group's Q and dO tiles (64 rows) with their lse and
// delta stream through a ring of kStages stages.  S^T = K Q^T and
// dP^T = V dO^T leave P^T and dS^T in registers in the A layout of
// dV += P^T dO and dK += dS^T Q.
template <int DP>
__global__ void __launch_bounds__(kWgThreads, 2)
bwd_dkv_wg(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const bf16* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
           int sq, int sk, int hq, int hkv, int d, float scale, int causal) {
  constexpr int kBK = kBR, kBQ = kBR, kThreads = kWgThreads;
  static_assert(kThreads >= 2 * kBQ, "one thread a row for lse and delta");
  extern __shared__ unsigned char smem_raw[];
  bf16* Ks = hw::smem_base(smem_raw);  // [kBK][DP] SW128
  bf16* Vs = Ks + kBK * DP;
  bf16* QDs = Vs + kBK * DP;       // stage st: Q at QDs + 2 st kBQ DP, dO after it
  float* LDs = reinterpret_cast<float*>(QDs + 2 * kStages * kBQ * DP);  // stage st: lse, delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad = lane & 3;
  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * kBK;
  const int rep = hq / hkv;
  const int offset = sk - sq;
  const int64_t q_stride = static_cast<int64_t>(hq) * d;
  const int64_t kv_stride = static_cast<int64_t>(hkv) * d;
  const int64_t kv_base = static_cast<int64_t>(b) * sk * kv_stride + static_cast<int64_t>(hk) * d;

  // the first query row that sees key k0 is k0 - offset; tiles run over the
  // group's rep heads, n_qt tiles each
  const int q_begin = causal ? max(0, k0 - offset) : 0;
  const int n_qt = q_begin < sq ? (sq - q_begin + kBQ - 1) / kBQ : 0;
  const int n_tiles = rep * n_qt;
  auto load_q = [&](int it) {
    const int r = it / n_qt, t0 = q_begin + (it - r * n_qt) * kBQ;
    const int h = hk * rep + r;
    const int64_t at = static_cast<int64_t>(b) * sq * q_stride + static_cast<int64_t>(h) * d +
                       t0 * q_stride;
    bf16* Qt = QDs + 2 * (it % kStages) * kBQ * DP;
    hw::load_tile_sw128<kBQ, DP, kThreads>(Qt, q + at, q_stride, sq - t0, d, tid);
    hw::load_tile_sw128<kBQ, DP, kThreads>(Qt + kBQ * DP, dout + at, q_stride, sq - t0, d, tid);
    if (tid < 2 * kBQ) {
      const int i = tid % kBQ;
      const bool valid = t0 + i < sq;
      const int64_t l = (static_cast<int64_t>(b) * hq + h) * sq + t0 + i;
      hw::cp_async4(hw::smem_u32(LDs + 2 * (it % kStages) * kBQ + tid),
                    valid ? (tid < kBQ ? lse : delta) + l : lse, valid);
    }
  };
  hw::load_tile_sw128<kBK, DP, kThreads>(Ks, k + kv_base + k0 * kv_stride, kv_stride, sk - k0, d,
                                         tid);
  hw::load_tile_sw128<kBK, DP, kThreads>(Vs, v + kv_base + k0 * kv_stride, kv_stride, sk - k0, d,
                                         tid);
  for (int t = 0; t < kStages - 1; ++t) {  // K and V land with tile 0
    if (t < n_tiles) load_q(t);
    hw::cp_async_commit();
  }

  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) dk_acc[x] = dv_acc[x] = 0.f;
  const float sl2 = scale * hw::kLog2e;
  const int r_lo = warp * 16 + (lane >> 2);  // this thread's keys: r_lo, r_lo + 8 past k0
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = q_begin + (it % n_qt) * kBQ;
    const bf16* Qt = QDs + 2 * (it % kStages) * kBQ * DP;
    const bf16* dOt = Qt + kBQ * DP;
    const float* ls = LDs + 2 * (it % kStages) * kBQ;
    const float* dls = ls + kBQ;
    hw::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile it has landed; tile it - 1's stage is free
    if (it + kStages - 1 < n_tiles) load_q(it + kStages - 1);
    hw::cp_async_commit();
    if (causal && k0 > t0 + kBQ - 1 + offset) continue;

    float s[32], dp[32];  // S^T = K Q^T and dP^T = V dO^T, [64 keys][64 rows]
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      hw::wgmma_ss_m64n64(s, hw::desc_kmajor(Ks, kBK, kk), hw::desc_kmajor(Qt, kBQ, kk), kk);
    hw::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      hw::wgmma_ss_m64n64(dp, hw::desc_kmajor(Vs, kBK, kk), hw::desc_kmajor(dOt, kBQ, kk), kk);
    hw::wgmma_commit();
    hw::wgmma_wait<1>();  // S^T is done; p^T is computed while dP^T runs
    hw::fence_regs(s);

    // p^T over s, then ds^T over dp; a column is a query row with its own
    // lse and delta.  Only a tile that crosses the diagonal or the last row
    // masks per element.
    const bool edge = (causal && k0 + kBK - 1 > t0 + offset) || t0 + kBQ > sq;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * quad;
      const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float lc = hw::lse_log2(e ? l2.y : l2.x);
        // keys of this column that its row sees: key <= t0 + c + e + offset
        const int lim = t0 + c + e < sq ? (causal ? t0 + c + e + offset + 1 : sk) : -1;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * j + 2 * i + e;
          const float p = hw::exp2_approx(fmaf(s[x], sl2, -lc));
          s[x] = edge && k0 + r_lo + 8 * i >= lim ? 0.f : p;
        }
      }
    }
    hw::wgmma_wait<0>();
    hw::fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(dls + 8 * j + 2 * quad);
#pragma unroll
      for (int x = 4 * j; x < 4 * j + 4; ++x)
        dp[x] = s[x] * (dp[x] - (x & 1 ? d2.y : d2.x)) * scale;
    }
    uint32_t pa[4][4], da[4][4];  // P^T and dS^T in bf16 as A operands
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hw::acc_to_a(s, kk, pa[kk]);
      hw::acc_to_a(dp, kk, da[kk]);
    }
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)  // dV += P^T dO
      hw::wgmma_rs_tb<DP>(dv_acc, pa[kk], hw::desc_mnmajor(dOt, kBQ, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)  // dK += dS^T Q
      hw::wgmma_rs_tb<DP>(dk_acc, da[kk], hw::desc_mnmajor(Qt, kBQ, kk), 1);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(dk_acc);
    hw::fence_regs(dv_acc);
    hw::fence_regs(pa);
    hw::fence_regs(da);
  }
  hw::cp_async_wait<0>();
  hw::store_acc(dk_acc, dk + kv_base, kv_stride, k0 + r_lo, sk, d, quad);
  hw::store_acc(dv_acc, dv + kv_base, kv_stride, k0 + r_lo, sk, d, quad);
}

template <int DP>
int launch_wg(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const void* lse, void* dq, void* dk, void* dv, void* delta, int b, int sq,
              int sk, int hq, int hkv, int d, float scale, int causal, bool dq_pass,
              cudaStream_t s) {
  constexpr size_t kTile = kBR * DP * sizeof(bf16);  // bytes of one tile
  if (dq_pass) {
    // Q, dO and the stages of K, V; 1024 bytes of alignment slack
    const size_t smem = (2 + 2 * kStages) * kTile + 1024;
    auto kernel = bwd_dq_wg<DP>;
    cudaError_t e = set_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<dim3((sq + kBR - 1) / kBR, hq, b), kWgThreads, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<bf16*>(dq), static_cast<float*>(delta),
        sq, sk, hq, hkv, d, scale, causal);
  } else {
    // K, V, the stages of Q, dO and their lse, delta rows
    const size_t smem = (2 + 2 * kStages) * kTile + 2 * kStages * kBR * sizeof(float) + 1024;
    auto kernel = bwd_dkv_wg<DP>;
    cudaError_t e = set_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<dim3((sk + kBR - 1) / kBR, hkv, b), kWgThreads, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        sq, sk, hq, hkv, d, scale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int BK>
int launch_tc(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const void* lse, void* dq, void* dk, void* dv, void* delta, int b, int sq,
              int sk, int hq, int hkv, int d, float scale, int causal, bool dq_pass,
              cudaStream_t s) {
  const size_t smem = tc_layout(d, BK, !dq_pass).bytes;
  if (dq_pass) {
    auto kernel = bwd_dq_tc<BK>;
    cudaError_t e = set_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<dim3((sq + kTcBQ - 1) / kTcBQ, hq, b), kTcThreads, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<bf16*>(dq), static_cast<float*>(delta),
        sq, sk, hq, hkv, d, scale, causal);
  } else {
    auto kernel = bwd_dkv_tc<BK>;
    cudaError_t e = set_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<dim3((sk + BK - 1) / BK, hkv, b), kTcThreads, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        sq, sk, hq, hkv, d, scale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, const void* o, const void* dout,
             const void* lse, void* dq, void* dk, void* dv, void* delta, int b, int sq,
             int sk, int hq, int hkv, int d, float scale, int causal, int dtype,
             bool dq_pass, void* stream) {
  if (b == 0 || sq == 0 || sk == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != ptt::kBF16)
    return dispatch_f32(q, k, v, o, dout, lse, dq, dk, dv, delta, b, sq, sk, hq, hkv, d,
                        scale, causal, dq_pass, s);
  if (d <= 64)
    return launch_wg<64>(q, k, v, o, dout, lse, dq, dk, dv, delta, b, sq, sk, hq, hkv, d,
                         scale, causal, dq_pass, s);
  if (d <= 128)
    return launch_wg<128>(q, k, v, o, dout, lse, dq, dk, dv, delta, b, sq, sk, hq, hkv, d,
                          scale, causal, dq_pass, s);
  return launch_tc<32>(q, k, v, o, dout, lse, dq, dk, dv, delta, b, sq, sk, hq, hkv, d,
                       scale, causal, dq_pass, s);
}

}  // namespace

// q, out, dout, dq [b, sq, hq, d]; k, v [b, sk, hkv, d]; one dtype (0 = f32,
// 1 = bf16, then 16-byte aligned); d % 8 == 0, d <= 256; lse and delta
// [b, hq, sq] f32.  Writes dq and delta (rowsum(dout * out)).
extern "C" int ptt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout,
                                          const void* lse, void* dq, void* delta, int b,
                                          int sq, int sk, int hq, int hkv, int d,
                                          float scale, int causal, int dtype,
                                          void* stream) {
  return dispatch(q, k, v, out, dout, lse, dq, nullptr, nullptr, delta, b, sq, sk, hq, hkv,
                  d, scale, causal, dtype, true, stream);
}

// As above, with delta from ptt_flash_attention_bwd_dq; writes dk, dv
// [b, sk, hkv, d], summed over each kv head's group of q heads.
extern "C" int ptt_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dk, void* dv, int b,
                                           int sq, int sk, int hq, int hkv, int d,
                                           float scale, int causal, int dtype,
                                           void* stream) {
  return dispatch(q, k, v, nullptr, dout, lse, nullptr, dk, dv, const_cast<void*>(delta), b,
                  sq, sk, hq, hkv, d, scale, causal, dtype, false, stream);
}
