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
// bf16 with 128 < d <= 256 (fwd_wide, the head dim padded with zero
// columns to DP = 256) runs on wgmma too, but one warpgroup's O is an
// m64n256 accumulator, 128 registers a thread, which leaves no room for Q
// as a register operand (64 more).  So:
//   * A block is two warpgroups, 64 query rows each (128 rows), sharing
//     each streamed K/V tile of 64 keys.  Q stays in shared memory (64 KB
//     in the SW128 layout, 4 swizzle atoms a row), read through its
//     descriptor: S = Q K^T is wgmma with both operands in shared memory
//     (m64n64k16, 16 k steps).
//   * The softmax runs in S's accumulator as in fwd_wg; P, rounded to bf16
//     in registers, is the A operand of O += P V, one m64n256k16 with V
//     through the transpose bit for every 16 keys.
//   * K and V stream through two cp.async stages (2 x 64 KB): 193 KB of
//     shared memory, one block an SM; ptxas: 213 registers, no spill.
//     Causal tiles launch heaviest first; a warpgroup whose rows see none
//     of a tile skips it.
// Bound at [2, 2048, 16, 256] causal: 0.0695 ms (operations); SDPA 0.150-
// 0.156.  Measured (chip_smoke.py's flash_d256_ab: copies of this file that
// differ in one choice, timed in turns in one call, medians of 4-6, bf16 on
// an H100 80GB HBM3 at 700 W; PERF.md section 6): 0.2504-0.2544 ms, against
// 1.8710 for the WMMA kernel it replaces.  Rejected (ms at that shape):
// one warpgroup a block, 64-key tiles, 0.318-0.323 (three stages 0.350-
// 0.359, with spills); one warpgroup with 32-key tiles and two stages, two
// blocks an SM, 0.304-0.305 (three stages 0.390-0.395); two warpgroups with
// 32-key tiles 0.316-0.317 (three stages 0.307-0.312); and, built and
// removed again: 80-key tiles (m64n80, 225 KB) 0.2522 against 0.2544 in
// the same call; warpgroup 1 skewed half a tile behind, its P V of tile
// it - 1 beside warpgroup 0's S of tile it, 0.2729 against 0.2532; tile
// it's P V issued with tile it + 1's S and run under its softmax (a third
// V stage, 225 KB), 0.2737 against 0.2504.  What bounds it: removing the
// softmax and the rescale of O leaves 0.202-0.206 ms, loading each K/V
// tile only once 0.209-0.212, removing S = Q K^T 0.259 and P V 0.271-0.275
// (slower): the products are not on the critical path; the CUDA-core work
// of each tile and the stream of K/V tiles from L2 (570 MB at about 2.3
// TB/s) are.
//
// f32 inputs (fwd_f32) stay in f32 on the FP32 pipes: single-pass TF32 keeps
// about three decimal digits, short of the f32 attention tolerance.  Two
// rates bound them on the H100: the FFMAs' (67 TFLOP/s, one warp
// instruction a clock on each of an SM's four schedulers, so every other
// instruction takes an FFMA's slot) and shared memory's path to the
// registers (128 bytes a clock an SM, so a warp's 16-byte load takes four
// clocks whether its lanes share an address or not).  The design blocks
// registers as a SIMT GEMM does, so that each lane does 4 FFMAs (RT 8; 2.7
// at RT 4) for every float it loads from shared memory:
//   * Q, K and V tiles lie row-major in shared memory, rows padded by 16
//     bytes (DP + 4 floats), filled by cp.async with zero fill (ragged rows,
//     the DP - d columns); no transpose on the way in.
//   * A warp owns 4 RT query rows of the block's tile; lane 8 rg + kg owns
//     rows rg + 4 i (i < RT) and keys kg + 8 j (j < 8) of each 64-key tile,
//     an RT x 8 block of S in registers.  Each step of 4 columns reads the
//     rows' q (RT float4 loads) and the keys' k (8 float4 loads) and does
//     32 RT FFMAs: at RT = 8, sixteen loads feed 256 FFMAs.  The padding
//     puts the rows (keys) a load touches on distinct banks, and the lanes
//     that share a row (a key) read one address.
//   * The 8 lanes of a row are one quarter of a warp: a row's max takes
//     three xor shuffles a tile, and its sum is kept per lane and summed
//     once, at the end.  exp2 with scale * log2(e) folded in (ex2.approx);
//     only a tile that crosses the pad, the diagonal or the last key masks
//     per element.
//   * P goes to shared memory as [row][key] (stride 72: the 32 lanes' stores
//     hit 32 banks), then each lane accumulates O for its RT rows and
//     columns 4 kg + 32 c (c < DP / 32) from float4 loads of P (4 keys a
//     row) and V: at DP 64 and RT 8, sixteen loads for 256 FFMAs again.
//   * K and V have one buffer each and take turns: V of tile it lands while
//     S = Q K^T of tile it is computed, K of tile it + 1 while O += P V of
//     tile it is; two block barriers a tile.
//   * Causal query tiles launch heaviest first.  Nothing is summed across
//     blocks and every sum runs in a fixed order: two launches give the same
//     bits.  The S loop runs to d, not DP; only P V spends work on the zero
//     columns of a head dim that is not 64, 128 or 256.
// Instances (DP: warps, RT, query rows a block, blocks an SM): 64: 4, 8,
// 128, two (104 KB, 251 registers); 128: 8, 4, 128, one (168 KB, 242
// registers); 256: 8, 2, 64, one (213 KB).
// What bounds it, measured (chip_smoke.py's flash_f32_ab: copies of this
// file that differ in one choice, timed in turns in one call, medians of
// 4, f32 on an H100 80GB HBM3 at 700 W; PERF.md section 6): 0.340 ms at
// ERNIE 3.0 base's [16, 512, 12, 64], 0.57 of the FFMA rate.  Removing the
// S loop, the P V loop or both leaves 0.197, 0.230 and 0.098 ms: S runs at
// about 0.67 of the FFMA rate and P V at 0.87.  Skipping the K/V loads
// after the first tile, the exponentials, the second barrier or the P
// stores moves it by at most 3%, and pointing all of a warp's K or Q loads
// at one address by at most 1.3%.  So bank conflicts and the loads'
// latency do not bound it; the shared loads' data path does: a warp's
// 16-byte load delivers 512 bytes over the SM's 128 bytes a clock whether
// its lanes share addresses or not, and at RT 8 the 16 loads a step of 4
// columns take as many of those cycles as its 256 FFMAs take issue
// cycles.  A larger register tile would tip the balance to the FFMAs but
// does not fit 255 registers beside O; TF32 products split in three on the
// tensor cores are the way past.  Rejected: at DP 64, RT 4 over 64 rows,
// three blocks an SM (0.360 ms), eight warps a block (RT 4: 0.365, with
// 112 bytes of spills; RT 8: 0.336, within the spread of the two blocks of
// four warps built, 0.336-0.343); at DP 128, S summed one column at a time
// over all 32 accumulators (4.30 ms against 4.20 at [4, 2048, 32, 128]
// causal).
#include "common.cuh"
#include "flash_common.cuh"

namespace {

namespace hw = ptt::sm90;

// ---------------------------------------------------------------------------
// f32: FFMA tiles
// ---------------------------------------------------------------------------
constexpr int kF32BK = 64;           // keys a K/V tile
constexpr int kF32LDP = kF32BK + 8;  // row stride of P, in floats

template <int DP, int NW, int RT>
struct F32Tile {
  static constexpr int kThreads = 32 * NW;
  static constexpr int kRowsW = 4 * RT;     // query rows a warp
  static constexpr int kBQ = NW * kRowsW;   // query rows a block
  static constexpr int kLD = DP + 4;        // row stride of Q, K, V, in floats
  static constexpr int kCols = DP / 8;      // O columns a lane
  static constexpr size_t kSmem =
      sizeof(float) * ((static_cast<size_t>(kBQ) + 2 * kF32BK) * kLD + kBQ * kF32LDP);
};

__device__ __forceinline__ float lane4(const float4& v, int e) {  // v.x, .y, .z, .w
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// B3 in f32: one block per (tile of kBQ query rows, q head, batch row)
template <int DP, int NW, int RT, int MIN_BLOCKS>
__global__ void __launch_bounds__(32 * NW, MIN_BLOCKS)
fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
        const int* __restrict__ pad_lens, float* __restrict__ out, float* __restrict__ lse,
        int sq, int sk, int hq, int hkv, int d, float scale, int causal) {
  using L = F32Tile<DP, NW, RT>;
  constexpr int kBQ = L::kBQ, kBK = kF32BK, kLD = L::kLD, kThreads = L::kThreads;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                // [kBQ][kLD]
  float* Ks = Qs + kBQ * kLD;     // [kBK][kLD]
  float* Vs = Ks + kBK * kLD;     // [kBK][kLD]
  float* Ps = Vs + kBK * kLD;     // [kBQ][kF32LDP]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane >> 3, kg = lane & 7;
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
  if (n_tiles > 0) {
    hw::load_f32_tile<kBQ, DP, kThreads>(Qs, q + q_base + q0 * q_stride, q_stride, sq - q0, d,
                                         tid);
    hw::load_f32_tile<kBK, DP, kThreads>(Ks, k + kv_base + k_begin * kv_stride, kv_stride,
                                         sk - k_begin, d, tid);
  }
  hw::cp_async_commit();

  const int r0 = warp * L::kRowsW + rg;  // this lane's rows of the tile: r0 + 4 i
  float o[RT][L::kCols];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) o[i][c] = 0.f;
  // m: the running max of the scores times scale * log2(e); l: this lane's
  // share of the running sum
  float m[RT], l[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) m[i] = -INFINITY, l[i] = 0.f;
  const float sl2 = scale * hw::kLog2e;
  const float* Qr = Qs + r0 * kLD;
  const float* Kr = Ks + kg * kLD;
  float* Pr = Ps + r0 * kF32LDP;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = k_begin + it * kBK;
    cp_async_wait_all();
    __syncthreads();  // K tile it (and Q) landed; every lane is done with V
    {
      const int64_t at = kv_base + static_cast<int64_t>(t0) * kv_stride;
      hw::load_f32_tile<kBK, DP, kThreads>(Vs, v + at, kv_stride, sk - t0, d, tid);
    }
    hw::cp_async_commit();

    float s[RT][8];  // S = Q K^T: rows r0 + 4 i, keys t0 + kg + 8 j
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < d; c += 4) {
      float4 qv[RT], kv[8];
#pragma unroll
      for (int i = 0; i < RT; ++i) qv[i] = *reinterpret_cast<const float4*>(Qr + 4 * i * kLD + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = *reinterpret_cast<const float4*>(Kr + 8 * j * kLD + c);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j] = fmaf(lane4(qv[i], e), lane4(kv[j], e), s[i][j]);
    }

    // only a tile that crosses the pad, the diagonal or the last key masks
    // per element
    if (t0 < pad || t0 + kBK > sk || (causal && t0 + kBK - 1 > q0 + offset)) {
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int hi = min(sk, causal ? q0 + r0 + 4 * i + offset + 1 : sk);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = t0 + kg + 8 * j;
          if (col < pad || col >= hi) s[i][j] = -INFINITY;
        }
      }
    }
    // online softmax; a row with every key masked so far keeps m = -inf, and
    // a finite reference point turns p and alpha into exact zeros
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float mt = s[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mt = fmaxf(mt, s[i][j]);
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
      const float m_new = fmaxf(m[i], mt * sl2);
      const float m_ok = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = hw::exp2_approx(m[i] - m_ok);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = hw::exp2_approx(fmaf(s[i][j], sl2, -m_ok));
        ps += p;
        Pr[4 * i * kF32LDP + kg + 8 * j] = p;
      }
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < L::kCols; ++c) o[i][c] *= alpha;
    }

    cp_async_wait_all();
    __syncthreads();  // V tile it landed and P is written; every lane is done with K
    if (it + 1 < n_tiles) {
      const int64_t at = kv_base + static_cast<int64_t>(t0 + kBK) * kv_stride;
      hw::load_f32_tile<kBK, DP, kThreads>(Ks, k + at, kv_stride, sk - t0 - kBK, d, tid);
    }
    hw::cp_async_commit();

    // O += P V: rows r0 + 4 i, columns 4 kg + 32 c + (0..3)
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Pr + 4 * i * kF32LDP + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* Vr = Vs + (kk + e) * kLD + 4 * kg;
#pragma unroll
        for (int c = 0; c < DP / 32; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(Vr + 32 * c);
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            const float p = lane4(pv[i], e);
            o[i][4 * c + 0] = fmaf(p, vv.x, o[i][4 * c + 0]);
            o[i][4 * c + 1] = fmaf(p, vv.y, o[i][4 * c + 1]);
            o[i][4 * c + 2] = fmaf(p, vv.z, o[i][4 * c + 2]);
            o[i][4 * c + 3] = fmaf(p, vv.w, o[i][4 * c + 3]);
          }
        }
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    // the row's sum over its 8 lanes (the same bits on each of them)
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt += __shfl_xor_sync(0xffffffffu, lt, 4);
    const float ld = lt == 0.f ? 1.f : lt;  // rows with no valid key: zeros
    const int row = q0 + r0 + 4 * i;
    if (row >= sq) continue;
    float* op = out + q_base + row * q_stride + 4 * kg;
#pragma unroll
    for (int c = 0; c < DP / 32; ++c)
      if (4 * kg + 32 * c < d)
        *reinterpret_cast<float4*>(op + 32 * c) =
            make_float4(o[i][4 * c] / ld, o[i][4 * c + 1] / ld, o[i][4 * c + 2] / ld,
                        o[i][4 * c + 3] / ld);
    if (kg == 0)  // natural log: lse = (m + log2 l) ln 2
      lse[(static_cast<int64_t>(b) * hq + h) * sq + row] = (m[i] + log2f(ld)) * hw::kLn2;
  }
}

template <int DP, int NW, int RT, int MIN_BLOCKS>
int launch_f32(const void* q, const void* k, const void* v, const void* pad_lens, void* out,
               void* lse, int b, int sq, int sk, int hq, int hkv, int d, float scale,
               int causal, cudaStream_t stream) {
  using L = F32Tile<DP, NW, RT>;
  auto kernel = fwd_f32<DP, NW, RT, MIN_BLOCKS>;
  const cudaError_t e = hw::set_smem(kernel, L::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3((sq + L::kBQ - 1) / L::kBQ, hq, b), L::kThreads, L::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(pad_lens), static_cast<float*>(out), static_cast<float*>(lse),
      sq, sk, hq, hkv, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(const void* q, const void* k, const void* v, const void* pad_lens,
                 void* out, void* lse, int b, int sq, int sk, int hq, int hkv, int d,
                 float scale, int causal, cudaStream_t s) {
  if (d <= 64)
    return launch_f32<64, 4, 8, 2>(q, k, v, pad_lens, out, lse, b, sq, sk, hq, hkv, d, scale, causal, s);
  if (d <= 128)
    return launch_f32<128, 8, 4, 1>(q, k, v, pad_lens, out, lse, b, sq, sk, hq, hkv, d, scale, causal, s);
  return launch_f32<256, 8, 2, 1>(q, k, v, pad_lens, out, lse, b, sq, sk, hq, hkv, d, scale, causal, s);
}

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16, head_dim <= 128: wgmma, S, P and O in registers, cp.async tile ring
// ---------------------------------------------------------------------------

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
template <int R>
__device__ __forceinline__ void softmax_tile(float (&s)[R], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int t0, int row0, int quad,
                                             bool edge, int pad, int sk, int causal, int offset,
                                             float sl2) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (edge) {  // keys [lo, hi) of the tile are live for this row
      const int lo = pad - t0;
      const int hi = min(sk, causal ? row0 + 8 * i + offset + 1 : sk) - t0;
#pragma unroll
      for (int j = 0; j < R / 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * quad + e;
          if (c < lo || c >= hi) s[4 * j + 2 * i + e] = -INFINITY;
        }
    }
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < R / 4; ++j) mt = fmaxf(mt, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m[i], mt * sl2);
    const float m_ok = m_new == -INFINITY ? 0.f : m_new;
    alpha[i] = hw::exp2_approx(m[i] - m_ok);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < R / 4; ++j)
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


// ---------------------------------------------------------------------------
// bf16, 128 < head_dim <= 256: wgmma, Q in shared memory, O in registers
// ---------------------------------------------------------------------------
// Two warpgroups a block, 64 query rows each, sharing every streamed tile of
// kBR keys; kStages stages of K and V
template <int DP>
struct WideFwd {
  static constexpr int kThreads = 256;
  static constexpr int kBQ = 128;
  // Q, the stages of K and V; 1024 bytes of alignment slack
  static constexpr size_t kSmem =
      (static_cast<size_t>(kBQ) + 2 * kStages * kBR) * DP * sizeof(bf16) + 1024;
};

// B3 at 128 < d <= 256: one block per (tile of 128 query rows, q head, batch
// row).  Each warpgroup keeps its 64 rows of Q in shared memory (read
// through its descriptor), S and P and its DP / 2 registers of O in
// registers; K and V stream through a ring of kStages stages.
template <int DP>
__global__ void __launch_bounds__(256, 1)
fwd_wide(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
         const int* __restrict__ pad_lens, bf16* __restrict__ out, float* __restrict__ lse,
         int sq, int sk, int hq, int hkv, int d, float scale, int causal) {
  using L = WideFwd<DP>;
  constexpr int kBQ = L::kBQ, kThreads = L::kThreads, BK = kBR;
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = hw::smem_base(smem_raw);  // two tiles [64][DP] SW128, one a warpgroup
  bf16* Ks = Qs + kBQ * DP;            // stage st of K at Ks + st BK DP
  bf16* Vs = Ks + kStages * BK * DP;   // stage st of V at Vs + st BK DP

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
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
  // block's diagonal is loaded
  const int last_row = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(sk, last_row + offset + 1) : sk;
  const int k_begin = (pad / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  auto load_kv = [&](int it) {
    const int t0 = k_begin + it * BK;
    const int64_t at = kv_base + static_cast<int64_t>(t0) * kv_stride;
    hw::load_tile_sw128<BK, DP, kThreads>(Ks + (it % kStages) * BK * DP, k + at, kv_stride,
                                          sk - t0, d, tid);
    hw::load_tile_sw128<BK, DP, kThreads>(Vs + (it % kStages) * BK * DP, v + at, kv_stride,
                                          sk - t0, d, tid);
  };
#pragma unroll
  for (int w = 0; w < 2; ++w)  // rows >= sq and columns >= d are zero
    hw::load_tile_sw128<64, DP, kThreads>(Qs + w * 64 * DP,
                                          q + q_base + (q0 + 64 * w) * q_stride, q_stride,
                                          sq - q0 - 64 * w, d, tid);
  for (int t = 0; t < kStages - 1; ++t) {  // Q lands with tile 0
    if (t < n_tiles) load_kv(t);
    hw::cp_async_commit();
  }

  const bf16* Qw = Qs + wg * 64 * DP;
  const int qw0 = q0 + 64 * wg;                  // this warpgroup's first row
  const int row0 = qw0 + warp * 16 + (lane >> 2);  // this thread's rows: row0, row0 + 8
  float o[DP / 2];
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) o[x] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  const float sl2 = scale * hw::kLog2e;
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = k_begin + it * BK;
    const bf16* Kt = Ks + (it % kStages) * BK * DP;
    const bf16* Vt = Vs + (it % kStages) * BK * DP;
    hw::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile it has landed; tile it - 1's stage is free
    if (it + kStages - 1 < n_tiles) load_kv(it + kStages - 1);
    hw::cp_async_commit();
    // a warpgroup past the last row, or whose rows see none of the tile
    if (qw0 >= sq || (causal && t0 > qw0 + 63 + offset)) continue;

    float s[BK / 2];  // S = Q K^T, [64 rows][BK keys]
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      hw::wgmma_ss_m64n64(s, hw::desc_kmajor(Qw, 64, kk), hw::desc_kmajor(Kt, BK, kk), kk);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(s);

    // only a tile that crosses the pad, the diagonal or the last key masks
    // per element
    const bool edge = t0 < pad || t0 + BK > sk || (causal && t0 + BK - 1 > qw0 + offset);
    softmax_tile(s, m, l, alpha, t0, row0, quad, edge, pad, sk, causal, offset, sl2);
#pragma unroll
    for (int x = 0; x < DP / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
    uint32_t a[BK / 16][4];  // P in bf16 as the A operand
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) hw::acc_to_a(s, kk, a[kk]);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)  // O += P V
      hw::wgmma_rs_tb<DP>(o, a[kk], hw::desc_mnmajor(Vt, BK, kk), 1);
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
int launch_wide(const void* q, const void* k, const void* v, const void* pad_lens, void* out,
                void* lse, int b, int sq, int sk, int hq, int hkv, int d, float scale,
                int causal, cudaStream_t stream) {
  using L = WideFwd<DP>;
  auto kernel = fwd_wide<DP>;
  const cudaError_t e = hw::set_smem(kernel, L::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3((sq + L::kBQ - 1) / L::kBQ, hq, b), L::kThreads, L::kSmem, stream>>>(
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
  return launch_wide<256>(q, k, v, pad_lens, out, lse, b, sq, sk, hq, hkv, d, scale, causal,
                          s);
}
