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
// causal 0.2086 and 0.2781 ms at 989 TFLOP/s in bf16, together 0.487 ms.
// The whole function needs 5 products (SDPA's fused backward: 0.906 ms on
// this card), the yardstick, not the bound of this split.  In f32 the same
// 206.3 + 275.0 GFLOP take 3.08 + 4.10 ms at the FP32 pipes' 67 TFLOP/s;
// as three TF32 products each on the tensor cores (494.7 TFLOP/s) the floor
// is 1.25 + 1.67 ms.
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
// bf16 with 128 < d <= 256, the head dim padded with zero columns to DP =
// 256.  B3b (_bwd_dq_kernel, flash_attention.py:219-260, pallas_call at
// :315) is bwd_dq_wg<256>, the d <= 128 kernel's design at that width: one
// warpgroup over 64 query rows, Q and dO resident (64 KB), 64-key K and V
// tiles through two cp.async stages (128 KB; the 128 threads load a tile's
// 256 columns in two halves), S and dP as SS m64n64 wgmma, p and ds in
// their accumulators, dS rounded to bf16 in registers as the A operand of
// dQ += dS K, an m64n256 product whose 128 accumulator registers hold the
// whole dQ tile.  193 KB of shared memory, one block an SM; ptxas: 227
// registers, no spill.  Bound at [2, 2048, 16, 256] causal: 0.1043 ms
// (operations).  Measured (chip_smoke.py's flash_d256_ab, copies of this
// file that differ in one choice, timed in turns in one call, medians of 4,
// bf16 on an H100 80GB HBM3 at 700 W; PERF.md section 6): 0.3077-0.3107
// ms, against 2.29 for the WMMA kernel it replaces and 0.65-0.77 for
// SDPA's whole backward.  Rejected in the same calls: two warpgroups over
// the 64 rows, warpgroup 0 handing p in f32 to warpgroup 1, which wrote
// dS as an SW128 tile that each multiplied by half of K's columns (SS
// m64n128, 217 KB), 0.3525-0.3526; two warpgroups each owning 64 rows of
// a 128-row tile and sharing 32-key K/V tiles (m64n32 S and dP),
// 0.3566-0.3586; this kernel with each dQ product left in flight under
// the next tile's S and dP (255 registers), 0.3094, a tie.  What bounds
// it, from copies with one phase removed (0.3077 as built): without dQ's
// product 0.2175, without the K/V stream 0.2370, without the p and ds
// arithmetic 0.2444, without S 0.2714, without dP 0.2770; the savings add
// up to the whole, so one warpgroup runs its phases one after another.
//
// B3c is bwd_dkv_wide, on wgmma as bwd_dkv_wg is; at DP 256 an m64n256
// accumulator is 128 registers a thread, so dK and dV cannot share a
// warpgroup.  A block of two warpgroups owns 64 keys of a kv head: K and
// V stay in shared memory (64 KB), the group's Q and dO tiles of 64 rows
// with their lse and delta stream through two cp.async stages (2 x 64 KB).
//   * Warpgroup 0 computes S^T = K Q^T and P^T from the f32 exp2 of
//     s scale - lse in its accumulator, writes P^T in f32 to a 16 KB
//     exchange tile (thread t's 32 slots are thread t's in warpgroup 1 too,
//     so slot x of all 128 threads is one conflict-free row) and arrives at
//     a named barrier (bar.arrive 1, 256); then dV += P^T dO, dO through the
//     transpose bit (m64n256k16).
//   * Warpgroup 1 computes dP^T = V dO^T meanwhile, waits at that barrier,
//     forms dS^T = P^T (dP^T - delta) scale from the f32 p, rounds it to
//     bf16 in registers and accumulates dK += dS^T Q.
//   * Four products a tile, as at d <= 128, two a warpgroup; the block
//     barrier at each tile frees both the stage and the exchange tile.  The
//     group's q heads are summed in one block in a fixed order: two
//     launches give the same bits.
// 210 KB of shared memory, one block an SM; ptxas: 255 registers, no
// spill.  Bound at [2, 2048, 16, 256] causal: 0.1390 ms (operations).
// Measured (chip_smoke.py's flash_d256_ab, copies of this file that differ
// in one choice, timed in turns in one call, medians of 4-6, bf16 on an
// H100 80GB HBM3 at 700 W; PERF.md section 6): 0.4707-0.4719 ms, against
// 3.6054 for the WMMA kernel it replaces.  Rejected: warpgroup 1 computing
// S^T and P^T itself (five products, no exchange tile) 0.5595.  Without the dK and dV products it takes 0.398 ms, without the
// p and ds arithmetic 0.4185: neither alone bounds it.  Not built: the
// head dim split over the two warpgroups (each holding half of dK and dV,
// six products a tile).
//
// f32 (bwd_dq_tf32, bwd_dkv_tf32) runs on the tensor cores too, each f32
// product as three TF32 products (mma_tf32.cuh: hi and lo parts of both
// operands, lo_a hi_b + hi_a lo_b + hi_a hi_b into f32 accumulators), which
// keeps about f32's error where one TF32 product keeps three digits.  The
// FP32 pipes' 67 TFLOP/s cap any SIMT design at 7.2 ms for the pair at the
// training shape (the SIMT pair that this replaces took 47.96 ms; SDPA's
// f32 backward, one CUTLASS kernel fmha_cutlassB_f32_*_sm80, 10.47), while
// three TF32 products run at 164.9 TFLOP/s of f32 work.  Hopper's wgmma
// takes TF32 only K-major from shared memory (no transpose for 32-bit
// types), and dQ = dS K, dV = P^T dO and dK = dS^T Q read their B operand
// along the other axis, so the products are warp-level mma.sync m16n8k8,
// whose fragments a lane loads itself:
//   * The layout is FA2's on m16n8k8: a warp owns 16 rows of the block's
//     resident operand (Q and dO in B3b, K and V in B3c, both in shared
//     memory: at d 128 a warp's 16 rows of one operand are 64 registers a
//     lane, split in two 128) and multiplies them against the streamed
//     tiles (K, V in B3b; Q, dO with their lse and delta in B3c), which
//     come through two cp.async stages with zero fill for ragged rows and
//     the DP - d columns.  Rows are DP + 4 floats apart.
//   * S = Q K^T and dP = dO V^T sum over the head dim in any order, so the
//     k slots follow the loads (mma_xyt): a lane's A and B values of four
//     k steps are 8 consecutive floats of a row, two float4 loads, and the
//     8 lanes of a quarter warp hit 32 distinct banks.
//   * P and dS are computed in the accumulators (exp2 of s * scale * log2e
//     - lse * log2e by ex2.approx) and are already the A operand of the
//     next product: the k order of dQ += dS K (dV += P^T dO, dK += dS^T Q)
//     is permuted so that slot t is the accumulator's column 2 t and slot
//     t + 4 its column 2 t + 1, and B reads rows 2 t and 2 t + 1 (mma_ay).
//     The output columns are permuted as well, so that those B reads and
//     the final stores are float4s.  No shuffle, no shared-memory round
//     trip for P or dS.
//   * The tensor cores add into their accumulator without rounding to
//     nearest: with dK and dV summed in one accumulator over all their rows,
//     3146 elements of dK and 4247 of dV at Llama-2-70B's GQA (16384 rows a
//     key) fell outside the f32 tolerance of the plain backward (largest
//     errors 8.8e-4 and 1.6e-3).  So each streamed tile's products sum into
//     a zeroed accumulator that the FP32 pipe then adds, rounded to nearest
//     (mma_ay): 2.1e-5 and 2.6e-5, at the same speed.
//   * Operands are split at each fragment load (3 instructions), from one
//     f32 copy in shared memory: hi and lo planes of every tile would not
//     fit two stages beside the resident operands at d 128, and dropping
//     the splits altogether saves a tenth of the time (below).
//   * Tiles wholly above the diagonal are not loaded, a warp whose rows see
//     none of a tile skips it, and only tiles that cross the diagonal or the
//     ragged edge mask per element.  Every sum runs in a fixed order in one
//     block: two launches give the same bits.
// Instances (DP: warps, streamed rows a tile, shared memory, blocks an SM):
// B3b 64: 4, 64, 102 KB, two; 128: 8, 32, 198 KB, one; 256: 4, 16, 195 KB.
// B3c 64: 4, 32, 68.5 KB, two (registers); 128: 8, 32, 198.5 KB, one; 256:
// 4, 16, 195 KB, dK and dV in two passes of 128 columns.  ptxas: no spill
// at DP 64 and 128 (200-247 registers); 64 bytes at B3c's DP 256.
// What bounds it, measured (chip_smoke.py's flash_bwd_tf32_ab: copies of
// this file that differ in one choice, timed in turns in one call, medians
// of 4, f32 on an H100 80GB HBM3 at 700 W; PERF.md section 6): at
// [4, 2048, 32, 128] causal B3b 3.89 ms and B3c 5.04, 3.1x and 3.0x their
// 3xTF32 floor (SDPA's whole f32 backward 10.53).  One TF32 product instead
// of three (no lo parts) leaves 2.08 and 2.57 ms, three products of unsplit
// operands 3.36 and 4.62: the two extra products take about a third of the
// time and the splits a tenth, while even one product a product runs the
// tensor cores at a fifth of their TF32 rate, so the fragment loads,
// exponentials and latencies of mma.sync around them bound it, not the
// tensor cores.  Rejected in the same call (B3b, B3c ms at that shape
// unless marked): four warps at DP 128 (4.93; 6.61 with 40 bytes of
// spills); 16-key tiles and two blocks an SM for B3b (4.46); 16-row tiles
// for B3c (5.88); lo rounded to nearest before the product (4.36, 5.66);
// hi rounded by cvt.rna.tf32.f32 instead of two integer instructions
// (4.81, 6.21); the head-dim loop of S and dP not unrolled (4.01, 5.15); at
// ERNIE 3.0 base's [16, 512, 12, 64], 32-key tiles for B3b (0.377 against
// 0.352 ms) and eight warps for B3c (0.496 against 0.482).
#include "common.cuh"
#include "flash_common.cuh"
#include "mma_tf32.cuh"

namespace {

namespace hw = ptt::sm90;
using ptt::sm90::set_smem;  // the largest carveout: two ~100 KB blocks an SM

// ---------------------------------------------------------------------------
// f32: 3xTF32 products on the tensor cores (mma.sync m16n8k8, mma_tf32.cuh)
// ---------------------------------------------------------------------------
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[j] += X Y_j^T: X is a warp's 16 rows at x (this lane reads rows g and
// g + 8), Y_j the 8 rows at y + 8 j rows (this lane reads row 8 j + g), both
// row-major with row stride LD, summed over the head dim's 32-column groups
// below d.  The sum over the head dim runs in any order, so the k slots are
// assigned to suit the loads: in each group, lane t's slots t and t + 4 of
// four k steps are the 8 floats at column 8 t, two float4 loads a row (slot
// t of a step is an even column, slot t + 4 the odd one after it).  With LD
// = 4 mod 32 the 8 lanes of each quarter warp hit 32 distinct banks.
template <int NT, int LD>
__device__ __forceinline__ void mma_xyt(float (&acc)[NT][4], const float* x, const float* y,
                                        int d, int g, int t) {
  const float* xr = x + g * LD + 8 * t;
  const float* yr = y + g * LD + 8 * t;
#pragma unroll
  for (int c = 0; c < LD - 4; c += 32) {  // LD - 4 = DP
    if (c >= d) break;
#pragma unroll
    for (int h = 0; h < 8; h += 4) {
      const float4 xa = lds4(xr + c + h), xb = lds4(xr + 8 * LD + c + h);
      uint32_t ah[2][4], al[2][4];  // two k steps: columns (+0, +1) and (+2, +3)
      hw::split_tf32(xa.x, ah[0][0], al[0][0]);
      hw::split_tf32(xb.x, ah[0][1], al[0][1]);
      hw::split_tf32(xa.y, ah[0][2], al[0][2]);
      hw::split_tf32(xb.y, ah[0][3], al[0][3]);
      hw::split_tf32(xa.z, ah[1][0], al[1][0]);
      hw::split_tf32(xb.z, ah[1][1], al[1][1]);
      hw::split_tf32(xa.w, ah[1][2], al[1][2]);
      hw::split_tf32(xb.w, ah[1][3], al[1][3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float4 yv = lds4(yr + 8 * j * LD + c + h);
        uint32_t bh[2][2], bl[2][2];
        hw::split_tf32(yv.x, bh[0][0], bl[0][0]);
        hw::split_tf32(yv.y, bh[0][1], bl[0][1]);
        hw::split_tf32(yv.z, bh[1][0], bl[1][0]);
        hw::split_tf32(yv.w, bh[1][1], bl[1][1]);
        hw::mma_3xtf32(acc[j], ah[0], al[0], bh[0], bl[0]);
        hw::mma_3xtf32(acc[j], ah[1], al[1], bh[1], bl[1]);
      }
    }
  }
}

// acc[j] += A Y over NK k steps of 8: A is a warp's [16][8 NK] accumulator
// of mma_xyt (k step s is its n tile s) and Y the 8 NK rows at y (row
// stride LD).  No shuffle brings A into the A layout: k slot t stands for
// the accumulator's column 2 t and slot t + 4 for 2 t + 1, so a lane's
// accumulator registers are its A registers (a0 = c0, a1 = c2, a2 = c1,
// a3 = c3), and B reads rows 2 t and 2 t + 1 of the step.  The output's
// columns are permuted too: column c of n tile j is head-dim column
// 32 (j / 4) + 4 c + j % 4, so that B's column g of the tiles 4 v .. 4 v + 3
// is the float4 at 32 v + 4 g (conflict-free with LD = 4 mod 32), and a
// lane's accumulator columns 2 t and 2 t + 1 are the 8 floats at 32 v + 8 t
// (store_xy).  The tensor cores add into their f32 accumulator without
// rounding to nearest, a bias that grows with the number of additions (dK
// at Llama-2-70B's GQA sums 16384 rows); so the NK steps sum into a zeroed
// accumulator, 3 NK additions, and that is added to acc by the FP32 pipe,
// rounded to nearest.  Column groups at or past d are skipped.
template <int NK, int NJ, int LD>
__device__ __forceinline__ void mma_ay(float (&acc)[NJ][4], const float (&a)[NK][4],
                                       const float* y, int d, int g, int t) {
  const float* y0 = y + 2 * t * LD + 4 * g;
#pragma unroll
  for (int v = 0; v < NJ / 4; ++v) {
    if (32 * v >= d) continue;
    float part[4][4] = {};
#pragma unroll
    for (int s = 0; s < NK; ++s) {
      uint32_t ah[4], al[4];
      hw::split_tf32(a[s][0], ah[0], al[0]);
      hw::split_tf32(a[s][2], ah[1], al[1]);
      hw::split_tf32(a[s][1], ah[2], al[2]);
      hw::split_tf32(a[s][3], ah[3], al[3]);
      const float4 r0 = lds4(y0 + 8 * s * LD + 32 * v), r1 = lds4(y0 + (8 * s + 1) * LD + 32 * v);
      const float b0[4] = {r0.x, r0.y, r0.z, r0.w}, b1[4] = {r1.x, r1.y, r1.z, r1.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t bh[2], bl[2];
        hw::split_tf32(b0[e], bh[0], bl[0]);
        hw::split_tf32(b1[e], bh[1], bl[1]);
        hw::mma_3xtf32(part[e], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[4 * v + e][x] += part[e][x];
  }
}

// rows r and r + 8 of a warp's output accumulator in mma_ay's column order
// to dst + row * stride, columns below d; rows >= rows_valid are not stored
template <int NJ>
__device__ __forceinline__ void store_xy(const float (&acc)[NJ][4], float* dst, int64_t stride,
                                         int r, int rows_valid, int d, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r + 8 * i >= rows_valid) continue;
    float* row = dst + (r + 8 * i) * stride + 8 * t;
#pragma unroll
    for (int v = 0; v < NJ / 4; ++v) {
      if (32 * v + 8 * t >= d) continue;  // d % 8 == 0: all 8 columns or none
      *reinterpret_cast<float4*>(row + 32 * v) =
          make_float4(acc[4 * v][2 * i], acc[4 * v + 1][2 * i], acc[4 * v + 2][2 * i],
                      acc[4 * v + 3][2 * i]);
      *reinterpret_cast<float4*>(row + 32 * v + 4) =
          make_float4(acc[4 * v][2 * i + 1], acc[4 * v + 1][2 * i + 1],
                      acc[4 * v + 2][2 * i + 1], acc[4 * v + 3][2 * i + 1]);
    }
  }
}

// B3b in f32: one block per (tile of 16 NW query rows, q head, batch row),
// 16 rows a warp; Q and dO stay in shared memory, K and V tiles of BK keys
// stream through two cp.async stages
template <int DP, int NW, int BK>
struct Tf32Dq {
  static constexpr int kThreads = 32 * NW;
  static constexpr int kBQ = 16 * NW;
  static constexpr int kLD = DP + 4;  // row stride of every tile, in floats
  static constexpr size_t kSmem = sizeof(float) * (2 * kBQ + 4 * BK) * static_cast<size_t>(kLD);
};

template <int DP, int NW, int BK, int MIN_BLOCKS>
__global__ void __launch_bounds__(32 * NW, MIN_BLOCKS)
bwd_dq_tf32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ o, const float* __restrict__ dout,
            const float* __restrict__ lse, float* __restrict__ dq,
            float* __restrict__ delta_out, int sq, int sk, int hq, int hkv, int d, float scale,
            int causal) {
  using L = Tf32Dq<DP, NW, BK>;
  constexpr int kBQ = L::kBQ, kLD = L::kLD, kThreads = L::kThreads, kNT = BK / 8;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;               // [kBQ][kLD]
  float* dOs = Qs + kBQ * kLD;   // [kBQ][kLD]
  float* KVs = dOs + kBQ * kLD;  // stage st: K at KVs + 2 st BK kLD, V after it

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
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
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;
  auto load_kv = [&](int it) {
    float* Kt = KVs + 2 * (it % 2) * BK * kLD;
    const int64_t at = kv_base + static_cast<int64_t>(it) * BK * kv_stride;
    hw::load_f32_tile<BK, DP, kThreads>(Kt, k + at, kv_stride, sk - it * BK, d, tid);
    hw::load_f32_tile<BK, DP, kThreads>(Kt + BK * kLD, v + at, kv_stride, sk - it * BK, d, tid);
  };
  hw::load_f32_tile<kBQ, DP, kThreads>(Qs, q + q_base + q0 * q_stride, q_stride, sq - q0, d, tid);
  hw::load_f32_tile<kBQ, DP, kThreads>(dOs, dout + q_base + q0 * q_stride, q_stride, sq - q0, d,
                                   tid);
  if (n_tiles > 0) load_kv(0);
  hw::cp_async_commit();

  // this lane's rows: r_lo and r_lo + 8 of the tile.  delta = rowsum(dO O)
  // from device memory while the tiles land, the four lanes of a row taking
  // every fourth float4
  const int r_lo = 16 * warp + g;
  float delta_r[2], lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r_lo + 8 * i;
    float acc = 0.f;
    if (row < sq) {
      const float* orow = o + q_base + row * q_stride;
      const float* drow = dout + q_base + row * q_stride;
      for (int c = 4 * t; c < d; c += 16) {
        const float4 ov = *reinterpret_cast<const float4*>(orow + c);
        const float4 dv = *reinterpret_cast<const float4*>(drow + c);
        acc = fmaf(dv.x, ov.x, acc);
        acc = fmaf(dv.y, ov.y, acc);
        acc = fmaf(dv.z, ov.z, acc);
        acc = fmaf(dv.w, ov.w, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    delta_r[i] = acc;
    const int64_t lrow = (static_cast<int64_t>(b) * hq + h) * sq + row;
    lse2[i] = row < sq ? hw::lse_log2(lse[lrow]) : INFINITY;
    if (row < sq && t == 0) delta_out[lrow] = acc;
  }

  float dq_acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;
  const float sl2 = scale * hw::kLog2e;
  const int w0 = q0 + 16 * warp;  // the warp's first row
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * BK;
    const float* Kt = KVs + 2 * (it % 2) * BK * kLD;
    const float* Vt = Kt + BK * kLD;
    hw::cp_async_wait<0>();
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1's stage
    if (it + 1 < n_tiles) load_kv(it + 1);
    hw::cp_async_commit();
    if (causal && t0 > w0 + 15 + offset) continue;  // no row of this warp sees the tile

    float s[kNT][4], dp[kNT][4];  // S = Q K^T, dP = dO V^T: this warp's rows, BK keys
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_xyt<kNT, kLD>(s, Qs + 16 * warp * kLD, Kt, d, g, t);
    mma_xyt<kNT, kLD>(dp, dOs + 16 * warp * kLD, Vt, d, g, t);

    // ds = p (dp - delta) scale over s, p = 2^(s scale log2 e - lse log2 e);
    // s[j][2 i + e] is row r_lo + 8 i, key t0 + 8 j + 2 t + e.  Only a tile
    // that crosses the warp's diagonal or the last key masks per element.
    const bool edge = (causal && t0 + BK - 1 > w0 + offset) || t0 + BK > sk;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int lim = min(sk, causal ? q0 + r_lo + 8 * i + offset + 1 : sk) - t0;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 2 * i + e;
          float p = hw::exp2_approx(fmaf(s[j][x], sl2, -lse2[i]));
          if (edge && 8 * j + 2 * t + e >= lim) p = 0.f;
          s[j][x] = p * (dp[j][x] - delta_r[i]) * scale;
        }
    }
    mma_ay<kNT, DP / 8, kLD>(dq_acc, s, Kt, d, g, t);  // dQ += dS K
  }
  hw::cp_async_wait<0>();
  store_xy(dq_acc, dq + q_base, q_stride, q0 + r_lo, sq, d, t);
}

// B3c in f32: one block per (tile of 16 NW keys, kv head, batch row), 16
// keys a warp; K and V stay in shared memory, the group's Q and dO tiles of
// BQ rows, with their lse and delta, stream through two cp.async stages.
// S^T = K Q^T and dP^T = V dO^T leave P^T and dS^T in the accumulator
// layout that mma_ay takes as the A of dV += P^T dO and dK += dS^T Q.  dK
// and dV are accumulated DC head-dim columns a pass (a second pass at d >
// 128 recomputes S^T and dP^T rather than hold 256 accumulators a lane).
template <int DP, int NW, int BQ>
struct Tf32Dkv {
  static constexpr int kThreads = 32 * NW;
  static constexpr int kBK = 16 * NW;
  static constexpr int kLD = DP + 4;
  static constexpr size_t kSmem =
      sizeof(float) * ((2 * kBK + 4 * BQ) * static_cast<size_t>(kLD) + 4 * BQ);
};

template <int DP, int NW, int BQ, int DC, int MIN_BLOCKS>
__global__ void __launch_bounds__(32 * NW, MIN_BLOCKS)
bwd_dkv_tf32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, int sq, int sk, int hq, int hkv,
             int d, float scale, int causal) {
  using L = Tf32Dkv<DP, NW, BQ>;
  constexpr int kBK = L::kBK, kLD = L::kLD, kThreads = L::kThreads, kNT = BQ / 8;
  static_assert(kThreads >= 2 * BQ && DP % DC == 0, "a thread a row of lse, delta");
  extern __shared__ __align__(16) float fsm[];
  float* Ks = fsm;               // [kBK][kLD]
  float* Vs = Ks + kBK * kLD;    // [kBK][kLD]
  float* QDs = Vs + kBK * kLD;   // stage st: Q at QDs + 2 st BQ kLD, dO after it
  float* LDs = QDs + 4 * BQ * kLD;  // stage st: lse at LDs + 2 st BQ, delta after it

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * kBK;
  const int rep = hq / hkv;
  const int offset = sk - sq;
  const int64_t q_stride = static_cast<int64_t>(hq) * d;
  const int64_t kv_stride = static_cast<int64_t>(hkv) * d;
  const int64_t kv_base = static_cast<int64_t>(b) * sk * kv_stride + static_cast<int64_t>(hk) * d;

  // the first query row that sees key k0 is k0 - offset; tiles run over the
  // group's rep heads, n_qt tiles each
  const int q_begin = causal ? max(0, k0 - offset) : 0;
  const int n_qt = q_begin < sq ? (sq - q_begin + BQ - 1) / BQ : 0;
  const int n_tiles = rep * n_qt;
  auto load_q = [&](int it) {
    const int r = it / n_qt, t0 = q_begin + (it - r * n_qt) * BQ;
    const int h = hk * rep + r;
    const int64_t at = static_cast<int64_t>(b) * sq * q_stride + static_cast<int64_t>(h) * d +
                       t0 * q_stride;
    float* Qt = QDs + 2 * (it % 2) * BQ * kLD;
    hw::load_f32_tile<BQ, DP, kThreads>(Qt, q + at, q_stride, sq - t0, d, tid);
    hw::load_f32_tile<BQ, DP, kThreads>(Qt + BQ * kLD, dout + at, q_stride, sq - t0, d, tid);
    if (tid < 2 * BQ) {
      const int i = tid % BQ;
      const bool valid = t0 + i < sq;
      const int64_t l = (static_cast<int64_t>(b) * hq + h) * sq + t0 + i;
      hw::cp_async4(hw::smem_u32(LDs + 2 * (it % 2) * BQ + tid),
                    valid ? (tid < BQ ? lse : delta) + l : lse, valid);
    }
  };
  hw::load_f32_tile<kBK, DP, kThreads>(Ks, k + kv_base + k0 * kv_stride, kv_stride, sk - k0, d,
                                       tid);
  hw::load_f32_tile<kBK, DP, kThreads>(Vs, v + kv_base + k0 * kv_stride, kv_stride, sk - k0, d,
                                       tid);

  const float sl2 = scale * hw::kLog2e;
  const int r_lo = 16 * warp + g;  // this lane's keys: k0 + r_lo and k0 + r_lo + 8
  const int w0 = k0 + 16 * warp;   // the warp's first key
  for (int c0 = 0; c0 < DP; c0 += DC) {
    if (n_tiles > 0) load_q(0);  // K and V land with tile 0
    hw::cp_async_commit();
    float dk_acc[DC / 8][4], dv_acc[DC / 8][4];
#pragma unroll
    for (int j = 0; j < DC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
    for (int it = 0; it < n_tiles; ++it) {
      const int t0 = q_begin + (it % n_qt) * BQ;
      const float* Qt = QDs + 2 * (it % 2) * BQ * kLD;
      const float* dOt = Qt + BQ * kLD;
      const float* ls = LDs + 2 * (it % 2) * BQ;
      const float* dls = ls + BQ;
      hw::cp_async_wait<0>();
      __syncthreads();  // tile it has landed; every warp is done with tile it - 1's stage
      if (it + 1 < n_tiles) load_q(it + 1);
      hw::cp_async_commit();
      if (causal && w0 > t0 + BQ - 1 + offset) continue;  // no row sees this warp's keys

      float s[kNT][4], dp[kNT][4];  // S^T = K Q^T, dP^T = V dO^T: this warp's keys, BQ rows
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_xyt<kNT, kLD>(s, Ks + 16 * warp * kLD, Qt, d, g, t);
      mma_xyt<kNT, kLD>(dp, Vs + 16 * warp * kLD, dOt, d, g, t);

      // p^T over s and ds^T over dp; s[j][2 i + e] is key k0 + r_lo + 8 i,
      // query row t0 + 8 j + 2 t + e with its own lse and delta.  Only a
      // tile that crosses the warp's diagonal or the last row masks per
      // element.
      const bool edge = (causal && w0 + 15 > t0 + offset) || t0 + BQ > sq;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
        const float2 d2 = *reinterpret_cast<const float2*>(dls + c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float lc = hw::lse_log2(e ? l2.y : l2.x), dc = e ? d2.y : d2.x;
          // keys that query row t0 + c + e sees: key <= t0 + c + e + offset
          const int lim = t0 + c + e < sq ? (causal ? t0 + c + e + offset + 1 : sk) : -1;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int x = 2 * i + e;
            float p = hw::exp2_approx(fmaf(s[j][x], sl2, -lc));
            if (edge && k0 + r_lo + 8 * i >= lim) p = 0.f;
            s[j][x] = p;
            dp[j][x] = p * (dp[j][x] - dc) * scale;
          }
        }
      }
      mma_ay<kNT, DC / 8, kLD>(dv_acc, s, dOt + c0, d - c0, g, t);  // dV += P^T dO
      mma_ay<kNT, DC / 8, kLD>(dk_acc, dp, Qt + c0, d - c0, g, t);  // dK += dS^T Q
    }
    hw::cp_async_wait<0>();
    store_xy(dk_acc, dk + kv_base + c0, kv_stride, k0 + r_lo, sk, d - c0, t);
    store_xy(dv_acc, dv + kv_base + c0, kv_stride, k0 + r_lo, sk, d - c0, t);
    __syncthreads();  // the next pass reloads stage 0
  }
}

template <int DP, int NW, int BK, int MIN_BLOCKS>
int launch_dq_tf32(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* dq, void* delta, int b, int sq, int sk, int hq,
                   int hkv, int d, float scale, int causal, cudaStream_t s) {
  using L = Tf32Dq<DP, NW, BK>;
  auto kernel = bwd_dq_tf32<DP, NW, BK, MIN_BLOCKS>;
  const cudaError_t e = set_smem(kernel, L::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3((sq + L::kBQ - 1) / L::kBQ, hq, b), L::kThreads, L::kSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(dq), static_cast<float*>(delta), sq,
      sk, hq, hkv, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, int NW, int BQ, int DC, int MIN_BLOCKS>
int launch_dkv_tf32(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int b, int sq,
                    int sk, int hq, int hkv, int d, float scale, int causal, cudaStream_t s) {
  using L = Tf32Dkv<DP, NW, BQ>;
  auto kernel = bwd_dkv_tf32<DP, NW, BQ, DC, MIN_BLOCKS>;
  const cudaError_t e = set_smem(kernel, L::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3((sk + L::kBK - 1) / L::kBK, hkv, b), L::kThreads, L::kSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), sq,
      sk, hq, hkv, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// the instances of the note at the top of this file
int dispatch_tf32(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const void* lse, void* dq, void* dk, void* dv, void* delta, int b, int sq,
                  int sk, int hq, int hkv, int d, float scale, int causal, bool dq_pass,
                  cudaStream_t s) {
  if (dq_pass) {
    if (d <= 64)
      return launch_dq_tf32<64, 4, 64, 2>(q, k, v, o, dout, lse, dq, delta, b, sq, sk, hq, hkv,
                                          d, scale, causal, s);
    if (d <= 128)
      return launch_dq_tf32<128, 8, 32, 1>(q, k, v, o, dout, lse, dq, delta, b, sq, sk, hq,
                                           hkv, d, scale, causal, s);
    return launch_dq_tf32<256, 4, 16, 1>(q, k, v, o, dout, lse, dq, delta, b, sq, sk, hq, hkv,
                                         d, scale, causal, s);
  }
  if (d <= 64)
    return launch_dkv_tf32<64, 4, 32, 64, 2>(q, k, v, dout, lse, delta, dk, dv, b, sq, sk, hq,
                                             hkv, d, scale, causal, s);
  if (d <= 128)
    return launch_dkv_tf32<128, 8, 32, 128, 1>(q, k, v, dout, lse, delta, dk, dv, b, sq, sk, hq,
                                               hkv, d, scale, causal, s);
  return launch_dkv_tf32<256, 4, 16, 128, 1>(q, k, v, dout, lse, delta, dk, dv, b, sq, sk, hq,
                                             hkv, d, scale, causal, s);
}

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16, head_dim <= 128 (B3b also at 128 < d <= 256): wgmma, S and dP in
// registers, cp.async tile ring
// ---------------------------------------------------------------------------
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

// B3b; at DP 256 too (128 < d <= 256): Q, dO and the two stages of K, V
// take 193 KB, one block an SM
template <int DP>
int launch_dq_wg(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 const void* lse, void* dq, void* delta, int b, int sq, int sk, int hq, int hkv,
                 int d, float scale, int causal, cudaStream_t s) {
  constexpr size_t kTile = kBR * DP * sizeof(bf16);  // bytes of one tile
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
  return static_cast<int>(cudaGetLastError());
}

// B3c
template <int DP>
int launch_dkv_wg(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dk, void* dv, int b, int sq, int sk,
                  int hq, int hkv, int d, float scale, int causal, cudaStream_t s) {
  constexpr size_t kTile = kBR * DP * sizeof(bf16);  // bytes of one tile
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
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16, 128 < head_dim <= 256, dK and dV: wgmma, two warpgroups a block
// ---------------------------------------------------------------------------
// How B3c's two warpgroups share a tile's products at 128 < d <= 256 (each
// holds one m64n256 accumulator, 128 registers a thread): warpgroup 0 forms
// P^T and accumulates dV, warpgroup 1 reads P^T in f32 from warpgroup 0
// through shared memory, forms dS^T and accumulates dK (four products a
// tile).
template <int DP>
struct WideDkvLayout {
  static constexpr int kThreads = 256;
  static constexpr size_t kTile = kBR * DP * sizeof(bf16);  // bytes of one tile
  static constexpr size_t kExchange = kBR * kBR * sizeof(float);
  // K, V, the stages of Q and dO, the exchange tile, the stages' lse and
  // delta rows; 1024 bytes of alignment slack
  static constexpr size_t kSmem =
      (2 + 2 * kStages) * kTile + kExchange + 2 * kStages * kBR * sizeof(float) + 1024;
};

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// B3c at 128 < d <= 256: one block per (tile of 64 keys, kv head, batch
// row).  K and V stay in shared memory; the group's Q and dO tiles (64
// rows) with their lse and delta stream through a ring of kStages stages.
template <int DP>
__global__ void __launch_bounds__(256, 1)
bwd_dkv_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk, int hq, int hkv,
             int d, float scale, int causal) {
  using L = WideDkvLayout<DP>;
  constexpr int kBK = kBR, kBQ = kBR, kThreads = L::kThreads;
  extern __shared__ unsigned char smem_raw[];
  bf16* Ks = hw::smem_base(smem_raw);  // [kBK][DP] SW128
  bf16* Vs = Ks + kBK * DP;
  bf16* QDs = Vs + kBK * DP;           // stage st: Q at QDs + 2 st kBQ DP, dO after it
  float* Xs = reinterpret_cast<float*>(QDs + 2 * kStages * kBQ * DP);  // P^T, [32][128]
  float* LDs = Xs + L::kExchange / sizeof(float);  // stage st: lse, delta

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = tid & 31;
  const int quad = lane & 3;
  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * kBK;
  const int rep = hq / hkv;
  const int offset = sk - sq;
  const int64_t q_stride = static_cast<int64_t>(hq) * d;
  const int64_t kv_stride = static_cast<int64_t>(hkv) * d;
  const int64_t kv_base = static_cast<int64_t>(b) * sk * kv_stride + static_cast<int64_t>(hk) * d;

  // the first query row that sees key k0 is k0 - offset; tiles run over the
  // group's rep heads, n_qt tiles each, in a fixed order
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
  for (int st = 0; st < kStages - 1; ++st) {  // K and V land with tile 0
    if (st < n_tiles) load_q(st);
    hw::cp_async_commit();
  }

  // dV (warpgroup 0) or dK (warpgroup 1) of the block's 64 keys
  float acc[DP / 2];
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) acc[x] = 0.f;
  const float sl2 = scale * hw::kLog2e;
  const int r_lo = warp * 16 + (lane >> 2);  // this thread's keys: r_lo, r_lo + 8 past k0
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = q_begin + (it % n_qt) * kBQ;
    const bf16* Qt = QDs + 2 * (it % kStages) * kBQ * DP;
    const bf16* dOt = Qt + kBQ * DP;
    const float* ls = LDs + 2 * (it % kStages) * kBQ;
    const float* dls = ls + kBQ;
    hw::cp_async_wait<kStages - 2>();
    // tile it has landed; tile it - 1's stage and the exchange tile are free
    __syncthreads();
    if (it + kStages - 1 < n_tiles) load_q(it + kStages - 1);
    hw::cp_async_commit();
    if (causal && k0 > t0 + kBQ - 1 + offset) continue;

    float s[32], dp[32];  // S^T = K Q^T and dP^T = V dO^T, [64 keys][64 rows]
    hw::wgmma_fence();
    if (wg == 0) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        hw::wgmma_ss_m64n64(s, hw::desc_kmajor(Ks, kBK, kk), hw::desc_kmajor(Qt, kBQ, kk), kk);
    }
    hw::wgmma_commit();
    if (wg == 1) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        hw::wgmma_ss_m64n64(dp, hw::desc_kmajor(Vs, kBK, kk), hw::desc_kmajor(dOt, kBQ, kk),
                            kk);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<1>();  // S^T is done; p^T is computed while dP^T runs
    if (wg == 0) {
      hw::fence_regs(s);
      // p^T over s; a column is a query row with its own lse.  Only a tile
      // that crosses the diagonal or the last row masks per element.
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
    }
    uint32_t a[4][4];  // P^T (warpgroup 0) or dS^T (warpgroup 1) in bf16 as the A operand
    if (wg == 0) {
      // thread t's accumulator slots are thread t's in warpgroup 1 too:
      // slot x of every thread in a row of 128 floats, conflict-free
#pragma unroll
      for (int x = 0; x < 32; ++x) Xs[x * 128 + t] = s[x];
      named_arrive(1, 256);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hw::acc_to_a(s, kk, a[kk]);
    } else {
      hw::wgmma_wait<0>();
      hw::fence_regs(dp);
      named_sync(1, 256);  // warpgroup 0's P^T of this tile is written
#pragma unroll
      for (int x = 0; x < 32; ++x) s[x] = Xs[x * 128 + t];
      // ds^T = p^T (dp^T - delta) scale, from the f32 p
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(dls + 8 * j + 2 * quad);
#pragma unroll
        for (int x = 4 * j; x < 4 * j + 4; ++x)
          dp[x] = s[x] * (dp[x] - (x & 1 ? d2.y : d2.x)) * scale;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hw::acc_to_a(dp, kk, a[kk]);
    }
    // dV += P^T dO (warpgroup 0), dK += dS^T Q (warpgroup 1)
    const bf16* Yt = wg == 0 ? dOt : Qt;
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      hw::wgmma_rs_tb<DP>(acc, a[kk], hw::desc_mnmajor(Yt, kBQ, kk), 1);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(acc);
    hw::fence_regs(a);
  }
  hw::cp_async_wait<0>();
  hw::store_acc(acc, (wg == 0 ? dv : dk) + kv_base, kv_stride, k0 + r_lo, sk, d, quad);
}

template <int DP>
int launch_dkv_wide(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int b, int sq,
                    int sk, int hq, int hkv, int d, float scale, int causal, cudaStream_t s) {
  using L = WideDkvLayout<DP>;
  auto kernel = bwd_dkv_wide<DP>;
  cudaError_t e = set_smem(kernel, L::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3((sk + kBR - 1) / kBR, hkv, b), L::kThreads, L::kSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk,
      hq, hkv, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, const void* o, const void* dout,
             const void* lse, void* dq, void* dk, void* dv, void* delta, int b, int sq,
             int sk, int hq, int hkv, int d, float scale, int causal, int dtype,
             bool dq_pass, void* stream) {
  if (b == 0 || sq == 0 || sk == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != ptt::kBF16)
    return dispatch_tf32(q, k, v, o, dout, lse, dq, dk, dv, delta, b, sq, sk, hq, hkv, d,
                         scale, causal, dq_pass, s);
  if (dq_pass) {
    if (d <= 64)
      return launch_dq_wg<64>(q, k, v, o, dout, lse, dq, delta, b, sq, sk, hq, hkv, d, scale,
                              causal, s);
    if (d <= 128)
      return launch_dq_wg<128>(q, k, v, o, dout, lse, dq, delta, b, sq, sk, hq, hkv, d, scale,
                               causal, s);
    return launch_dq_wg<256>(q, k, v, o, dout, lse, dq, delta, b, sq, sk, hq, hkv, d, scale,
                             causal, s);
  }
  if (d <= 64)
    return launch_dkv_wg<64>(q, k, v, dout, lse, delta, dk, dv, b, sq, sk, hq, hkv, d, scale,
                             causal, s);
  if (d <= 128)
    return launch_dkv_wg<128>(q, k, v, dout, lse, delta, dk, dv, b, sq, sk, hq, hkv, d, scale,
                              causal, s);
  return launch_dkv_wide<256>(q, k, v, dout, lse, delta, dk, dv, b, sq, sk, hq, hkv, d, scale,
                              causal, s);
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
