// B6, B8 and B9: single-query GQA decode attention over the static KV cache,
// with the new token's key and value appended to the cache in place.
//
// Replaces paddle_tpu/ops/pallas/decode_attention.py:
//   B6 decode_attention -> _decode_kernel (pallas_call at :172), a cache in
//      q's own dtype;
//   B8 decode_attention_int8 -> _decode_kernel_int8 (pallas_call at :399),
//      int8 rows with per-(token, kv head) f32 scales in planes [b, kv, C];
//   B9 decode_attention_fp8 -> _decode_kernel_fp8 (pallas_call at :627),
//      e4m3 rows under one static scale.
// One function for all three: query head ikv * g + ig (g = h / kv) attends
// cache columns [pad_lens[b], pos) in an f32 online softmax, and the new
// token (always valid, and exact: never quantized for this step) is folded
// in last; cache row pos is stale and is never read.  Row pos of k and v
// (and for B8 column pos of the scale planes) is then written with k_new /
// v_new, quantized for B8 and B9, by exactly one block per (b, kv head);
// every other row and scale is left bit-identical.  With pad >= pos only
// the new token is attended.
//
// Dequantization is fused into the math, as on the TPU: a cached column's
// score is (q . k) * kf * scale and its value weight p * vf, while the
// softmax denominator sums the unscaled p (B8: kf, vf are the column's k and
// v scales; B9: both are the static scale).  B8's append takes the row's
// absmax over d, scale = max(amax, 1e-8) * f32(1/127) (XLA compiles the
// reference's "/ 127" into this product) and values rintf(x / scale) (half
// to even, as jnp.round) clipped to +-127; B9's converts x * f32(1/kv_scale)
// to e4m3 saturating at +-448 (the reference's clip, then round to nearest
// even).  Divisions are IEEE (no fast math): the appended bytes must equal
// the plain twin's.
//
// Bound on the H100: bytes.  Each step reads the valid prefix of the cache
// once (2 * cols * d elements per (b, kv head): 2 bytes each for B6 in bf16,
// 1 byte for B8 and B9, plus B8's two f32 scales a column) for ~4 * g
// operations a column pair, far below the card's operations-per-byte
// balance.  Design: one block of eight warps per (kv head, batch row), so
// the g query heads of a group share each cache row read (no repeat of K/V
// for GQA); the warps split the rows and merge their (m, l, acc) states
// through shared memory at the end.  Within a warp, rows are split over
// lane groups: a lane loads 16 bytes of a row (16 int8 or e4m3 values, 8
// bf16), so at d = 128 a row is 8 lanes for B8/B9 and 16 for B6, and one
// warp instruction reads 4 (or 2) rows.  A row's dot product reduces over
// its lane group only; the warp keeps one online-softmax state, updated
// once for all the rows it loads per step (8 at d = 128 in bf16, int8 and
// e4m3; max and sum over the lane groups), and sums the groups'
// accumulators at the end.  A first version
// with d/32 columns a lane and a reduction over the whole warp per row was
// bound by that per-row reduction, not by the bytes, and B8/B9 took B6's
// time (PERF.md).  Registers are held to two blocks an SM; MHA (g = 1) has
// an instantiation with one query row of registers, and int8/e4m3 ones
// hold two query rows a pass.  The cache element type and its
// dequantization are template parameters of the one kernel.  The TPU
// kernel's sequential sweep over cache blocks and its aliased output block
// become this loop and one row store.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroupRows = 4;  // query heads of a GQA group per pass
constexpr int kMaxD = 256;

enum class Quant { kNone, kInt8, kFp8 };

// the cache element type: q's dtype for B6, int8 for B8, e4m3 for B9
template <typename T, Quant kQ>
using CacheT = std::conditional_t<kQ == Quant::kNone, T,
                                  std::conditional_t<kQ == Quant::kInt8, int8_t, __nv_fp8_e4m3>>;

struct Args {
  const void* q;
  const void* k_new;
  const void* v_new;
  void* cache_k;
  void* cache_v;
  float* k_scale;  // B8's scale planes [b, kv, C], else null
  float* v_scale;
  const int* pad_lens;
  void* out;
  int b, C, h, kv, d, pos;
  float scale, kv_scale;  // kv_scale: B9's static scale
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, Quant kQ, int LPR, int VPL, int kGroupRows,
          int kU = (kQ == Quant::kNone && 32 / LPR < 4 ? 4 : 2)>
__global__ void __launch_bounds__(kThreads, 2) decode_kernel(const Args a) {
  using CT = CacheT<T, kQ>;
  constexpr int EPV = 16 / static_cast<int>(sizeof(CT));  // elements in 16 bytes
  constexpr int EPL = EPV * VPL;  // consecutive columns of a row a lane holds
  constexpr int RPW = 32 / LPR;   // rows a warp reads in one instruction
  using V = ptt::Vec<CT, EPV>;
  __shared__ float sm_m[kWarps][kMaxGroupRows];
  __shared__ float sm_l[kWarps][kMaxGroupRows];
  __shared__ float sm_acc[kWarps][kMaxGroupRows][kMaxD];
  const T* __restrict__ q = static_cast<const T*>(a.q);
  T* __restrict__ out = static_cast<T*>(a.out);
  CT* __restrict__ cache_k = static_cast<CT*>(a.cache_k);
  CT* __restrict__ cache_v = static_cast<CT*>(a.cache_v);
  const int C = a.C, h = a.h, kv = a.kv, d = a.d, pos = a.pos;
  const float scale = a.scale;
  const int ikv = blockIdx.x, b = blockIdx.y;
  const int g = h / kv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pad = a.pad_lens != nullptr ? a.pad_lens[b] : 0;
  const int64_t row_stride = static_cast<int64_t>(kv) * d;  // between cache rows
  const int64_t head_off = static_cast<int64_t>(b) * C * row_stride +
                           static_cast<int64_t>(ikv) * d;
  const int64_t plane_off = (static_cast<int64_t>(b) * kv + ikv) * C;  // B8's scales
  const CT* kc = cache_k + head_off;
  const CT* vc = cache_v + head_off;
  const T* kn = static_cast<const T*>(a.k_new) + (static_cast<int64_t>(b) * kv + ikv) * d;
  const T* vn = static_cast<const T*>(a.v_new) + (static_cast<int64_t>(b) * kv + ikv) * d;
  // lane = grp * LPR + sub: the LPR lanes of row group grp split a row
  const int sub = lane & (LPR - 1), grp = lane / LPR;
  const int c0 = sub * EPL;
  const bool active = c0 < d;

  for (int g0 = 0; g0 < g; g0 += kGroupRows) {
    const int gc = min(kGroupRows, g - g0);
    const int64_t head0 = static_cast<int64_t>(b) * h + static_cast<int64_t>(ikv) * g + g0;
    const T* qg = q + head0 * d;  // query head g0 + r at qg + r * d
    float qr[kGroupRows][EPL], acc[kGroupRows][EPL], m[kGroupRows], l[kGroupRows];
#pragma unroll
    for (int r = 0; r < kGroupRows; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        acc[r][e] = 0.f;
        qr[r][e] = r < gc && active ? ptt::to_f32(qg[r * d + c0 + e]) : 0.f;
      }
    }

    // a warp takes RPW * kU rows at a time (row j0 + u * RPW + grp in lane
    // group grp), loading them all, with their dequantization factors,
    // before using any
    for (int j0 = pad + warp * RPW * kU; j0 < pos; j0 += kWarps * RPW * kU) {
      V kraw[kU][VPL], vraw[kU][VPL];
      float kf[kU], vf[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int j = j0 + u * RPW + grp;
        kf[u] = vf[u] = 1.f;
#pragma unroll
        for (int w = 0; w < VPL; ++w) kraw[u][w] = vraw[u][w] = V{};
        if (j < pos) {
          if (active) {
            const int64_t off = static_cast<int64_t>(j) * row_stride + c0;
#pragma unroll
            for (int w = 0; w < VPL; ++w) {
              kraw[u][w] = *reinterpret_cast<const V*>(kc + off + w * EPV);
              vraw[u][w] = *reinterpret_cast<const V*>(vc + off + w * EPV);
            }
          }
          if constexpr (kQ == Quant::kInt8) {
            kf[u] = a.k_scale[plane_off + j];
            vf[u] = a.v_scale[plane_off + j];
          } else if constexpr (kQ == Quant::kFp8) {
            kf[u] = vf[u] = a.kv_scale;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kGroupRows; ++r) {
        if (r < gc) {
          float sc[kU];
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            sc[u] = 0.f;
#pragma unroll
            for (int w = 0; w < VPL; ++w) {
#pragma unroll
              for (int i = 0; i < EPV; ++i) sc[u] += qr[r][w * EPV + i] * ptt::to_f32(kraw[u][w].v[i]);
            }
          }
          // each row's dot product over its LPR lanes
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1) {
#pragma unroll
            for (int u = 0; u < kU; ++u) sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], o);
          }
          float mb = -INFINITY;
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            if constexpr (kQ != Quant::kNone) sc[u] *= kf[u];
            sc[u] = j0 + u * RPW + grp < pos ? sc[u] * scale : -INFINITY;
            mb = fmaxf(mb, sc[u]);
          }
          // one online-softmax state for the warp: the max and the sum run
          // over the row groups (row j0 < pos makes the max finite)
#pragma unroll
          for (int o = 16; o >= LPR; o >>= 1) mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
          const float m_new = fmaxf(m[r], mb);
          const float alpha = expf(m[r] - m_new);
          float ls = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[r][e] *= alpha;
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const float p = expf(sc[u] - m_new);
            ls += p;
            const float pv = kQ == Quant::kNone ? p : p * vf[u];
#pragma unroll
            for (int w = 0; w < VPL; ++w) {
#pragma unroll
              for (int i = 0; i < EPV; ++i) acc[r][w * EPV + i] += pv * ptt::to_f32(vraw[u][w].v[i]);
            }
          }
#pragma unroll
          for (int o = 16; o >= LPR; o >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, o);
          l[r] = l[r] * alpha + ls;
          m[r] = m_new;
        }
      }
    }

    // the row groups' accumulators share the warp's m: sum them, then lane
    // group 0 hands the warp's state to the merge
#pragma unroll
    for (int r = 0; r < kGroupRows; ++r) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
#pragma unroll
        for (int o = 16; o >= LPR; o >>= 1) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
      }
    }
#pragma unroll
    for (int r = 0; r < kGroupRows; ++r) {
      if (r < gc) {
        if (lane == 0) {
          sm_m[warp][r] = m[r];
          sm_l[warp][r] = l[r];
        }
        if (grp == 0 && active) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) sm_acc[warp][r][c0 + e] = acc[r][e];
        }
      }
    }
    __syncthreads();

    // merge the warps' states, then fold in the new token
    for (int r = warp; r < gc; r += kWarps) {
      const T* qrow = qg + r * d;
      float part = 0.f;
      for (int c = lane; c < d; c += 32) part += ptt::to_f32(qrow[c]) * ptt::to_f32(kn[c]);
      const float s_new = ptt::warp_sum(part) * scale;
      float mx = s_new;  // finite, so every weight below is exp of a finite or -inf
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
      float wt[kWarps];
      float lsum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        wt[w] = expf(sm_m[w][r] - mx);
        lsum += sm_l[w][r] * wt[w];
      }
      const float p_new = expf(s_new - mx);
      lsum += p_new;
      T* orow = out + (head0 + r) * d;
      for (int c = lane; c < d; c += 32) {
        float acc_c = p_new * ptt::to_f32(vn[c]);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) acc_c += sm_acc[w][r][c] * wt[w];
        orow[c] = ptt::from_f32<T>(acc_c / lsum);
      }
    }
    __syncthreads();  // shared memory is reused by the next group pass
  }

  // the in-place append: this block alone owns row pos of its (b, kv head)
  CT* kdst = cache_k + head_off + pos * row_stride;
  CT* vdst = cache_v + head_off + pos * row_stride;
  if constexpr (kQ == Quant::kNone) {
    for (int c = threadIdx.x; c < d; c += kThreads) {
      kdst[c] = kn[c];
      vdst[c] = vn[c];
    }
  } else if constexpr (kQ == Quant::kInt8) {
    if (warp < 2) {  // warp 0 quantizes k's row, warp 1 v's
      const T* src = warp == 0 ? kn : vn;
      CT* dst = warp == 0 ? kdst : vdst;
      float x[kMaxD / 32];
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxD / 32; ++i) {
        const int c = lane + 32 * i;
        x[i] = c < d ? ptt::to_f32(src[c]) : 0.f;
        amax = fmaxf(amax, fabsf(x[i]));
      }
      const float s = fmaxf(warp_max(amax), 1e-8f) * (1.0f / 127.0f);
#pragma unroll
      for (int i = 0; i < kMaxD / 32; ++i) {
        const int c = lane + 32 * i;
        if (c < d) dst[c] = static_cast<int8_t>(fminf(fmaxf(rintf(x[i] / s), -127.f), 127.f));
      }
      if (lane == 0) (warp == 0 ? a.k_scale : a.v_scale)[plane_off + pos] = s;
    }
  } else {
    const float inv = 1.0f / a.kv_scale;
    for (int c = threadIdx.x; c < d; c += kThreads) {
      kdst[c].__x = __nv_cvt_float_to_fp8(ptt::to_f32(kn[c]) * inv, __NV_SATFINITE, __NV_E4M3);
      vdst[c].__x = __nv_cvt_float_to_fp8(ptt::to_f32(vn[c]) * inv, __NV_SATFINITE, __NV_E4M3);
    }
  }
}

// one query row of registers for MHA (g = 1), else as many as fit
template <typename T, Quant kQ, int LPR, int VPL>
void launch(const Args& a, cudaStream_t s) {
  constexpr int EPL = 16 / static_cast<int>(sizeof(CacheT<T, kQ>)) * VPL;
  constexpr int kRows = EPL >= 16 ? 2 : kMaxGroupRows;
  const dim3 grid(a.kv, a.b);
  if (a.h == a.kv)
    decode_kernel<T, kQ, LPR, VPL, 1><<<grid, kThreads, 0, s>>>(a);
  else
    decode_kernel<T, kQ, LPR, VPL, kRows><<<grid, kThreads, 0, s>>>(a);
}

// lanes per row: the 16-byte vectors of a row (d <= 256) rounded up to a
// power of two, at most 32, then two vectors a lane; only the counts a
// cache element size can reach are instantiated
template <typename T, Quant kQ>
int dispatch(const Args& a, cudaStream_t s) {
  constexpr int kEPV = 16 / static_cast<int>(sizeof(CacheT<T, kQ>));
  if (a.b == 0) return static_cast<int>(cudaGetLastError());
  const int nv = a.d / kEPV;
  if (nv <= 1)
    launch<T, kQ, 1, 1>(a, s);
  else if (nv <= 2)
    launch<T, kQ, 2, 1>(a, s);
  else if (nv <= 4)
    launch<T, kQ, 4, 1>(a, s);
  else if (nv <= 8)
    launch<T, kQ, 8, 1>(a, s);
  else if constexpr (kEPV == 16)  // int8 and e4m3 rows: nv <= 16
    launch<T, kQ, 16, 1>(a, s);
  else if (nv <= 16)
    launch<T, kQ, 16, 1>(a, s);
  else if constexpr (kEPV == 8)  // bf16 rows: nv <= 32
    launch<T, kQ, 32, 1>(a, s);
  else if (nv <= 32)
    launch<T, kQ, 32, 1>(a, s);
  else
    launch<T, kQ, 32, 2>(a, s);
  return static_cast<int>(cudaGetLastError());
}

template <Quant kQ>
int by_dtype(const Args& a, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == ptt::kBF16 ? dispatch<__nv_bfloat16, kQ>(a, s) : dispatch<float, kQ>(a, s);
}

}  // namespace

// q, out [b, 1, h, d]; k_new, v_new [b, 1, kv, d]; cache_k, cache_v
// [b, C, kv, d], written in place at row pos; one dtype (0 = f32, 1 = bf16);
// d <= 256; 0 <= pos < C; pad_lens [b] int32 or NULL.
extern "C" int ptt_decode_attention(const void* q, const void* k_new, const void* v_new,
                                    void* cache_k, void* cache_v, const void* pad_lens,
                                    void* out, int b, int C, int h, int kv, int d,
                                    int pos, float scale, int dtype, void* stream) {
  const Args a{q, k_new, v_new, cache_k, cache_v, nullptr, nullptr,
               static_cast<const int*>(pad_lens), out, b, C, h, kv, d, pos, scale, 1.f};
  return by_dtype<Quant::kNone>(a, dtype, stream);
}

// As ptt_decode_attention with int8 caches and f32 scale planes k_scale,
// v_scale [b, kv, C] (column pos written in place); q, k_new, v_new, out in
// dtype; d % 16 == 0.
extern "C" int ptt_decode_attention_int8(const void* q, const void* k_new, const void* v_new,
                                         void* cache_k, void* cache_v, void* k_scale,
                                         void* v_scale, const void* pad_lens, void* out,
                                         int b, int C, int h, int kv, int d, int pos,
                                         float scale, int dtype, void* stream) {
  const Args a{q, k_new, v_new, cache_k, cache_v, static_cast<float*>(k_scale),
               static_cast<float*>(v_scale), static_cast<const int*>(pad_lens), out,
               b, C, h, kv, d, pos, scale, 1.f};
  return by_dtype<Quant::kInt8>(a, dtype, stream);
}

// As ptt_decode_attention with float8_e4m3fn caches under the static
// kv_scale (> 0); d % 16 == 0.
extern "C" int ptt_decode_attention_fp8(const void* q, const void* k_new, const void* v_new,
                                        void* cache_k, void* cache_v, const void* pad_lens,
                                        void* out, int b, int C, int h, int kv, int d, int pos,
                                        float scale, float kv_scale, int dtype, void* stream) {
  const Args a{q, k_new, v_new, cache_k, cache_v, nullptr, nullptr,
               static_cast<const int*>(pad_lens), out, b, C, h, kv, d, pos, scale, kv_scale};
  return by_dtype<Quant::kFp8>(a, dtype, stream);
}
