// B6: single-query GQA decode attention over the static KV cache, with the
// new token's key and value appended to the cache in place.
//
// Replaces paddle_tpu/ops/pallas/decode_attention.py: decode_attention ->
// _decode_kernel (pallas_call at decode_attention.py:172).  Same function:
// query head ikv * g + ig (g = h / kv) attends cache columns
// [pad_lens[b], pos) in an f32 online softmax, and the new token (always
// valid) is folded in last; cache row pos is stale and is never read.  Row
// pos of k and v is then written with k_new / v_new in the caller's cache
// tensors, by exactly one block per (b, kv head); every other row is left
// bit-identical.  With pad >= pos only the new token is attended.
//
// Bound on the H100: bytes.  Each step reads the valid prefix of the cache
// once (2 * cols * d elements per (b, kv head)) for ~4 * g operations a
// column pair, far below the card's operations-per-byte balance.  Design:
// one block of four warps per (kv head, batch row), so the g query heads of
// a group share each cache row read (no repeat of K/V for GQA); the warps
// split the columns, each lane holding d/32 consecutive columns of the
// group's queries and accumulators in registers (one vector load per row),
// and merge their (m, l, acc) states through shared memory at the end.  A
// warp loads several cache rows before it uses any, to keep more reads in
// flight than one row at a time.  The TPU kernel's sequential sweep over cache
// blocks and its aliased output block become this loop and one row store.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupRows = 4;  // query heads of a GQA group per pass
constexpr int kMaxD = 256;

template <typename T, int DPL, int kUnroll = (DPL >= 8 ? 2 : 4)>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
              const T* __restrict__ v_new, T* __restrict__ cache_k,
              T* __restrict__ cache_v, const int* __restrict__ pad_lens,
              T* __restrict__ out, int C, int h, int kv, int d, int pos, float scale) {
  __shared__ float sm_m[kWarps][kGroupRows];
  __shared__ float sm_l[kWarps][kGroupRows];
  __shared__ float sm_acc[kWarps][kGroupRows][kMaxD];
  const int ikv = blockIdx.x, b = blockIdx.y;
  const int g = h / kv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pad = pad_lens != nullptr ? pad_lens[b] : 0;
  const int64_t row_stride = static_cast<int64_t>(kv) * d;  // between cache rows
  const int64_t head_off = static_cast<int64_t>(b) * C * row_stride +
                           static_cast<int64_t>(ikv) * d;
  const T* kc = cache_k + head_off;
  const T* vc = cache_v + head_off;
  const T* kn = k_new + (static_cast<int64_t>(b) * kv + ikv) * d;
  const T* vn = v_new + (static_cast<int64_t>(b) * kv + ikv) * d;
  const int c0 = lane * DPL;  // this lane's DPL consecutive columns

  for (int g0 = 0; g0 < g; g0 += kGroupRows) {
    const int gc = min(kGroupRows, g - g0);
    const int64_t head0 = static_cast<int64_t>(b) * h + static_cast<int64_t>(ikv) * g + g0;
    const T* qg = q + head0 * d;  // query head g0 + r at qg + r * d
    float qr[kGroupRows][DPL], acc[kGroupRows][DPL], m[kGroupRows], l[kGroupRows];
#pragma unroll
    for (int r = 0; r < kGroupRows; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) qr[r][i] = acc[r][i] = 0.f;
      if (r < gc && c0 < d) ptt::load_f32<T, DPL>(qg + r * d + c0, qr[r]);
    }

    // each warp takes kUnroll consecutive rows at a time, loading them all
    // before using any, so that several row reads are in flight at once
    for (int j0 = pad + warp * kUnroll; j0 < pos; j0 += kWarps * kUnroll) {
      float kr[kUnroll][DPL], vr[kUnroll][DPL];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < DPL; ++i) kr[u][i] = vr[u][i] = 0.f;
        if (j0 + u < pos && c0 < d) {
          const int64_t off = static_cast<int64_t>(j0 + u) * row_stride + c0;
          ptt::load_f32<T, DPL>(kc + off, kr[u]);
          ptt::load_f32<T, DPL>(vc + off, vr[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + u >= pos) break;
#pragma unroll
        for (int r = 0; r < kGroupRows; ++r) {
          if (r < gc) {
            float part = 0.f;
#pragma unroll
            for (int i = 0; i < DPL; ++i) part += qr[r][i] * kr[u][i];
            const float sc = ptt::warp_sum(part) * scale;
            const float m_new = fmaxf(m[r], sc);
            const float alpha = expf(m[r] - m_new);
            const float p = expf(sc - m_new);
            l[r] = l[r] * alpha + p;
#pragma unroll
            for (int i = 0; i < DPL; ++i) acc[r][i] = acc[r][i] * alpha + p * vr[u][i];
            m[r] = m_new;
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kGroupRows; ++r) {
      if (r < gc) {
        if (lane == 0) {
          sm_m[warp][r] = m[r];
          sm_l[warp][r] = l[r];
        }
        if (c0 < d) {
#pragma unroll
          for (int i = 0; i < DPL; ++i) sm_acc[warp][r][c0 + i] = acc[r][i];
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
        float a = p_new * ptt::to_f32(vn[c]);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) a += sm_acc[w][r][c] * wt[w];
        orow[c] = ptt::from_f32<T>(a / lsum);
      }
    }
    __syncthreads();  // shared memory is reused by the next group pass
  }

  // the in-place append: this block alone owns row pos of its (b, kv head)
  T* kdst = cache_k + head_off + pos * row_stride;
  T* vdst = cache_v + head_off + pos * row_stride;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    kdst[c] = kn[c];
    vdst[c] = vn[c];
  }
}

template <typename T, int DPL>
int launch(const void* q, const void* kn, const void* vn, void* ck, void* cv,
           const void* pad_lens, void* out, int b, int C, int h, int kv, int d, int pos,
           float scale, cudaStream_t s) {
  const dim3 grid(kv, b);
  decode_kernel<T, DPL><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn), static_cast<const T*>(vn),
      static_cast<T*>(ck), static_cast<T*>(cv), static_cast<const int*>(pad_lens),
      static_cast<T*>(out), C, h, kv, d, pos, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* kn, const void* vn, void* ck, void* cv,
             const void* pad_lens, void* out, int b, int C, int h, int kv, int d, int pos,
             float scale, cudaStream_t s) {
  const int dpl = (d + 31) / 32;
  if (dpl <= 1) return launch<T, 1>(q, kn, vn, ck, cv, pad_lens, out, b, C, h, kv, d, pos, scale, s);
  if (dpl <= 2) return launch<T, 2>(q, kn, vn, ck, cv, pad_lens, out, b, C, h, kv, d, pos, scale, s);
  if (dpl <= 4) return launch<T, 4>(q, kn, vn, ck, cv, pad_lens, out, b, C, h, kv, d, pos, scale, s);
  return launch<T, 8>(q, kn, vn, ck, cv, pad_lens, out, b, C, h, kv, d, pos, scale, s);
}

}  // namespace

// q, out [b, 1, h, d]; k_new, v_new [b, 1, kv, d]; cache_k, cache_v
// [b, C, kv, d], written in place at row pos; one dtype (0 = f32, 1 = bf16);
// d <= 256; 0 <= pos < C; pad_lens [b] int32 or NULL.
extern "C" int ptt_decode_attention(const void* q, const void* k_new, const void* v_new,
                                    void* cache_k, void* cache_v, const void* pad_lens,
                                    void* out, int b, int C, int h, int kv, int d,
                                    int pos, float scale, int dtype, void* stream) {
  if (b == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16)
    return dispatch<__nv_bfloat16>(q, k_new, v_new, cache_k, cache_v, pad_lens, out, b, C,
                                   h, kv, d, pos, scale, s);
  return dispatch<float>(q, k_new, v_new, cache_k, cache_v, pad_lens, out, b, C, h, kv, d,
                         pos, scale, s);
}
