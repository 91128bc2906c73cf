// B2: rotate-half rotary position embedding on q and k, forward.
//
// Replaces paddle_tpu/ops/pallas/rope.py: fused_rope -> _rope_raw ->
// _rope_kernel (pallas_call at rope.py:47).  Same function, in f32, cast
// back: out = v * cos + rotate_half(v) * sin with rotate_half(v) =
// [-v[d/2:], v[:d/2]].  The TPU kernel takes cos/sin already sliced to
// [s, d]; here the kernel takes each token's position (pos_ids [b, s]) and
// the full [max_pos, d] f32 tables, so one kernel serves the unpadded
// prefill, every decode step and the per-row offsets of left-padded rows
// (generation.rope_with_row_offsets).  Positions are clipped into the table.
//
// The backward (B2 bwd, rope.py:81 _rope_bwd) is this same kernel: the
// rotation is orthogonal, R(theta)^T = R(-theta), so the gradients dq, dk go
// through it with sin_sign = -1, which negates the sine where it is read.
// No second kernel and no negated table.
//
// Bound on the H100: bytes (q and k read and written once, a few operations
// an element).  Design: one block per token, its threads over the
// (head, column pair) grid of q and then k; a thread reads the pair
// (i, i + d/2), so no element is read twice and no temporary goes to memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const int* __restrict__ pos_ids, const float* __restrict__ cos_t,
            const float* __restrict__ sin_t, T* __restrict__ q_out,
            T* __restrict__ k_out, int hq, int hk, int d, int max_pos,
            float sin_sign) {
  const int64_t tok = blockIdx.x;  // b * s + position in the sequence
  const int p = min(max(pos_ids[tok], 0), max_pos - 1);
  const float* c = cos_t + static_cast<int64_t>(p) * d;
  const float* sn = sin_t + static_cast<int64_t>(p) * d;
  const int half = d >> 1;
  const int nq = hq * half, nk = hk * half;
  for (int e = threadIdx.x; e < nq + nk; e += kThreads) {
    const bool is_q = e < nq;
    const int j = is_q ? e : e - nq;
    const int head = j / half, col = j - head * half;
    const int64_t base = is_q ? (tok * hq + head) * d : (tok * hk + head) * d;
    const T* src = (is_q ? q : k) + base;
    T* dst = (is_q ? q_out : k_out) + base;
    const float x1 = ptt::to_f32(src[col]);
    const float x2 = ptt::to_f32(src[col + half]);
    const float s1 = sin_sign * sn[col], s2 = sin_sign * sn[col + half];
    dst[col] = ptt::from_f32<T>(x1 * c[col] - x2 * s1);
    dst[col + half] = ptt::from_f32<T>(x2 * c[col + half] + x1 * s2);
  }
}

}  // namespace

// q, q_out [b*s, hq, d]; k, k_out [b*s, hk, d]; one dtype (0 = f32,
// 1 = bf16); pos_ids [b*s] int32; cos, sin [max_pos, d] f32; sin_sign +1
// rotates by +theta (the forward), -1 by -theta (the backward).
extern "C" int ptt_rope_fwd(const void* q, const void* k, const void* pos_ids,
                            const void* cos_t, const void* sin_t, void* q_out,
                            void* k_out, long long tokens, int hq, int hk, int d,
                            int max_pos, float sin_sign, int dtype, void* stream) {
  if (tokens > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(static_cast<unsigned>(tokens));
    const int* pid = static_cast<const int*>(pos_ids);
    const float* ct = static_cast<const float*>(cos_t);
    const float* st = static_cast<const float*>(sin_t);
    if (dtype == ptt::kBF16) {
      using T = __nv_bfloat16;
      rope_kernel<T><<<grid, kThreads, 0, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), pid, ct, st,
          static_cast<T*>(q_out), static_cast<T*>(k_out), hq, hk, d, max_pos, sin_sign);
    } else {
      rope_kernel<float><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(k), pid, ct, st,
          static_cast<float*>(q_out), static_cast<float*>(k_out), hq, hk, d, max_pos,
          sin_sign);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
