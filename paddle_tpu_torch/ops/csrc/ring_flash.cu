// B10's own kernel: the online-softmax merge of one ring hop's flash output
// into a ring member's running (out, lse) pair.
//
// Replaces paddle_tpu/ops/pallas/ring_flash.py: ring_flash_attention
// (ring_flash.py:159).  That function has no pallas_call of its own: at each
// hop of the sep ring it runs the flash kernels B3 (forward) or B3b/B3c
// (backward) on one (member, source chunk) pair, and the forward merges the
// hop's result into the running pair with _merge (ring_flash.py:47), which
// XLA fuses into the surrounding program.  The port's ring loop
// (ops/ring_flash.py) launches B3/B3b/B3c per hop; this file is the merge:
//   new = logaddexp(lse, lse_i)
//   o   = o * exp(lse - new) + float(o_i) * exp(lse_i - new)
// with both weights 0 where new == -inf, in place on the running o (f32,
// [b, c, hq, d]) and lse (f32, [b, hq, c]); o_i is in q's dtype (f32 or
// bf16), as B3 returns it, and lse_i f32 [b, hq, c].
//
// Bound on the H100: bytes (o read and written in f32, o_i read, the lse
// rows; a few operations an element).  Eager PyTorch would spend about eight
// launches a hop on it, each a pass over [b, c, hq, d] in f32.  Design: one
// pass, one warp per (batch, row, head) row of d columns.  Every lane reads
// the row's two lse values (one broadcast transaction), computes the two
// weights, and streams its columns of o in 16-byte f32 vectors (4 columns a
// lane, one iteration at d = 128); lane 0 writes the new lse after the warp
// has read the old one.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 4;  // columns a lane handles per iteration

template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_merge_kernel(float* __restrict__ o, float* __restrict__ lse,
                  const T* __restrict__ o_i, const float* __restrict__ lse_i,
                  long long rows, int c, int hq, int d) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  // row = (batch * c + t) * hq + head, the order of o; lse is [b, hq, c]
  const int head = static_cast<int>(row % hq);
  const long long bt = row / hq;
  const int t = static_cast<int>(bt % c);
  const long long li = ((bt / c) * hq + head) * c + t;
  const float a = lse[li], b = lse_i[li];
  const float m = fmaxf(a, b);
  float wa = 0.f, wb = 0.f, now = -INFINITY;
  if (m != -INFINITY) {
    now = m + log1pf(expf(-fabsf(a - b)));
    wa = expf(a - now);
    wb = expf(b - now);
  }
  float* orow = o + row * d;
  const T* irow = o_i + row * d;
  for (int col = lane * kCols; col < d; col += 32 * kCols) {
    float x[kCols], y[kCols];
    ptt::load_f32<float, kCols>(orow + col, x);
    ptt::load_f32<T, kCols>(irow + col, y);
#pragma unroll
    for (int j = 0; j < kCols; ++j) x[j] = x[j] * wa + y[j] * wb;
    ptt::store_f32<float, kCols>(orow + col, x);
  }
  __syncwarp();
  if (lane == 0) lse[li] = now;
}

}  // namespace

// o [b, c, hq, d] f32 and lse [b, hq, c] f32, both updated in place; o_i
// [b, c, hq, d] in dtype (0 = f32, 1 = bf16); lse_i [b, hq, c] f32;
// rows = b * c * hq; d % 4 == 0.
extern "C" int ptt_ring_merge(void* o, void* lse, const void* o_i, const void* lse_i,
                              long long rows, int c, int hq, int d, int dtype,
                              void* stream) {
  if (rows > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(static_cast<unsigned>((rows + kWarps - 1) / kWarps));
    float* of = static_cast<float*>(o);
    float* lf = static_cast<float*>(lse);
    const float* lif = static_cast<const float*>(lse_i);
    if (dtype == ptt::kBF16) {
      ring_merge_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          of, lf, static_cast<const __nv_bfloat16*>(o_i), lif, rows, c, hq, d);
    } else {
      ring_merge_kernel<float><<<grid, kThreads, 0, s>>>(
          of, lf, static_cast<const float*>(o_i), lif, rows, c, hq, d);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
