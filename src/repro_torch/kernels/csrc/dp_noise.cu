// The DP mechanism's counter-keyed Gaussian stream and the standalone
// clip + noise kernel over a block of outgoing gradient messages:
//
//   out = g · min(1, C / ‖g‖₂) + noise_std · z(seed, rid, col)
//
// Replaces the TPU kernel `_dp_clip_noise_kernel`
// (src/repro/kernels/dp_noise.py:98, pallas_call at :131) and its stream
// `gauss_counter` (dp_noise.py:56-83).
//
// The stream is a spec: `gauss_counter` below is its one CUDA definition,
// word for word the reference's. Counters (rid mod 2^23)·512 + 2·col and
// +1 (the stride is 2·KMAX = 512, KMAX = 256, not 2·K) feed the lowbias32
// hash; the high rid bits (rid >> 23) fold into a per-row key through the
// golden-ratio constant; u1 = ((h1 >> 8) + 1)·2^-24 in (0, 1],
// u2 = (h2 >> 8)·2^-24 in [0, 1); z = sqrt(−2 ln u1)·cos(2π·u2) with 2π
// rounded to fp32 first, as the reference's fp32 product does. No fast
// math: logf/cosf/sqrtf are the accurate library calls.
//
// Bound at the training slice's shapes: memory, and the launch.
// `gauss_counter_launch` writes the epoch's (28,160 × 10) block: 1.1 MB
// out, 113 KB of rids in, 0.37 us at 3.35 TB/s; its 281,600 draws at ~60
// operations each (two hash words, log, cos, sqrt) are ~17 MOP, 0.25 us at
// 67 TOP/s. `dp_clip_noise_launch` at B=256, K=10 moves 21 KB (6 ns): its
// time is the launch and one thread's chain of work.
//
// Design: one thread per element for the stream (no reuse between
// elements) and for the clip + noise, whose draws are independent of the
// row's norm: a block holds whole rows (256 / K of them), each thread
// stages its element in shared memory and draws its noise, one barrier,
// the row's first thread sums the row's squares in ascending column order
// (the order and expression of the one-thread-a-row form it replaced, so
// the same bits) and shares the scale, one barrier, each thread scales
// and adds. The noise add (and the draw) is skipped when noise_std == 0,
// so clip = inf with noise 0 returns g bit for bit (−0.0 + 0.0 would be
// +0.0). The scale keeps NaN where the reference's minimum does.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kM1 = 0x21F0AAADu;      // lowbias32 mixing constants
constexpr uint32_t kM2 = 0x735A2D97u;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kStride = 2u * 256u;    // 2·KMAX counters per message row
constexpr float kTwoPi = 6.2831855f;       // fp32(2π)
constexpr float kInv24 = 5.9604645e-08f;   // 2^-24
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 15;
  x *= kM2;
  x ^= x >> 15;
  return x;
}

__device__ __forceinline__ void counter_words(uint32_t seed, uint32_t rid, uint32_t col,
                                              uint32_t& h1, uint32_t& h2) {
  const uint32_t s = mix32(seed);
  const uint32_t s_row = mix32(s ^ ((rid >> 23) * kGolden + 1u));
  const uint32_t base = (rid & 0x7FFFFFu) * kStride + col * 2u;
  h1 = mix32(base ^ s_row);
  h2 = mix32((base + 1u) ^ (s_row * kGolden));
}

__device__ __forceinline__ float gauss_counter(uint32_t seed, uint32_t rid, uint32_t col) {
  uint32_t h1, h2;
  counter_words(seed, rid, col, h1, h2);
  const float u1 = static_cast<float>((h1 >> 8) + 1u) * kInv24;
  const float u2 = static_cast<float>(h2 >> 8) * kInv24;
  return __fmul_rn(sqrtf(-2.f * logf(u1)), cosf(__fmul_rn(kTwoPi, u2)));
}

__global__ void __launch_bounds__(kThreads)
gauss_counter_kernel(const int32_t* __restrict__ rid, float* __restrict__ out, int N,
                     int n_cols, uint32_t seed) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<int64_t>(N) * n_cols) return;
  const int row = static_cast<int>(i / n_cols), col = static_cast<int>(i % n_cols);
  out[i] = gauss_counter(seed, static_cast<uint32_t>(rid[row]), static_cast<uint32_t>(col));
}

__global__ void __launch_bounds__(kThreads)
counter_words_kernel(const int32_t* __restrict__ rid, uint32_t* __restrict__ h1,
                     uint32_t* __restrict__ h2, int N, int n_cols, uint32_t seed) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<int64_t>(N) * n_cols) return;
  const int row = static_cast<int>(i / n_cols), col = static_cast<int>(i % n_cols);
  counter_words(seed, static_cast<uint32_t>(rid[row]), static_cast<uint32_t>(col), h1[i], h2[i]);
}

__global__ void __launch_bounds__(kThreads)
dp_clip_noise_kernel(const float* __restrict__ g, const int32_t* __restrict__ rid,
                     float* __restrict__ out, int B, int K, int rows_per_block, uint32_t seed,
                     float clip, float noise_std) {
  __shared__ float s_g[kThreads];
  __shared__ float s_scale[kThreads];
  const int b0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, B - b0);
  const int t = threadIdx.x;
  const int lr = t / K, c = t - lr * K;   // row within the block, column
  const bool live = lr < rows;
  const int64_t i = static_cast<int64_t>(b0) * K + t;
  float x = 0.f, z = 0.f;
  if (live) {
    x = g[i];
    s_g[t] = x;
    if (noise_std != 0.f)
      z = gauss_counter(seed, static_cast<uint32_t>(rid[b0 + lr]), static_cast<uint32_t>(c));
  }
  __syncthreads();
  if (t < rows) {   // thread t: row t's scale
    const float* row = s_g + t * K;
    float ss = 0.f;
    for (int cc = 0; cc < K; ++cc) ss += row[cc] * row[cc];
    const float ratio = clip / sqrtf(ss);             // inf/0 -> scale 1
    s_scale[t] = ratio >= 1.f ? 1.f : ratio;          // NaN stays NaN
  }
  __syncthreads();
  if (live) {
    float v = __fmul_rn(x, s_scale[lr]);
    if (noise_std != 0.f) v = __fadd_rn(v, __fmul_rn(noise_std, z));
    out[i] = v;
  }
}

int blocks_for(int64_t n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int gauss_counter_launch(const int32_t* rid, float* out, int N, int n_cols,
                                    uint32_t seed, void* stream) {
  gauss_counter_kernel<<<blocks_for(static_cast<int64_t>(N) * n_cols), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(rid, out, N, n_cols, seed);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int counter_words_launch(const int32_t* rid, uint32_t* h1, uint32_t* h2, int N,
                                    int n_cols, uint32_t seed, void* stream) {
  counter_words_kernel<<<blocks_for(static_cast<int64_t>(N) * n_cols), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(rid, h1, h2, N, n_cols, seed);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dp_clip_noise_launch(const float* g, const int32_t* rid, float* out, int B,
                                    int K, uint32_t seed, float clip, float noise_std,
                                    void* stream) {
  if (K < 1 || K > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_block = kThreads / K;
  dp_clip_noise_kernel<<<(B + rows_per_block - 1) / rows_per_block, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(g, rid, out, B, K, rows_per_block,
                                                              seed, clip, noise_std);
  return static_cast<int>(cudaGetLastError());
}
