// The DP mechanism's counter-keyed Gaussian stream and the standalone
// clip + noise kernel over a block of outgoing gradient messages:
//
//   out = g · min(1, C / ‖g‖₂) + noise_std · z(seed, rid, col)
//
// Replaces the TPU kernel `_dp_clip_noise_kernel`
// (src/repro/kernels/dp_noise.py:98, pallas_call at :131) and its stream
// `gauss_counter` (dp_noise.py:56-83).
//
// The stream is a spec: `gauss_counter` below, with the parts it
// composes, is its one CUDA definition, word for word the reference's.
// Counters (rid mod 2^23)·512 + 2·col and +1 (the stride is 2·KMAX = 512,
// KMAX = 256, not 2·K) feed the lowbias32 hash; the high rid bits
// (rid >> 23) fold into a per-row key through the golden-ratio constant;
// u1 = ((h1 >> 8) + 1)·2^-24 in (0, 1], u2 = (h2 >> 8)·2^-24 in [0, 1);
// z = sqrt(−2 ln u1)·cos(2π·u2) with 2π rounded to fp32 first, as the
// reference's fp32 product does. No fast math: logf/cosf/sqrtf are the
// accurate library calls.
//
// Bound at the training slice's shapes: memory, and the launch.
// `gauss_counter_launch` writes the epoch's (28,160 × 10) block: 1.1 MB
// out, 113 KB of rids in, 0.37 us at 3.35 TB/s; its 281,600 draws at ~60
// operations each (two hash words, log, cos, sqrt) are ~17 MOP, 0.25 us at
// 67 TOP/s. In instructions a draw is one to two hundred (accurate logf,
// cosf and sqrtf are library sequences), so issuing them takes 1-2 us on
// 132 SMs: the stream is bound by its instructions and the launch.
// `dp_clip_noise_launch` at B=256, K=10 moves 21 KB (6 ns): its time is
// the launch and one thread's chain of work.
//
// Design of the stream (`stream_kernel`): a thread draws two neighbouring
// columns of one row (one column for odd n_cols), a block is whole rows
// (rows of n_cols / 2 threads, at most 128 threads), the grid every row:
// at the epoch's block that is 1,127 blocks, within one wave of the SMs.
// The seed's key is hashed once on the host, a row's key and counter base
// once a thread: no element pays for the seed's hash, and at most half of
// one for the row's. The thread's row and columns are its block and
// thread indices, so no thread divides; a warp's two-column stores cover
// one contiguous run. The hash words and the draw are the functions below,
// the same that `counter_words` and `gauss_counter` compose, so every
// draw equals the one-thread-an-element form bit for bit. At the epoch's
// block there is about one element for each thread an H100 holds at once,
// so a row's key in shared memory behind a barrier, shared by threads
// stepping over a pass of rows, was slower than the form it replaced
// (PERF.md §6): the barrier and the threads with a second element
// cost more than the hashes they saved.
//
// Design of the clip + noise kernel: one thread per element, whose draw
// is independent of the row's norm: a block holds whole rows (256 / K of
// them), each thread stages its element in shared memory and draws its
// noise, one barrier, the row's first thread sums the row's squares in
// ascending column order (the order and expression of the one-thread-a-row
// form it replaced, so the same bits) and shares the scale, one barrier,
// each thread scales and adds. The noise add (and the draw) is skipped
// when noise_std == 0, so clip = inf with noise 0 returns g bit for bit
// (−0.0 + 0.0 would be +0.0). The scale keeps NaN where the reference's
// minimum does.
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

__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 15;
  x *= kM2;
  x ^= x >> 15;
  return x;
}

// The stream in its parts: the seed's key, a row's key and counter base,
// a column's two hash words, and the draw from them. The parts that do not
// depend on the column are hoisted out of the stream kernel's loop.
__host__ __device__ __forceinline__ uint32_t seed_key(uint32_t seed) { return mix32(seed); }

__device__ __forceinline__ uint32_t row_key(uint32_t s, uint32_t rid) {
  return mix32(s ^ ((rid >> 23) * kGolden + 1u));
}

__device__ __forceinline__ uint32_t row_base(uint32_t rid) { return (rid & 0x7FFFFFu) * kStride; }

__device__ __forceinline__ void words_at(uint32_t s_row, uint32_t base_row, uint32_t col,
                                         uint32_t& h1, uint32_t& h2) {
  const uint32_t base = base_row + col * 2u;
  h1 = mix32(base ^ s_row);
  h2 = mix32((base + 1u) ^ (s_row * kGolden));
}

__device__ __forceinline__ float draw(uint32_t h1, uint32_t h2) {
  const float u1 = static_cast<float>((h1 >> 8) + 1u) * kInv24;
  const float u2 = static_cast<float>(h2 >> 8) * kInv24;
  return __fmul_rn(sqrtf(-2.f * logf(u1)), cosf(__fmul_rn(kTwoPi, u2)));
}

__device__ __forceinline__ void counter_words(uint32_t seed, uint32_t rid, uint32_t col,
                                              uint32_t& h1, uint32_t& h2) {
  words_at(row_key(seed_key(seed), rid), row_base(rid), col, h1, h2);
}

__device__ __forceinline__ float gauss_counter(uint32_t seed, uint32_t rid, uint32_t col) {
  uint32_t h1, h2;
  counter_words(seed, rid, col, h1, h2);
  return draw(h1, h2);
}

// The stream kernel: blockDim = (n_cols / kPer, rows a block), thread
// (x, y) draws columns kPer·x .. kPer·x + kPer - 1 of row
// blockIdx.x·blockDim.y + y. kPer = 2 for even n_cols (one
// 8-byte store), else 1. kWords: write the hash words (the check hook),
// else the draws. s = seed_key(seed).
template <bool kWords, int kPer>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const int32_t* __restrict__ rid, float* __restrict__ out,
              uint32_t* __restrict__ h1o, uint32_t* __restrict__ h2o, int N, int n_cols,
              uint32_t s) {
  const int col = kPer * threadIdx.x;
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= N) return;
  const uint32_t r = static_cast<uint32_t>(__ldg(rid + row));
  const uint32_t key = row_key(s, r), base = row_base(r);
  const int64_t o = static_cast<int64_t>(row) * n_cols + col;
  uint32_t h1[kPer], h2[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) words_at(key, base, static_cast<uint32_t>(col + c), h1[c], h2[c]);
  if constexpr (kWords) {
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      h1o[o + c] = h1[c];
      h2o[o + c] = h2[c];
    }
  } else if constexpr (kPer == 2) {
    *reinterpret_cast<float2*>(out + o) = make_float2(draw(h1[0], h2[0]), draw(h1[1], h2[1]));
  } else {
    out[o] = draw(h1[0], h2[0]);
  }
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

template <bool kWords, int kPer>
void start_stream(const int32_t* rid, float* out, uint32_t* h1, uint32_t* h2, int N, int n_cols,
                  uint32_t seed, int rows, cudaStream_t stream) {
  stream_kernel<kWords, kPer><<<(N + rows - 1) / rows, dim3(n_cols / kPer, rows), 0, stream>>>(
      rid, out, h1, h2, N, n_cols, seed_key(seed));
}

// per (columns a thread: 2 for even n_cols, else 1) and rows a block: the
// wrapper's `stream_layout`; the grid covers every row. A layout the
// kernel cannot run is refused before any launch.
template <bool kWords>
int stream_launch(const int32_t* rid, float* out, uint32_t* h1, uint32_t* h2, int N, int n_cols,
                  uint32_t seed, int per, int rows, cudaStream_t stream) {
  if (N < 1 || n_cols < 1 || n_cols > kThreads || (per != 1 && per != 2) || n_cols % per ||
      rows < 1 || n_cols / per * rows > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (per == 2) start_stream<kWords, 2>(rid, out, h1, h2, N, n_cols, seed, rows, stream);
  else start_stream<kWords, 1>(rid, out, h1, h2, N, n_cols, seed, rows, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gauss_counter_launch(const int32_t* rid, float* out, int N, int n_cols,
                                    uint32_t seed, int per, int rows, void* stream) {
  return stream_launch<false>(rid, out, nullptr, nullptr, N, n_cols, seed, per, rows,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int counter_words_launch(const int32_t* rid, uint32_t* h1, uint32_t* h2, int N,
                                    int n_cols, uint32_t seed, int per, int rows, void* stream) {
  return stream_launch<true>(rid, nullptr, h1, h2, N, n_cols, seed, per, rows,
                             static_cast<cudaStream_t>(stream));
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
