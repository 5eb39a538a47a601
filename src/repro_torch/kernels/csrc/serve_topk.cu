// Geo-pruned serving over pre-gathered candidate windows: per request,
// scores u·v over the window, pad (cand < 0) and seen masking, and the
// running top-k that carries global item ids.
//
// Replaces the TPU kernel `_serve_topk_window_kernel`
// (src/repro/kernels/serve_topk.py:122, pallas_call at :162).
//
// Bound at the serving slice's shapes (R=64 requests, Cw=384 candidates,
// K=10, k=10): memory. A launch reads U (2.5 KB), the windows (983 KB),
// cand (98 KB) and seen (25 KB) and writes 5 KB: about 1.1 MB, 0.33 us at
// 3.35 TB/s. It does 2·R·Cw·K = 0.49 MFLOP, nothing at 67 TFLOP/s fp32.
// So the launch itself costs more than the work; this kernel is kept
// simple and right, not fast.
//
// Design: one block per request. Each thread scores a strided share of
// the window (fp32, sequential over K), keeps its own top-16 in
// registers, and the block merges the lists in k rounds on the
// (score, id) pair (topk.cuh). The TPU layout changes (K-major transpose,
// 128-lane padding) are not needed: the window stays (R, Cw, K).
#include "topk.cuh"

namespace {

constexpr int kServeThreads = 128;

__global__ void __launch_bounds__(kServeThreads)
serve_topk_window_kernel(const float* __restrict__ U, const float* __restrict__ Vw,
                         const int* __restrict__ cand, const int8_t* __restrict__ seen,
                         float* __restrict__ vals, int* __restrict__ idx,
                         int Cw, int K, int k) {
  extern __shared__ float s_u[];   // the request's u, K floats
  const int r = blockIdx.x;
  for (int c = threadIdx.x; c < K; c += kServeThreads) s_u[c] = U[(size_t)r * K + c];
  __syncthreads();

  const float* vrow = Vw + (size_t)r * Cw * K;
  const int* crow = cand + (size_t)r * Cw;
  const int8_t* srow = seen + (size_t)r * Cw;
  LocalTopK L;
  L.init();
  for (int c = threadIdx.x; c < Cw; c += kServeThreads) {
    const int id = crow[c];
    if (id < 0 || srow[c] != 0) continue;
    const float* v = vrow + (size_t)c * K;
    float s = 0.f;
    for (int j = 0; j < K; ++j) s += s_u[j] * v[j];
    if (s > NEG_INF_F) L.push(s, id);
  }
  block_merge_topk<kServeThreads>(L, k, vals + (size_t)r * k, idx + (size_t)r * k);
}

}  // namespace

extern "C" int serve_topk_window_launch(const float* U, const float* Vw, const int* cand,
                                        const int8_t* seen, float* vals, int* idx,
                                        int R, int Cw, int K, int k, void* stream) {
  serve_topk_window_kernel<<<R, kServeThreads, K * sizeof(float),
                             static_cast<cudaStream_t>(stream)>>>(
      U, Vw, cand, seen, vals, idx, Cw, K, k);
  return static_cast<int>(cudaGetLastError());
}
