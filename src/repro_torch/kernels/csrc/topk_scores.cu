// Dense per-user serving: per request, scores over all J items with the
// user's own item factors v^i = p^i + q^i, the train mask, and the
// running top-k.
//
// Replaces the TPU kernel `_topk_peruser_kernel` with its
// `_merge_tile_topk` carry (src/repro/kernels/topk_scores.py:68 and :23,
// pallas_call at :132).
//
// Bound at the serving slice's shapes (R=64, J=3197, K=10, k=10): memory.
// A launch reads the V rows (8.2 MB), U (2.5 KB) and the mask (205 KB)
// and writes 5 KB: about 8.4 MB, 2.5 us at 3.35 TB/s. It does
// 2·R·J·K = 4.1 MFLOP, 0.06 us at 67 TFLOP/s fp32. Memory and the launch
// bound it; this kernel is kept simple and right, not fast.
//
// Design: one block per request, each thread a strided share of the J
// columns, a register top-16 per thread, and the (score, id) block merge
// of topk.cuh. The ragged edge is the loop bound: no column ≥ J is read,
// where the TPU wrapper padded J to 128 and masked the pad
// (src/repro/kernels/ops.py:267-269).
#include "topk.cuh"

namespace {

constexpr int kDenseThreads = 256;

__global__ void __launch_bounds__(kDenseThreads)
topk_peruser_kernel(const float* __restrict__ U, const float* __restrict__ V,
                    const int8_t* __restrict__ mask, float* __restrict__ vals,
                    int* __restrict__ idx, int J, int K, int k) {
  extern __shared__ float s_u[];   // the request's u, K floats
  const int r = blockIdx.x;
  for (int c = threadIdx.x; c < K; c += kDenseThreads) s_u[c] = U[(size_t)r * K + c];
  __syncthreads();

  const float* vrow = V + (size_t)r * J * K;
  const int8_t* mrow = mask + (size_t)r * J;
  LocalTopK L;
  L.init();
  for (int j = threadIdx.x; j < J; j += kDenseThreads) {
    if (mrow[j] != 0) continue;
    const float* v = vrow + (size_t)j * K;
    float s = 0.f;
    for (int c = 0; c < K; ++c) s += s_u[c] * v[c];
    if (s > NEG_INF_F) L.push(s, j);
  }
  block_merge_topk<kDenseThreads>(L, k, vals + (size_t)r * k, idx + (size_t)r * k);
}

}  // namespace

extern "C" int topk_peruser_launch(const float* U, const float* V, const int8_t* mask,
                                   float* vals, int* idx, int R, int J, int K, int k,
                                   void* stream) {
  topk_peruser_kernel<<<R, kDenseThreads, K * sizeof(float),
                        static_cast<cudaStream_t>(stream)>>>(U, V, mask, vals, idx, J, K, k);
  return static_cast<int>(cudaGetLastError());
}
