// Dense top-k serving, two forms.
//
// Per-user (kernel 2): per request, scores over all J items with the
// user's own item factors v^i = p^i + q^i, the train mask, and the
// running top-k. Replaces the TPU kernel `_topk_peruser_kernel` with its
// `_merge_tile_topk` carry (src/repro/kernels/topk_scores.py:68 and :23,
// pallas_call at :132).
//
// Shared V (kernel 4): every user scores the same (J, K) item matrix, the
// serving and evaluation shape of the centralized MF/BPR baselines, and of
// one DMF request served alone. Replaces `_topk_kernel`
// (src/repro/kernels/topk_scores.py:51, pallas_call at :100).
//
// Bound at the serving slice's shapes (R=64, J=3197, K=10, k=10): memory.
// A per-user launch reads the V rows (8.2 MB), U (2.5 KB) and the mask
// (205 KB) and writes 5 KB: about 8.4 MB, 2.5 us at 3.35 TB/s. It does
// 2·R·J·K = 4.1 MFLOP, 0.06 us at 67 TFLOP/s fp32. Memory and the launch
// bound it; this kernel is kept simple and right, not fast. The shared-V
// form at the baselines' shape (R=6,524, J=3,197, K=10) reads the mask
// (20.9 MB), V once (128 KB) and U: 6.5 us at 3.35 TB/s against 417 MFLOP,
// 6.2 us; every block reads all of V, which stays in the 50 MB L2, so the
// mask and the k merge rounds per user bound it.
//
// Design: one block per request, each thread a strided share of the J
// columns, a register top-16 per thread, and the (score, id) block merge
// of topk.cuh. The ragged edge is the loop bound: no column ≥ J is read,
// where the TPU wrappers padded J to 128 or 256 and masked the pad
// (src/repro/kernels/ops.py:146-152, 267-269). The two forms differ only in
// the item row's address (the shared V has no per-user stride) and keep the
// same per-item dot order, sequential over K, so kernel 4 on one user with
// V = p^i + q^i gives kernel 2's bits on that row.
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

__global__ void __launch_bounds__(kDenseThreads)
topk_shared_kernel(const float* __restrict__ U, const float* __restrict__ V,
                   const int8_t* __restrict__ mask, float* __restrict__ vals,
                   int* __restrict__ idx, int J, int K, int k) {
  extern __shared__ float s_u[];   // the request's u, K floats
  const int r = blockIdx.x;
  for (int c = threadIdx.x; c < K; c += kDenseThreads) s_u[c] = U[(size_t)r * K + c];
  __syncthreads();

  const int8_t* mrow = mask + (size_t)r * J;
  LocalTopK L;
  L.init();
  for (int j = threadIdx.x; j < J; j += kDenseThreads) {
    if (mrow[j] != 0) continue;
    const float* v = V + (size_t)j * K;
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

extern "C" int topk_shared_launch(const float* U, const float* V, const int8_t* mask,
                                  float* vals, int* idx, int R, int J, int K, int k,
                                  void* stream) {
  topk_shared_kernel<<<R, kDenseThreads, K * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(U, V, mask, vals, idx, J, K, k);
  return static_cast<int>(cudaGetLastError());
}
