// Geo-pruned serving: per request, scores u·v over its candidate ids, pad
// (cand < 0) and seen masking, and the running top-k that carries global
// item ids. One kernel body, instantiated for three ways of reading a
// candidate's seen bit and K factors:
//
//   WindowF32        pre-gathered fp32 windows (R, Cw, K), seen (R, Cw).
//                    Replaces `_serve_topk_window_kernel`
//                    (src/repro/kernels/serve_topk.py:122, pallas_call :162).
//   Slab             whole per-request item slabs (R, J, K), seen (R, J);
//                    the candidates are gathered inside the kernel.
//                    Replaces `_serve_topk_kernel` (serve_topk.py:64,
//                    pallas_call :100).
//   WindowQuant<T>   windows stored as int8 codes times a per-request f32
//                    scale, or as bf16 (scale 1). Replaces
//                    `_serve_topk_window_quant_kernel` (serve_topk.py:184,
//                    pallas_call :227); int8 and bf16 are two
//                    instantiations of one template.
//
// Bound: memory, and below that the launch. At the serving slice's shapes
// (R=64, Cw=384, K=10) a window launch moves at most about 1.1 MB (every
// slot live), 0.33 us at 3.35 TB/s; the slab form reads the same candidate
// rows out of the slab. At the million-user shape (R=128, Cw=128, K=8) the
// int8 form moves at most about 0.23 MB and bf16 0.36 MB (0.07 and
// 0.11 us). A form does 2 (fp32) or 3 (dequantizing) flops per factor,
// nothing at 67 TFLOP/s fp32. So the launch costs more than the work; the
// kernel is kept simple and right, not fast.
//
// Design: one block per request. Each thread scores a strided share of
// the candidates (fp32, sequential over K), keeps its own top-16 in
// registers, and the block merges the lists in k rounds on the
// (score, id) pair (topk.cuh). The TPU layout changes (K-major transpose,
// 128-lane padding) are not needed: windows stay (R, Cw, K), slabs
// (R, J, K).
//
// Bit-for-bit contracts, carried from the reference (serve_topk.py:42-46,
// ops.py:228-230):
// - the score loop is the same fused multiply-add chain in every form, so
//   the slab form equals the window form on windows gathered from the
//   same rows, and the fp32 window form is the kernel as it was before the
//   template;
// - a quantized factor is dequantized as __fmul_rn(code, scale), rounded
//   on its own before the chain, so the quant form on (codes, scale)
//   equals the fp32 window form on codes.float() * scale.
#include <cuda_bf16.h>

#include "topk.cuh"

namespace {

constexpr int kServeThreads = 128;

__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Each form gives `row(r)`, a view of request r with `seen(c, id)` and
// `factor(c, id, j)` for candidate slot c holding item id >= 0.
struct WindowF32 {
  const float* Vw;
  const int8_t* seen_w;
  int Cw, K;
  struct Row {
    const float* v;
    const int8_t* s;
    int K;
    __device__ __forceinline__ bool seen(int c, int) const { return s[c] != 0; }
    __device__ __forceinline__ float factor(int c, int, int j) const {
      return v[(size_t)c * K + j];
    }
  };
  __device__ __forceinline__ Row row(int r) const {
    return {Vw + (size_t)r * Cw * K, seen_w + (size_t)r * Cw, K};
  }
};

// 64-bit offsets throughout: R·J·K passes 2^31 at modest R. An id past
// the slab (id >= J) is treated as seen: never a candidate, nothing read.
struct Slab {
  const float* V;
  const int8_t* seen_j;
  int J, K;
  struct Row {
    const float* v;
    const int8_t* s;
    int J, K;
    __device__ __forceinline__ bool seen(int, int id) const { return id >= J || s[id] != 0; }
    __device__ __forceinline__ float factor(int, int id, int j) const {
      return v[(size_t)id * K + j];
    }
  };
  __device__ __forceinline__ Row row(int r) const {
    return {V + (size_t)r * J * K, seen_j + (size_t)r * J, J, K};
  }
};

template <typename T>
struct WindowQuant {
  const T* Vq;
  const float* scale;
  const int8_t* seen_w;
  int Cw, K;
  struct Row {
    const T* v;
    const int8_t* s;
    float scale;
    int K;
    __device__ __forceinline__ bool seen(int c, int) const { return s[c] != 0; }
    __device__ __forceinline__ float factor(int c, int, int j) const {
      return __fmul_rn(to_float(v[(size_t)c * K + j]), scale);
    }
  };
  __device__ __forceinline__ Row row(int r) const {
    return {Vq + (size_t)r * Cw * K, seen_w + (size_t)r * Cw, scale[r], K};
  }
};

template <typename Src>
__global__ void __launch_bounds__(kServeThreads)
serve_topk_kernel(const float* __restrict__ U, const Src src, const int* __restrict__ cand,
                  float* __restrict__ vals, int* __restrict__ idx, int Cw, int K, int k) {
  extern __shared__ float s_u[];   // the request's u, K floats
  const int r = blockIdx.x;
  for (int c = threadIdx.x; c < K; c += kServeThreads) s_u[c] = U[(size_t)r * K + c];
  __syncthreads();

  const typename Src::Row row = src.row(r);
  const int* crow = cand + (size_t)r * Cw;
  LocalTopK L;
  L.init();
  for (int c = threadIdx.x; c < Cw; c += kServeThreads) {
    const int id = crow[c];
    if (id < 0 || row.seen(c, id)) continue;   // a pad slot reads nothing
    float s = 0.f;
    for (int j = 0; j < K; ++j) s += s_u[j] * row.factor(c, id, j);
    if (s > NEG_INF_F) L.push(s, id);
  }
  block_merge_topk<kServeThreads>(L, k, vals + (size_t)r * k, idx + (size_t)r * k);
}

template <typename Src>
int launch(const float* U, const Src& src, const int* cand, float* vals, int* idx, int R,
           int Cw, int K, int k, void* stream) {
  serve_topk_kernel<Src><<<R, kServeThreads, K * sizeof(float),
                           static_cast<cudaStream_t>(stream)>>>(U, src, cand, vals, idx,
                                                                Cw, K, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int serve_topk_window_launch(const float* U, const float* Vw, const int* cand,
                                        const int8_t* seen, float* vals, int* idx,
                                        int R, int Cw, int K, int k, void* stream) {
  return launch(U, WindowF32{Vw, seen, Cw, K}, cand, vals, idx, R, Cw, K, k, stream);
}

extern "C" int serve_topk_launch(const float* U, const float* V, const int* cand,
                                 const int8_t* seen, float* vals, int* idx,
                                 int R, int J, int Cw, int K, int k, void* stream) {
  return launch(U, Slab{V, seen, J, K}, cand, vals, idx, R, Cw, K, k, stream);
}

// bf16 != 0: Vq holds bf16 factors, else int8 codes.
extern "C" int serve_topk_window_quant_launch(const float* U, const void* Vq,
                                              const float* scale, const int* cand,
                                              const int8_t* seen, float* vals, int* idx,
                                              int R, int Cw, int K, int k, int bf16,
                                              void* stream) {
  if (bf16) {
    return launch(U, WindowQuant<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(Vq), scale,
                                               seen, Cw, K},
                  cand, vals, idx, R, Cw, K, k, stream);
  }
  return launch(U, WindowQuant<int8_t>{static_cast<const int8_t*>(Vq), scale, seen, Cw, K},
                cand, vals, idx, R, Cw, K, k, stream);
}
