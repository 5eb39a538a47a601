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
// nothing at 67 TFLOP/s fp32. So the launch and the chain of dependent
// loads set the time: u and the candidate ids, then the rows, then the
// merge.
//
// Design: `warps` warps per request, chosen by the wrapper from Cw (one
// for Cw ≤ 128, with several requests a block; ceil(Cw / 128) above, so a
// lane scores at most 4 candidates at the main shapes). A lane holds u in
// registers (K = 8 and 10, the slices' widths, are fixed at build time;
// other K read u and the row in place), scores its strided candidates
// four at a time (in a window the four ids, seen bits and rows at once; in
// a slab the ids, then the seen bits and rows; each row one contiguous run
// of 16- or 8-byte loads where the rows are aligned, all issued before the
// chains), and keeps a 4-, 8- or 16-slot list. A warp merges its lanes'
// lists by the bitonic network of topk.cuh with no barrier, and a request
// of several warps takes one barrier. The TPU layout changes
// (K-major transpose, 128-lane padding) are not needed: windows stay
// (R, Cw, K), slabs (R, J, K).
//
// Bit-for-bit contracts, carried from the reference (serve_topk.py:42-46,
// ops.py:228-230):
// - the score is the same ascending-K fp32 FMA chain from 0.0f in every
//   form and layout, so the slab form equals the window form on windows
//   gathered from the same rows, and the fp32 window form equals the
//   kernel of the earlier one-block-a-request design;
// - a quantized factor is dequantized as __fmul_rn(code, scale), rounded
//   on its own before the chain, so the quant form on (codes, scale)
//   equals the fp32 window form on codes.float() * scale.
#include <cuda_bf16.h>

#include "topk.cuh"

namespace {

constexpr int kMaxThreads = 512;   // 16 warps a block: up to 128 registers a thread
constexpr int kBatch = 4;          // candidates a lane loads before it scores them

__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Each form gives `row(r)`, a view of request r with `seen(c, id)`,
// `load<KC>(c, id, f)` (the row's KC factors into registers) and
// `score(u, c, id, K)` (K at run time), for candidate slot c holding item
// id >= 0. kBySlot: the seen bit and the row are found by the slot alone
// (a window), so they load beside the id.
struct WindowF32 {
  const float* Vw;
  const int8_t* seen_w;
  int Cw, K, vec;
  struct Row {
    const float* v;
    const int8_t* s;
    int K, vec;
    static constexpr bool kBySlot = true;
    __device__ __forceinline__ bool seen(int c, int) const { return s[c] != 0; }
    __device__ __forceinline__ const float* at(int c, int) const { return v + (size_t)c * K; }
    template <int KC>
    __device__ __forceinline__ void load(int c, int id, float (&f)[KC]) const {
      load_row<KC>(at(c, id), f, vec);
    }
    __device__ __forceinline__ float score(const float* u, int c, int id, int K_) const {
      return dot_chain(u, at(c, id), K_);
    }
  };
  __device__ __forceinline__ Row row(int r) const {
    return {Vw + (size_t)r * Cw * K, seen_w + (size_t)r * Cw, K, vec};
  }
};

// 64-bit offsets throughout: R·J·K passes 2^31 at modest R. An id past
// the slab (id >= J) is treated as seen: never a candidate, nothing read.
struct Slab {
  const float* V;
  const int8_t* seen_j;
  int J, K, vec;
  struct Row {
    const float* v;
    const int8_t* s;
    int J, K, vec;
    static constexpr bool kBySlot = false;
    __device__ __forceinline__ bool seen(int, int id) const {
      return id < 0 || id >= J || s[id] != 0;
    }
    __device__ __forceinline__ const float* at(int, int id) const { return v + (size_t)id * K; }
    template <int KC>
    __device__ __forceinline__ void load(int c, int id, float (&f)[KC]) const {
      load_row<KC>(at(c, id), f, vec);
    }
    __device__ __forceinline__ float score(const float* u, int c, int id, int K_) const {
      return dot_chain(u, at(c, id), K_);
    }
  };
  __device__ __forceinline__ Row row(int r) const {
    return {V + (size_t)r * J * K, seen_j + (size_t)r * J, J, K, vec};
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
    static constexpr bool kBySlot = true;
    __device__ __forceinline__ bool seen(int c, int) const { return s[c] != 0; }
    __device__ __forceinline__ float factor(int c, int j) const {
      return __fmul_rn(to_float(v[(size_t)c * K + j]), scale);
    }
    template <int KC>
    __device__ __forceinline__ void load(int c, int, float (&f)[KC]) const {
#pragma unroll
      for (int j = 0; j < KC; ++j) f[j] = factor(c, j);
    }
    __device__ __forceinline__ float score(const float* u, int c, int, int K_) const {
      float s = 0.f;
      for (int j = 0; j < K_; ++j) s = __fmaf_rn(__ldg(u + j), factor(c, j), s);
      return s;
    }
  };
  __device__ __forceinline__ Row row(int r) const {
    return {Vq + (size_t)r * Cw * K, seen_w + (size_t)r * Cw, scale[r], K};
  }
};

// blockDim.x = 32 · warps · (requests a block); request r = blockIdx.x ·
// (requests a block) + q. merge = 0 scores without merging (a timing
// form: each request's first warp writes its lanes' list checksums).
template <int SLOTS, int KC, typename Src>
__global__ void __launch_bounds__(kMaxThreads)
serve_topk_kernel(const float* __restrict__ U, const Src src, const int* __restrict__ cand,
                  float* __restrict__ vals, int* __restrict__ idx, int R, int Cw, int K, int k,
                  int warps, int merge) {
  __shared__ MergeScratch sm;
  const int per_request = 32 * warps;
  const int q = threadIdx.x / per_request;
  const int t = threadIdx.x - q * per_request;
  const int r = blockIdx.x * (blockDim.x / per_request) + q;
  const bool live = r < R;

  LaneTopK<SLOTS> L;
  L.init();
  if (live) {
    const typename Src::Row row = src.row(r);
    const int* crow = cand + (size_t)r * Cw;
    const float* u = U + (size_t)r * K;
    if constexpr (KC > 0) {
      float ur[KC];
#pragma unroll
      for (int j = 0; j < KC; ++j) ur[j] = __ldg(u + j);
      // kBatch of the lane's candidates at a time, all their loads issued
      // before any is used: in a window the ids, seen bits and rows at once
      // (a pad slot's row is read and dropped); in a slab the ids, then the
      // seen bits and rows at the valid ids.
      for (int c0 = t; c0 < Cw; c0 += kBatch * per_request) {
        int id[kBatch];
        bool ok[kBatch];
        float f[kBatch][KC];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int c = c0 + b * per_request;
          id[b] = c < Cw ? crow[c] : -1;
          if constexpr (Src::Row::kBySlot) {
            ok[b] = c < Cw && !row.seen(c, 0);
            if (c < Cw) row.template load<KC>(c, 0, f[b]);
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if constexpr (Src::Row::kBySlot) {
            ok[b] = ok[b] && id[b] >= 0;
          } else {
            ok[b] = !row.seen(c0 + b * per_request, id[b]);
            if (ok[b]) row.template load<KC>(c0 + b * per_request, id[b], f[b]);
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (!ok[b]) continue;
          const float s = dot_chain(ur, f[b]);
          if (s > NEG_INF_F) L.push(s, id[b]);
        }
      }
    } else {
      for (int c = t; c < Cw; c += per_request) {
        const int id = crow[c];
        if (id < 0 || row.seen(c, id)) continue;
        const float s = row.score(u, c, id, K);
        if (s > NEG_INF_F) L.push(s, id);
      }
    }
  }
  float* out_v = live ? vals + (size_t)r * k : nullptr;
  int* out_i = live ? idx + (size_t)r * k : nullptr;
  if (!merge) {
    if (live && t < k) {
      out_v[t] = L.checksum();
      out_i[t] = L.head_id();
    }
    return;
  }
  merge_request(L, k, warps, t >> 5, q * warps, sm, out_v, out_i);
}

struct Launch {
  const float* U;
  const int* cand;
  float* vals;
  int* idx;
  int R, Cw, K, k, warps, rpb, slots, merge;
  cudaStream_t stream;
};

template <int SLOTS, int KC, typename Src>
void start(const Launch& a, const Src& src) {
  const int grid = (a.R + a.rpb - 1) / a.rpb;
  serve_topk_kernel<SLOTS, KC, Src><<<grid, 32 * a.warps * a.rpb, 0, a.stream>>>(
      a.U, src, a.cand, a.vals, a.idx, a.R, a.Cw, a.K, a.k, a.warps, a.merge);
}

template <int KC, typename Src>
void start_slots(const Launch& a, const Src& src) {
  if (a.slots == 4) start<4, KC>(a, src);
  else if (a.slots == 8) start<8, KC>(a, src);
  else start<16, KC>(a, src);
}

// A layout the kernel cannot run (a block past 512 threads, lane lists
// too short for k) is refused before any launch.
template <typename Src>
int launch(const Launch& a, const Src& src) {
  const int per_lane = a.warps > 0 ? (a.Cw + 32 * a.warps - 1) / (32 * a.warps) : 0;
  if (a.warps < 1 || a.rpb < 1 || 32 * a.warps * a.rpb > kMaxThreads || a.k < 1 || a.k > TOPK_MAX ||
      !slots_fit(a.slots, a.k, per_lane))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.K == 10) start_slots<10>(a, src);
  else if (a.K == 8) start_slots<8>(a, src);
  else start_slots<0>(a, src);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int serve_topk_window_launch(const float* U, const float* Vw, const int* cand,
                                        const int8_t* seen, float* vals, int* idx, int R,
                                        int Cw, int K, int k, int warps, int rpb, int slots,
                                        int merge, void* stream) {
  const Launch a{U, cand, vals, idx, R, Cw, K, k, warps, rpb, slots, merge,
                 static_cast<cudaStream_t>(stream)};
  return launch(a, WindowF32{Vw, seen, Cw, K, row_vec(Vw, K)});
}

extern "C" int serve_topk_launch(const float* U, const float* V, const int* cand,
                                 const int8_t* seen, float* vals, int* idx, int R, int J, int Cw,
                                 int K, int k, int warps, int rpb, int slots, int merge,
                                 void* stream) {
  const Launch a{U, cand, vals, idx, R, Cw, K, k, warps, rpb, slots, merge,
                 static_cast<cudaStream_t>(stream)};
  return launch(a, Slab{V, seen, J, K, row_vec(V, K)});
}

// bf16 != 0: Vq holds bf16 factors, else int8 codes.
extern "C" int serve_topk_window_quant_launch(const float* U, const void* Vq,
                                              const float* scale, const int* cand,
                                              const int8_t* seen, float* vals, int* idx, int R,
                                              int Cw, int K, int k, int bf16, int warps, int rpb,
                                              int slots, int merge, void* stream) {
  const Launch a{U, cand, vals, idx, R, Cw, K, k, warps, rpb, slots, merge,
                 static_cast<cudaStream_t>(stream)};
  if (bf16)
    return launch(a, WindowQuant<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(Vq), scale,
                                                seen, Cw, K});
  return launch(a, WindowQuant<int8_t>{static_cast<const int8_t*>(Vq), scale, seen, Cw, K});
}
