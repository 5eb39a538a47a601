// Shared running top-k for the serving kernels (serve_topk.cu,
// topk_scores.cu): the CUDA counterpart of `_merge_tile_topk` in
// src/repro/kernels/topk_scores.py:23.
//
// The Pallas carry relies on a left-to-right scan over tiles and a
// strictly-greater displacement to give (score descending, item id
// ascending). A block of CUDA threads scans its candidates strided, so
// that order is lost. Here the order is explicit instead: every
// comparison, in each thread's local list and in the block merge, is on
// the (score, id) pair. The result does not depend on which thread saw
// which candidate.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#define TOPK_MAX 16           // k ≤ 16, checked by the wrappers
#define NEG_INF_F (-1e30f)    // dead-slot value, kernels/ref.py NEG_INF

// (va, ia) ranks before (vb, ib): higher score first, lower id on a tie.
__device__ __forceinline__ bool ranks_before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// A thread's private top-TOPK_MAX list, best first, in registers: every
// index below is a compile-time constant after unrolling. Empty entries
// are (-inf, INT_MAX), which every eligible candidate outranks.
struct LocalTopK {
  float v[TOPK_MAX];
  int id[TOPK_MAX];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int s = 0; s < TOPK_MAX; ++s) {
      v[s] = -CUDART_INF_F;
      id[s] = INT_MAX;
    }
  }

  // Insert by bubbling the candidate down the list; the last entry drops.
  __device__ __forceinline__ void push(float cv, int ci) {
    if (!ranks_before(cv, ci, v[TOPK_MAX - 1], id[TOPK_MAX - 1])) return;
#pragma unroll
    for (int s = 0; s < TOPK_MAX; ++s) {
      if (ranks_before(cv, ci, v[s], id[s])) {
        const float tv = v[s];
        const int ti = id[s];
        v[s] = cv;
        id[s] = ci;
        cv = tv;
        ci = ti;
      }
    }
  }

  __device__ __forceinline__ void pop_front() {
#pragma unroll
    for (int s = 0; s < TOPK_MAX - 1; ++s) {
      v[s] = v[s + 1];
      id[s] = id[s + 1];
    }
    v[TOPK_MAX - 1] = -CUDART_INF_F;
    id[TOPK_MAX - 1] = INT_MAX;
  }
};

// Arg-best across a warp on (score, id, thread); the thread index only
// separates exact duplicates, so exactly one thread wins.
__device__ __forceinline__ void warp_best(float& bv, int& bi, int& bt) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    const int ot = __shfl_xor_sync(0xffffffffu, bt, off);
    if (ranks_before(ov, oi, bv, bi) || (ov == bv && oi == bi && ot < bt)) {
      bv = ov;
      bi = oi;
      bt = ot;
    }
  }
}

// k rounds of block-wide extract-best over the threads' list heads; the
// winner pops its head. Thread 0 writes slot s of (out_v, out_i); a round
// whose best is not eligible writes the dead slot (NEG_INF, -1).
template <int THREADS>
__device__ void block_merge_topk(LocalTopK& L, int k, float* out_v, int* out_i) {
  constexpr int WARPS = THREADS / 32;
  static_assert(THREADS % 32 == 0 && WARPS <= 32, "block is whole warps");
  __shared__ float s_v[WARPS];
  __shared__ int s_i[WARPS];
  __shared__ int s_t[WARPS];
  __shared__ int s_winner;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int slot = 0; slot < k; ++slot) {
    float bv = L.v[0];
    int bi = L.id[0];
    int bt = tid;
    warp_best(bv, bi, bt);
    if (lane == 0) {
      s_v[warp] = bv;
      s_i[warp] = bi;
      s_t[warp] = bt;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < WARPS ? s_v[lane] : -CUDART_INF_F;
      bi = lane < WARPS ? s_i[lane] : INT_MAX;
      bt = lane < WARPS ? s_t[lane] : INT_MAX;
      warp_best(bv, bi, bt);
      if (lane == 0) {
        const bool live = bv > NEG_INF_F;
        out_v[slot] = live ? bv : NEG_INF_F;
        out_i[slot] = live ? bi : -1;
        s_winner = live ? bt : -1;
      }
    }
    __syncthreads();
    if (tid == s_winner) L.pop_front();
  }
}
