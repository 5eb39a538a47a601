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
// Kernel 2's bound at the serving slice's shapes (R=64, J=3197, K=10,
// k=10): memory. A launch reads the V rows (8.2 MB), U (2.5 KB) and the
// mask (205 KB) and writes 5 KB: about 8.4 MB, 2.5 us at 3.35 TB/s. It
// does 2·R·J·K = 4.1 MFLOP, 0.06 us at 67 TFLOP/s fp32. Its design: one
// block of 256 threads per request, each thread a strided share of the J
// columns and its own list, merged by the warps of topk.cuh with one
// barrier. Its layout is unchanged since it was ported; only the merge is
// shared with kernels 1 and 4.
//
// Kernel 4's bound at the baselines' shape (R=6,524, J=3,197, K=10): the
// mask (20.9 MB) is 6.2 us at 3.35 TB/s, the 417 MFLOP 6.2 us at
// 67 TFLOP/s. Every user reads every v, so the design keeps V on chip and
// reuses each load for several users. At R=1 (one DMF request served
// alone) the bound is the 128 KB of V, 0.04 us: the launch and the chain
// of dependent loads set the time. The wrapper chooses one of two layouts
// from R (`topk_scores.shared_layout`):
//
//   many users (R at or above one block an SM): persistent blocks of 16
//   warps, one an SM. A block stages V into shared memory K-major, in
//   tiles of J when K·J·4 bytes pass the 227 KB a block can have. A warp
//   scores 2 users at a time, and a lane 4 consecutive items at a time: one
//   16-byte shared load per factor (lanes on consecutive 16 bytes, no bank
//   conflict) feeds the 2 × 4 chains of its register tile (two 16-slot
//   lists and u fit 128 registers; 4 users a warp spilled 2 KB a thread).
//   Each user's 4 mask bytes come as one word, from aligned 4-byte loads
//   and a funnel shift: the rows are J bytes apart, and J=3,197 leaves them
//   unaligned for wider vectors. A candidate below a warp-wide bound of the
//   user's k-th best is no push. The warp then merges each user's k best
//   (no barrier).
//
//   few users: one block per user, its J items in 128-item chunks over up
//   to 16 warps; a warp copies two chunks at a time into its slice of
//   shared memory with coalesced 16-byte loads, beside their mask bytes, and
//   scores 4 items of each chunk a lane (8 a lane at J=3,197); one barrier
//   to merge the warps' lists.
//
// Both forms keep the per-item dot of kernel 2, one ascending-K fp32 FMA
// chain from 0.0f, so kernel 4 on one user with V = p^i + q^i gives kernel
// 2's bits on that row, in either layout. The ragged edge is the loop
// bound: no column ≥ J is read, where the TPU wrappers padded J to 128 or
// 256 and masked the pad (src/repro/kernels/ops.py:146-152, 267-269).
#include "topk.cuh"

namespace {

constexpr int kDenseThreads = 256;   // kernel 2: a block per request
constexpr int kFewMaxThreads = 512;  // kernel 4, few users: a block per user
constexpr int kManyThreads = 512;    // kernel 4, many users: 16 warps a block, one an SM
constexpr int kUsersPerWarp = 2;     // kernel 4, many users: a warp's register tile
constexpr int kMaxSmem = 232448;     // dynamic shared memory a block can have (227 KB)
constexpr int kStageBatch = 8;       // 16-byte loads a thread has in flight while staging V
constexpr int kChunk = 128;          // kernel 4, few users: items of a chunk (4 a lane)
constexpr int kGroup = 2;            // kernel 4, few users: chunks a warp loads at once

template <int SLOTS>
__global__ void __launch_bounds__(kDenseThreads)
topk_peruser_kernel(const float* __restrict__ U, const float* __restrict__ V,
                    const int8_t* __restrict__ mask, float* __restrict__ vals,
                    int* __restrict__ idx, int J, int K, int k) {
  extern __shared__ float s_u[];   // the request's u, K floats
  __shared__ MergeScratch sm;
  const int r = blockIdx.x;
  for (int c = threadIdx.x; c < K; c += kDenseThreads) s_u[c] = U[(size_t)r * K + c];
  __syncthreads();

  const float* vrow = V + (size_t)r * J * K;
  const int8_t* mrow = mask + (size_t)r * J;
  LaneTopK<SLOTS> L;
  L.init();
  for (int j = threadIdx.x; j < J; j += kDenseThreads) {
    if (mrow[j] != 0) continue;
    const float* v = vrow + (size_t)j * K;
    float s = 0.f;
    for (int c = 0; c < K; ++c) s += s_u[c] * v[c];
    if (s > NEG_INF_F) L.push(s, j);
  }
  merge_request(L, k, kDenseThreads / 32, threadIdx.x >> 5, 0, sm, vals + (size_t)r * k,
                idx + (size_t)r * k);
}

// The mask bytes p[0..3] of items j..j+3 as one word (byte b for item
// j + b), from aligned 4-byte loads and a funnel shift. A word that would
// reach outside [lo, hi), the mask's bytes, is read a byte at a time; a
// byte past hi reads as 1 (masked).
__device__ __forceinline__ unsigned mask_word(const int8_t* p, const int8_t* lo,
                                              const int8_t* hi) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const unsigned* w = reinterpret_cast<const unsigned*>(a & ~uintptr_t{3});
  const unsigned sh = 8u * static_cast<unsigned>(a & 3);
  if (reinterpret_cast<const int8_t*>(w) >= lo && reinterpret_cast<const int8_t*>(w + 2) <= hi)
    return __funnelshift_r(__ldg(w), sh ? __ldg(w + 1) : 0u, sh);
  unsigned out = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const unsigned byte = p + b < hi ? static_cast<unsigned char>(p[b]) : 1u;
    out |= byte << (8 * b);
  }
  return out;
}

// V[j0 : j0 + jn) into shared memory K-major, sv[c · j_tile + (j − j0)],
// by the whole block. The rows are read as consecutive 16-byte vectors
// (every warp load one run of 512 bytes, eight loads a thread in flight)
// where the tile starts 16-byte aligned, and as floats otherwise.
template <int KC>
__device__ __forceinline__ void stage_v(float* sv, const float* __restrict__ V, int j0, int jn,
                                        int K, int j_tile) {
  const int Kn = KC > 0 ? KC : K;
  const float* src = V + (size_t)j0 * Kn;
  const int n = jn * Kn;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    const int n4 = n / 4;
    for (int f0 = threadIdx.x; f0 < n4; f0 += kStageBatch * blockDim.x) {
      float4 t[kStageBatch];   // every load of the batch issued before any store
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        const int f = f0 + u * blockDim.x;
        if (f < n4) t[u] = __ldg(src4 + f);
      }
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        const int f = f0 + u * blockDim.x;
        if (f >= n4) continue;
        const float x[4] = {t[u].x, t[u].y, t[u].z, t[u].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 4 * f + i;
          const int jj = e / Kn;
          sv[(e - jj * Kn) * j_tile + jj] = x[i];
        }
      }
    }
    done = n4 * 4;
  }
  for (int e = done + threadIdx.x; e < n; e += blockDim.x) {
    const int jj = e / Kn;
    sv[(e - jj * Kn) * j_tile + jj] = __ldg(src + e);
  }
}

// The UT users' scores of the 4 items of group q of the staged tile: one
// 16-byte shared load per factor feeds the UT × 4 chains (each the
// ascending-K FMA chain from 0.0f). u is in registers (KC > 0) or read in
// place.
template <int UT, int KC>
__device__ __forceinline__ void score_group(const float4* sv4, int j_tile, int q,
                                            const float (&ur)[UT][KC > 0 ? KC : 1],
                                            const float* const (&u)[UT], int K,
                                            float (&s)[UT][4]) {
#pragma unroll
  for (int t = 0; t < UT; ++t)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[t][b] = 0.f;
  const int Kn = KC > 0 ? KC : K;
#pragma unroll
  for (int c = 0; c < Kn; ++c) {
    const float4 v = sv4[(c * j_tile >> 2) + q];
#pragma unroll
    for (int t = 0; t < UT; ++t) {
      const float uc = KC > 0 ? ur[t][KC > 0 ? c : 0] : __ldg(u[t] + c);
      s[t][0] = __fmaf_rn(uc, v.x, s[t][0]);
      s[t][1] = __fmaf_rn(uc, v.y, s[t][1]);
      s[t][2] = __fmaf_rn(uc, v.z, s[t][2]);
      s[t][3] = __fmaf_rn(uc, v.w, s[t][3]);
    }
  }
}

// Few users: block r is user r, blockDim.x = 32 · warps threads. A warp
// takes `group` (at most kGroup) chunks of kChunk consecutive items at a
// time (warp w the groups w, w + warps, ...): it loads the group's mask bytes and copies its
// rows, contiguous in V, into its slice of shared memory with 16-byte loads
// (every warp load one run of 512 bytes), all issued before any is used;
// then each lane scores 4 items of each chunk (lane + 32·b) from there.
// Then the warps merge with one barrier.
template <int SLOTS, int KC>
__global__ void __launch_bounds__(kFewMaxThreads)
topk_shared_few_kernel(const float* __restrict__ U, const float* __restrict__ V,
                       const int8_t* __restrict__ mask, float* __restrict__ vals,
                       int* __restrict__ idx, int R, int J, int K, int k, int group,
                       int merge) {
  extern __shared__ float4 sv4[];
  __shared__ MergeScratch sm;
  const int Kn = KC > 0 ? KC : K;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* buf = reinterpret_cast<float*>(sv4) + (size_t)w * group * kChunk * Kn;
  const int r = blockIdx.x;
  const float* u = U + (size_t)r * Kn;
  float ur[KC > 0 ? KC : 1];
  if constexpr (KC > 0) {
#pragma unroll
    for (int c = 0; c < KC; ++c) ur[c] = __ldg(u + c);
  }
  const int8_t* mrow = mask + (size_t)r * J;
  LaneTopK<SLOTS> L;
  L.init();
  const bool aligned = (reinterpret_cast<uintptr_t>(V) & 15) == 0 && (kChunk * Kn) % 4 == 0;
  for (int base = w * group * kChunk; base < J; base += warps * group * kChunk) {
    bool ok[kGroup * 4];
#pragma unroll
    for (int b = 0; b < kGroup * 4; ++b) {
      const int j = base + lane + 32 * b;
      ok[b] = b < 4 * group && j < J && mrow[j] == 0;
    }
    const int n = min(group * kChunk, J - base) * Kn;
    const float* src = V + (size_t)base * Kn;
    int done = 0;
    if (aligned) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      float4* dst4 = reinterpret_cast<float4*>(buf);
#pragma unroll 4
      for (int f = lane; f < n / 4; f += 32) dst4[f] = __ldg(src4 + f);
      done = n / 4 * 4;
    }
    for (int e = done + lane; e < n; e += 32) buf[e] = __ldg(src + e);
    __syncwarp();
#pragma unroll
    for (int b = 0; b < kGroup * 4; ++b) {
      if (!ok[b]) continue;
      const float* row = buf + (lane + 32 * b) * Kn;
      float s = 0.f;
      if constexpr (KC > 0) {
#pragma unroll
        for (int c = 0; c < KC; ++c) s = __fmaf_rn(ur[c], row[c], s);
      } else {
        for (int c = 0; c < Kn; ++c) s = __fmaf_rn(__ldg(u + c), row[c], s);
      }
      if (s > NEG_INF_F) L.push(s, base + lane + 32 * b);
    }
    __syncwarp();   // the group is read before the next overwrites it
  }
  float* out_v = vals + (size_t)r * k;
  int* out_i = idx + (size_t)r * k;
  if (!merge) {
    if (threadIdx.x < k) {
      out_v[threadIdx.x] = L.checksum();
      out_i[threadIdx.x] = L.head_id();
    }
    return;
  }
  merge_request(L, k, warps, w, 0, sm, out_v, out_i);
}

// Many users: gridDim.x persistent blocks of 16 warps. Block b takes the
// 2-user tiles [b·T/B, (b+1)·T/B) of T, its warp w the tiles w, w + 16,
// ... of that range. A lane takes 4 consecutive items at a time (one
// 16-byte shared load per factor, its 2 users' mask words) and runs the
// 2 × 4 chains of its register tile. A candidate below its user's bound
// (`head_bound`: the k-th best of the lanes' list heads to 16 bits, at most
// the user's k-th best) is no push: it cannot be in the top k. The bound
// rises after every pass that pushed. Without it nearly every candidate
// cost a whole list insertion, as some lane of the warp pushed.
template <int SLOTS, int KC>
__global__ void __launch_bounds__(kManyThreads, 1)   // up to 128 registers a thread
topk_shared_many_kernel(const float* __restrict__ U, const float* __restrict__ V,
                        const int8_t* __restrict__ mask, float* __restrict__ vals,
                        int* __restrict__ idx, int R, int J, int K, int k, int j_tile,
                        int merge) {
  extern __shared__ float4 sv4[];
  float* sv = reinterpret_cast<float*>(sv4);
  constexpr int UT = kUsersPerWarp;
  constexpr int W = kManyThreads / 32;
  const int lane = threadIdx.x & 31;
  const int tiles = (R + UT - 1) / UT;
  const int t_begin = (int)((long long)blockIdx.x * tiles / gridDim.x);
  const int t_end = (int)((long long)(blockIdx.x + 1) * tiles / gridDim.x);
  const int rounds = (t_end - t_begin + W - 1) / W;   // the same in every warp of the block
  const int8_t* const mask_end = mask + (size_t)R * J;
  const bool one_tile = j_tile >= J;
  if (one_tile) {
    stage_v<KC>(sv, V, 0, J, K, j_tile);
    __syncthreads();
  }

  for (int round = 0; round < rounds; ++round) {
    const int tile = t_begin + (threadIdx.x >> 5) + round * W;
    const int r0 = tile * UT;
    const int n_users = tile < t_end ? min(UT, R - r0) : 0;   // warp-uniform
    LaneTopK<SLOTS> L[UT];
    unsigned thr[UT];   // the same in every lane: a candidate's key below it is no push
    const float* u[UT];
    float ur[UT][KC > 0 ? KC : 1];
#pragma unroll
    for (int t = 0; t < UT; ++t) {
      L[t].init();
      thr[t] = 0u;
      u[t] = U + (size_t)(t < n_users ? r0 + t : 0) * K;
      if constexpr (KC > 0) {
#pragma unroll
        for (int c = 0; c < KC; ++c) ur[t][c] = t < n_users ? __ldg(u[t] + c) : 0.f;
      }
    }
    for (int j0 = 0; j0 < J; j0 += j_tile) {
      const int jn = min(j_tile, J - j0);
      if (!one_tile) {
        __syncthreads();   // the previous tile's reads are done
        stage_v<KC>(sv, V, j0, jn, K, j_tile);
        __syncthreads();
      }
      if (n_users == 0) continue;
      // every lane runs each pass (a lane past jn scores nothing), so the
      // bound is found over the whole warp
      for (int q0 = 0; 4 * q0 < jn; q0 += 32) {
        const int q = q0 + lane;
        const bool in_tile = 4 * q < jn;
        const int j = j0 + 4 * q;
        unsigned mw[UT];
#pragma unroll
        for (int t = 0; t < UT; ++t)
          mw[t] = t < n_users && in_tile
                      ? mask_word(mask + (size_t)(r0 + t) * J + j, mask, mask_end)
                      : ~0u;
        float s[UT][4];
        score_group<UT, KC>(sv4, j_tile, in_tile ? q : 0, ur, u, K, s);
#pragma unroll
        for (int t = 0; t < UT; ++t) {
          bool pushed = false;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (4 * q + b < jn && ((mw[t] >> (8 * b)) & 0xffu) == 0 && s[t][b] > NEG_INF_F &&
                order_key(s[t][b]) >= thr[t]) {
              L[t].push(s[t][b], j + b);
              pushed = true;
            }
          // the heads moved: raise the bound (the k-th best head, 16 bits)
          if (__any_sync(kFullMask, pushed)) thr[t] = head_bound(order_key(L[t].head_v()), k);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < UT; ++t) {
      if (t >= n_users) continue;
      float* out_v = vals + (size_t)(r0 + t) * k;
      int* out_i = idx + (size_t)(r0 + t) * k;
      if (merge) {
        unsigned long long x[SLOTS], top[4];
        pack_list(L[t], x);
        warp_topk(x, 32, k, out_v, out_i, top);
      } else if (lane < k) {
        out_v[lane] = L[t].checksum();
        out_i[lane] = L[t].head_id();
      }
    }
  }
}

template <int SLOTS>
int start_peruser(const float* U, const float* V, const int8_t* mask, float* vals, int* idx,
                  int R, int J, int K, int k, cudaStream_t stream) {
  topk_peruser_kernel<SLOTS><<<R, kDenseThreads, K * sizeof(float), stream>>>(
      U, V, mask, vals, idx, J, K, k);
  return static_cast<int>(cudaGetLastError());
}

struct SharedArgs {
  const float* U;
  const float* V;
  const int8_t* mask;
  float* vals;
  int* idx;
  int R, J, K, k, threads, blocks, tile, merge;
  cudaStream_t stream;
};

template <int SLOTS, int KC>
int start_shared(int many, const SharedArgs& a) {
  const int smem = static_cast<int>(sizeof(float)) * a.K *
                   (many ? a.tile : a.tile * kChunk * (a.threads / 32));
  auto kern = many ? topk_shared_many_kernel<SLOTS, KC> : topk_shared_few_kernel<SLOTS, KC>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<many ? a.blocks : a.R, a.threads, smem, a.stream>>>(a.U, a.V, a.mask, a.vals, a.idx,
                                                           a.R, a.J, a.K, a.k, a.tile,
                                                           a.merge);
  return static_cast<int>(cudaGetLastError());
}

template <int SLOTS>
int start_shared_k(int many, const SharedArgs& a) {
  if (a.K == 10) return start_shared<SLOTS, 10>(many, a);
  return start_shared<SLOTS, 0>(many, a);
}

}  // namespace

extern "C" int topk_peruser_launch(const float* U, const float* V, const int8_t* mask,
                                   float* vals, int* idx, int R, int J, int K, int k, int slots,
                                   void* stream) {
  const int per_lane = (J + kDenseThreads - 1) / kDenseThreads;
  if (k < 1 || k > TOPK_MAX || !slots_fit(slots, k, per_lane))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slots == 4) return start_peruser<4>(U, V, mask, vals, idx, R, J, K, k, s);
  if (slots == 8) return start_peruser<8>(U, V, mask, vals, idx, R, J, K, k, s);
  return start_peruser<16>(U, V, mask, vals, idx, R, J, K, k, s);
}

// many = 1: persistent blocks of 16 warps (`blocks` of them, threads 512)
// staging V in J tiles of `tile` items (a multiple of 4); many = 0: one
// block of `threads` per user, each warp copying `tile` (1 or 2) 128-item
// chunks at a time. A layout the kernel
// cannot run (too much shared memory, lane lists too short for k) is
// refused before any launch.
extern "C" int topk_shared_launch(const float* U, const float* V, const int8_t* mask,
                                  float* vals, int* idx, int R, int J, int K, int k, int many,
                                  int threads, int blocks, int slots, int tile, int merge,
                                  void* stream) {
  if (threads % 32 != 0 || threads < 32) return static_cast<int>(cudaErrorInvalidValue);
  // shared memory: the staged V tile (many) or each warp's chunk (few)
  const long long smem =
      (many ? 4LL * K * tile : 4LL * K * tile * kChunk * (threads / 32)) +
      (long long)sizeof(MergeScratch);
  int per_lane;   // the most items one lane scores for one user
  if (many) {
    if (threads != kManyThreads || blocks < 1 || tile < 4 || tile % 4 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    per_lane = 4 * ((J + 127) / 128);
  } else {
    if (threads > kFewMaxThreads || tile < 1 || tile > kGroup)
      return static_cast<int>(cudaErrorInvalidValue);
    const int groups = (J + tile * kChunk - 1) / (tile * kChunk), warps = threads / 32;
    per_lane = 4 * tile * ((groups + warps - 1) / warps);
  }
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (k < 1 || k > TOPK_MAX || !slots_fit(slots, k, per_lane))
    return static_cast<int>(cudaErrorInvalidValue);
  const SharedArgs a{U, V, mask, vals, idx, R, J, K, k, threads, blocks, tile, merge,
                     static_cast<cudaStream_t>(stream)};
  if (slots == 4) return start_shared_k<4>(many, a);
  if (slots == 8) return start_shared_k<8>(many, a);
  return start_shared_k<16>(many, a);
}
