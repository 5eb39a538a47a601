// Shared running top-k for the top-k kernels (serve_topk.cu,
// topk_scores.cu): the CUDA counterpart of `_merge_tile_topk` in
// src/repro/kernels/topk_scores.py:23.
//
// The Pallas carry relies on a left-to-right scan over tiles and a
// strictly-greater displacement to give (score descending, item id
// ascending). CUDA lanes scan their candidates strided, so that order is
// lost. Here the order is explicit instead: every comparison, in each
// lane's local list and in the merge, is on the (score, id) pair. The
// result does not depend on which lane saw which candidate.
//
// One merge, inside a warp (`warp_topk`): each lane keeps its best SLOTS
// candidates in registers (SLOTS ≥ min(k, the lane's candidates), so no
// candidate of the top k is dropped). A candidate is packed into one
// 64-bit key whose unsigned order is (score descending, id ascending), and
// the lanes' sorted lists are merged by a bitonic network across the warp,
// 4 keys a lane: runs double by lane pairs (shuffles) until they hold 16,
// and from then on each merge of two runs keeps the better 16 (12 shuffle
// steps for 32 lanes). Longer lists enter 4 keys at a time, only while
// they can still reach the top k. The network is exact, exact ties
// included, and has no round per output slot: k rounds of a warp arg-best
// (two reductions and a ballot in sequence each) made kernel 1 slower at
// both of its main shapes, kernel 4 as fast for one request and 9% faster
// on the MF state (PERF.md §6). No block barrier. A block with several warps on one
// request takes one barrier: each warp writes its k best to shared memory,
// and one warp merges those lists, one a lane, through the same network
// 16 keys a lane (`merge_request`), or, for up to 16 warps' lists (a
// block or a thread block cluster), eight lists at a time on each of two
// warps, 4 keys a lane (`merge_lists`).
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#define TOPK_MAX 16           // k ≤ 16, checked by the wrappers
#define NEG_INF_F (-1e30f)    // dead-slot value, kernels/ref.py NEG_INF
#define MERGE_WARPS 16        // warps a block may merge (MergeScratch)
#define NET_KEEP 16           // a merged run keeps its best 16 (≥ TOPK_MAX)

constexpr unsigned kFullMask = 0xffffffffu;

// (va, ia) ranks before (vb, ib): higher score first, lower id on a tie.
__device__ __forceinline__ bool ranks_before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// A 32-bit key whose unsigned order is the score's order (never NaN here).
// `s + 0.0f` makes −0.0 into +0.0 first, so the two zeros rank equal, as
// `ranks_before` has them.
__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned b = __float_as_uint(s + 0.0f);
  return b ^ ((b >> 31) ? 0xffffffffu : 0x80000000u);
}

// The key of every score that is not eligible (≤ NEG_INF_F, -inf).
__device__ __forceinline__ unsigned dead_key() { return order_key(NEG_INF_F); }

// A lane's private top-SLOTS list, best first, in registers: every index
// below is a compile-time constant after unrolling. Empty entries are
// (-inf, INT_MAX), which every eligible candidate outranks.
template <int SLOTS>
struct LaneTopK {
  static_assert(SLOTS == 4 || SLOTS == 8 || SLOTS == 16, "a lane list has 4, 8 or 16 slots");
  float v[SLOTS];
  int id[SLOTS];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      v[s] = -CUDART_INF_F;
      id[s] = INT_MAX;
    }
  }

  // Insert by bubbling the candidate down the list; the last entry drops.
  __device__ __forceinline__ void push(float cv, int ci) {
    if (!ranks_before(cv, ci, v[SLOTS - 1], id[SLOTS - 1])) return;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
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

  __device__ __forceinline__ float head_v() const { return v[0]; }
  __device__ __forceinline__ int head_id() const { return id[0]; }

  // Scoring without the merge (a timing form): a value that depends on
  // every slot, so no push is optimized away.
  __device__ __forceinline__ float checksum() const {
    float a = 0.f;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) a += v[s] + static_cast<float>(id[s] & 0xff);
    return a;
  }
};

// A lower bound of the k-th best key of the warp's entries: the largest
// value with zero low 16 bits that at least k of the lanes' live heads
// reach (each head is an entry, so the k-th best entry is at or above the
// k-th best head). Found by 16 ballots, the same in every lane; 0 when
// fewer than k heads are live.
__device__ __forceinline__ unsigned head_bound(unsigned head_key, int k) {
  const bool live = head_key > dead_key();
  unsigned p = 0;
#pragma unroll
  for (int b = 31; b >= 16; --b) {
    const unsigned c = p | (1u << b);
    if (__popc(__ballot_sync(kFullMask, live && head_key >= c)) >= k) p = c;
  }
  return p;
}

// A candidate as one 64-bit key, larger ranking first: the score's order
// key, then 0x7fffffff − id, then one bit for −0.0 (so that the score
// comes back with its sign). An empty entry (-inf, INT_MAX) and the
// network's padding 0 rank below every candidate.
__device__ __forceinline__ unsigned long long pack_entry(float v, int id) {
  const unsigned neg_zero = v == 0.f && signbit(v) ? 1u : 0u;
  return static_cast<unsigned long long>(order_key(v)) << 32 |
         (0x7fffffffu - static_cast<unsigned>(id)) << 1 | neg_zero;
}

__device__ __forceinline__ float entry_score(unsigned long long p) {
  const unsigned key = static_cast<unsigned>(p >> 32);
  return (p & 1) ? -0.0f : __uint_as_float(key ^ ((key >> 31) ? 0x80000000u : 0xffffffffu));
}

__device__ __forceinline__ int entry_id(unsigned long long p) {
  return static_cast<int>(0x7fffffffu - (static_cast<unsigned>(p) >> 1));
}

// In-lane half-cleaners at distances D, D/2, ..., 1: the larger key to the
// lower slot of each pair.
template <int E, int D>
__device__ __forceinline__ void clean_lane(unsigned long long (&x)[E]) {
  if constexpr (D >= 1) {
#pragma unroll
    for (int i = 0; i < E; ++i)
      if ((i & D) == 0) {
        const unsigned long long a = x[i], b = x[i + D];
        x[i] = a > b ? a : b;
        x[i + D] = a > b ? b : a;
      }
    clean_lane<E, D / 2>(x);
  }
}

// One cross-lane compare-exchange step with the lane `lane ^ mask`: slot s
// against the partner's slot s (flip = false) or E − 1 − s (flip = true);
// the lane with the lower position keeps the larger key.
template <int E>
__device__ __forceinline__ void exchange(unsigned long long (&x)[E], int mask, bool flip,
                                         bool keep_max) {
  unsigned long long y[E];
#pragma unroll
  for (int s = 0; s < E; ++s) y[s] = __shfl_xor_sync(kFullMask, x[flip ? E - 1 - s : s], mask);
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const unsigned long long a = x[s], b = y[s];
    x[s] = (a > b) == keep_max ? a : b;
  }
}

// The bitonic network over E keys a lane: each lane's E keys sorted
// (larger first), only lanes below `lanes` holding any; position lane·E + s
// is slot s of that lane. Runs of n keys (m lanes) merge with the run
// `stride` lanes up: a flip step (position i against the other run's
// 2n − 1 − i), then half-cleaners; while n < 16 both halves are kept and
// cleaned, after that only the lower run's 16. The best 16 end in lanes
// [0, 16 / E), sorted. `first` > 1: the keys already form sorted runs of
// `first` lanes (E · first keys each), and the network starts from them.
// All 32 lanes call it.
template <int E>
__device__ __forceinline__ void net(unsigned long long (&x)[E], int lanes, int first = 1) {
  static_assert(E == 4 || E == 16, "4 or 16 keys a lane");
  const int lane = threadIdx.x & 31;
  int n = E * first, m = first;
  for (int stride = first; stride < lanes; stride <<= 1) {
    exchange(x, stride | (m - 1), true, (lane & stride) == 0);
    for (int d = (n < NET_KEEP ? n : NET_KEEP) / 2; d >= E; d >>= 1)
      exchange(x, d / E, false, (lane & (d / E)) == 0);
    clean_lane<E, E / 2>(x);
    if (n < NET_KEEP) {
      n *= 2;
      m *= 2;
    }
  }
}

// Positions 0 .. k − 1 of the network's best 16 (in lanes [0, 16 / E))
// into (out_v, out_i); a position past the live entries is (NEG_INF, -1).
// The caller skips it for a request slot past R (out_v == nullptr).
template <int E>
__device__ __forceinline__ void write_top(const unsigned long long (&x)[E], int k, float* out_v,
                                          int* out_i) {
  const int lane = threadIdx.x & 31;
  if (lane * E >= k) return;
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const int at = lane * E + s;
    if (at >= k) break;
    const bool live = static_cast<unsigned>(x[s] >> 32) > dead_key();
    out_v[at] = live ? entry_score(x[s]) : NEG_INF_F;
    out_i[at] = live ? entry_id(x[s]) : -1;
  }
}

// x ← the best 16 of two sorted runs of 16 held in lanes 0-3, x and y.
__device__ __forceinline__ void merge16(unsigned long long (&x)[4], unsigned long long (&y)[4]) {
  const int lane = threadIdx.x & 31;
  unsigned long long r[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) r[s] = __shfl_xor_sync(kFullMask, y[3 - s], 3);   // position 15 − i
#pragma unroll
  for (int s = 0; s < 4; ++s) x[s] = x[s] > r[s] ? x[s] : r[s];
  exchange(x, 2, false, (lane & 2) == 0);
  exchange(x, 1, false, (lane & 1) == 0);
  clean_lane<4, 2>(x);
}

// The warp's k best of the lanes' keys (S sorted keys a lane, S = 4, 8 or
// 16; only lanes below `lanes` hold any), in order, into (out_v, out_i);
// slots past the live entries are (NEG_INF, -1). The 4-key network runs on
// the lanes' first 4 keys; the next 4 of every lane are merged in only while
// some lane's last merged key still reaches the k-th best so far (a later
// key of that lane is no better than it), which at the main shapes is
// rarely. `top` returns the best 16 in lanes 0-3. out_v == nullptr writes
// nothing. All 32 lanes call it.
template <int S>
__device__ __forceinline__ void warp_topk(const unsigned long long (&key)[S], int lanes, int k,
                                          float* out_v, int* out_i,
                                          unsigned long long (&top)[4]) {
  static_assert(S == 4 || S == 8 || S == 16, "4, 8 or 16 keys a lane");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < 4; ++s) top[s] = key[s];
  net(top, lanes);
#pragma unroll
  for (int b = 1; b < S / 4; ++b) {
    unsigned long long mine = top[0];   // slot (k − 1) % 4, without indexing registers
#pragma unroll
    for (int s = 1; s < 4; ++s) mine = s == (k - 1) % 4 ? top[s] : mine;
    const unsigned long long kth = __shfl_sync(kFullMask, mine, (k - 1) / 4);
    if (!__any_sync(kFullMask, key[4 * b - 1] >= kth)) break;
    unsigned long long y[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) y[s] = key[4 * b + s];
    net(y, lanes);
    merge16(top, y);
  }
  if (out_v != nullptr) write_top(top, k, out_v, out_i);
}

// A lane's list as network keys.
template <int SLOTS>
__device__ __forceinline__ void pack_list(const LaneTopK<SLOTS>& L,
                                          unsigned long long (&x)[SLOTS]) {
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) x[s] = pack_entry(L.v[s], L.id[s]);
}

// Shared memory of the second stage: each warp's k best as network keys.
struct MergeScratch {
  unsigned long long key[MERGE_WARPS][TOPK_MAX];
};

// The merge of one request's `warps` warps (warp w of them, block-uniform
// `warps`; the request's first warp is `first` of the block). With one
// warp the lanes' lists merge straight into (out_v, out_i); with more,
// each warp writes its k best keys to `sm`, one barrier, and warp 0 of the
// request merges the warps' lists, one a lane. Every thread of the block
// calls this.
template <int SLOTS>
__device__ __forceinline__ void merge_request(const LaneTopK<SLOTS>& L, int k, int warps,
                                              int w, int first, MergeScratch& sm, float* out_v,
                                              int* out_i) {
  const int lane = threadIdx.x & 31;
  unsigned long long x[SLOTS], top[4];
  pack_list(L, x);
  if (warps == 1) {
    warp_topk(x, 32, k, out_v, out_i, top);
    return;
  }
  warp_topk(x, 32, k, nullptr, nullptr, top);
#pragma unroll
  for (int s = 0; s < 4; ++s)   // the warp's best k, at lanes 0-3
    if (lane * 4 + s < k) sm.key[first + w][lane * 4 + s] = top[s];
  __syncthreads();
  if (w == 0) {   // lane l < warps holds warp l's list: the 16-key network
    unsigned long long y[TOPK_MAX];
#pragma unroll
    for (int s = 0; s < TOPK_MAX; ++s) y[s] = lane < warps && s < k ? sm.key[first + lane][s] : 0;
    net(y, warps);
    if (out_v != nullptr) write_top(y, k, out_v, out_i);
  }
}

// Lists first, first + 1, ... (fewer than `lists`, at most 8) of `sm`,
// each k sorted keys, as runs of 16 keys over 4 lanes (list first + l/4
// in lanes l, slot 4·(l % 4) + s in key s; past k or past the lists, 0).
__device__ __forceinline__ void load_runs(const MergeScratch& sm, int first, int lists, int k,
                                          unsigned long long (&x)[4]) {
  const int lane = threadIdx.x & 31;
  const int list = first + (lane >> 2);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int slot = 4 * (lane & 3) + s;
    x[s] = list < lists && list < first + 8 && slot < k ? sm.key[list][slot] : 0;
  }
}

// The k best of `lists` (at most MERGE_WARPS) sorted lists of k keys in
// `sm`, in order, into (out_v, out_i), by warps 0 and 1 of the block (w,
// block-uniform `lists`): eight lists at a time as runs of 16 keys over 4
// lanes, merged by the 4-key network from runs of 16 (three steps for
// eight lists). Above eight lists warp 1 merges lists 8-15 at the same
// time, leaves its best 16 in list 8's slots, and after a barrier of the
// two warps warp 0 takes them in with `merge16`. Both warps call it.
__device__ __forceinline__ void merge_lists(MergeScratch& sm, int lists, int k, int w,
                                            float* out_v, int* out_i) {
  const int lane = threadIdx.x & 31;
  unsigned long long x[4];
  load_runs(sm, w == 0 ? 0 : 8, lists, k, x);
  if (w == 1 && lists <= 8) return;
  net(x, 4 * (w == 0 ? (lists < 8 ? lists : 8) : lists - 8), 4);
  if (lists > 8) {
    if (w == 1) {
      __syncwarp();   // every lane has read lists 8-15
      if (lane < 4) {
#pragma unroll
        for (int s = 0; s < 4; ++s) sm.key[8][4 * lane + s] = x[s];
      }
    }
    asm volatile("bar.sync 1, 64;\n" ::: "memory");   // warps 0 and 1
    if (w == 1) return;
    unsigned long long y[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) y[s] = sm.key[8][4 * (lane & 3) + s];
    merge16(x, y);
  }
  write_top(x, k, out_v, out_i);
}

// True if a lane list of `slots` entries can serve k from lanes that score
// at most `per_lane` candidates each: 4, 8 or 16 slots, at least
// min(k, per_lane). The host wrappers choose the smallest such size.
inline bool slots_fit(int slots, int k, int per_lane) {
  return (slots == 4 || slots == 8 || slots == 16) && slots >= (k < per_lane ? k : per_lane);
}

// The score of one candidate, in every kernel: one fp32 FMA chain from
// 0.0f over ascending j. KC > 0: the row is in registers.
template <int KC>
__device__ __forceinline__ float dot_chain(const float (&u)[KC], const float (&f)[KC]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < KC; ++j) s = __fmaf_rn(u[j], f[j], s);
  return s;
}

// K at run time: u and the row read in place.
__device__ __forceinline__ float dot_chain(const float* __restrict__ u,
                                           const float* __restrict__ f, int K) {
  float s = 0.f;
  for (int j = 0; j < K; ++j) s = __fmaf_rn(__ldg(u + j), __ldg(f + j), s);
  return s;
}

// One fp32 row of KC factors into registers, `vec` floats a load (4, 2 or
// 1; the caller's rows are aligned to it), all loads issued before any is
// used.
template <int KC>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float (&f)[KC], int vec) {
  if (KC % 4 == 0 && vec == 4) {
#pragma unroll
    for (int i = 0; i < KC / 4; ++i) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + i);
      f[4 * i] = t.x;
      f[4 * i + 1] = t.y;
      f[4 * i + 2] = t.z;
      f[4 * i + 3] = t.w;
    }
  } else if (KC % 2 == 0 && vec >= 2) {
#pragma unroll
    for (int i = 0; i < KC / 2; ++i) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(p) + i);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < KC; ++j) f[j] = __ldg(p + j);
  }
}

// The widest load (4, 2 or 1 floats) that every row of K floats from
// `base` allows.
inline int row_vec(const void* base, int K) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  if (K % 4 == 0 && a % 16 == 0) return 4;
  if (K % 2 == 0 && a % 8 == 0) return 2;
  return 1;
}
