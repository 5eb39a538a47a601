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
// Kernel 2's bound: memory. At the serving microbatch (R=64, J=3,197,
// K=10, k=10) a launch reads the V rows (8.2 MB), U and the mask (205 KB)
// and writes 5 KB: 2.5 us at 3.35 TB/s; at evaluate (R=6,524) 855 MB,
// 0.255 ms, and through P and Q (v = p + q formed in registers) 1.69 GB,
// 0.505 ms. Its 2·R·J·K FLOP are 0.06 us and 6.2 us at 67 TFLOP/s fp32.
// Request r reads the rows at rows[r] (r itself without `rows`) of V, of Q
// when given, and of the mask, where they lie: the callers no longer
// gather them or add P + Q first. Its design (`topk_rows_kernel`, one
// body with kernel 4's few-users form): a user's 128-item chunks (5,120 B
// at K=10, contiguous) stream through a ring of `stages` chunks a warp in
// shared memory, by cp.async (16-byte copies, a peeled head and tail for
// rows that start off a 16-byte boundary: odd rows do at K=10, J=3,197),
// beside the chunk's mask bytes, copied as whole aligned words; a lane
// scores 4 items of each chunk (lane + 32·b). The host chooses the layout
// from R (`topk_scores.peruser_layout`):
//
//   few users (R below one block an SM): a user's chunks are split over a
//   thread block cluster of 2-4 blocks, so that R=64 fills the card; each
//   warp writes its k best into the leader block's shared memory
//   (distributed shared memory), one cluster barrier, and the leader's
//   first warp merges the cluster's lists.
//
//   many users: a block of 4 warps a user, a ring of 2 chunks a warp: 5
//   blocks an SM (2 through P and Q) keep 100-200 KB in flight. Lanes
//   score ~28 items into 16-slot lists; a candidate below the warp's bound
//   of the user's k-th best (`head_bound`) is no push.
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
//   few users: kernel 2's body on the one shared V, a block per user, up
//   to 16 warps, a ring of `tile` chunks a warp; one barrier to merge.
//
// Every form keeps one per-item dot, an ascending-K fp32 FMA chain from
// 0.0f (v = __fadd_rn(p, q) first through P and Q: the bits of the
// caller's P + Q), so kernel 4 on one user with V = p^i + q^i gives kernel
// 2's bits on that row, in either layout, and kernel 2 gives the same
// bits in every layout and row source. The ragged edge is the loop bound:
// no item ≥ J and no byte outside a row is read, where the TPU wrappers
// padded J to 128 or 256 and masked the pad (src/repro/kernels/ops.py:
// 146-152, 267-269).
#include <cooperative_groups.h>

#include "topk.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kFewMaxThreads = 512;  // kernels 2 and 4 (few users): a block's threads
constexpr int kManyThreads = 512;    // kernel 4, many users: 16 warps a block, one an SM
constexpr int kUsersPerWarp = 2;     // kernel 4, many users: a warp's register tile
constexpr int kMaxSmem = 232448;     // dynamic shared memory a block can have (227 KB)
constexpr int kStageBatch = 8;       // 16-byte loads a thread has in flight while staging V
constexpr int kChunk = 128;          // items of a streamed chunk (4 a lane)
constexpr int kMaskBytes = 144;      // a chunk's mask window: 128 bytes + 3 of alignment, to 16
constexpr int kMaxStages = 4;        // chunks a warp's ring holds
constexpr int kMaxCluster = 4;       // blocks a user's cluster may have

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

// cp.async: copies into shared memory that the issuing thread waits for
// with `cp_async_wait`; the warp reads them after a __syncwarp.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// The cluster's split barrier: arrive (relaxed: nothing to publish, or
// release), then wait (acquire).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// n floats from src to dst by the warp, asynchronously, where dst and src
// lie the same distance past a 16-byte boundary: a head of up to 3 floats
// and a tail of up to 3 as 4-byte copies, the rest as 16-byte copies
// (every warp copy one run of 512 bytes). Nothing outside [src, src + n)
// is read.
__device__ __forceinline__ void copy_floats_async(float* dst, const float* src, int n,
                                                  int lane) {
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int head = min(n, (4 - mis) & 3);
  const int n4 = (n - head) >> 2;
  if (lane < head) cp_async4(dst + lane, src + lane);
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int f = lane; f < n4; f += 32) cp_async16(d4 + f, s4 + f);
  const int done = head + 4 * n4;
  if (done + lane < n) cp_async4(dst + done + lane, src + done + lane);
}

// The mask bytes [p, p + n) (n ≤ kChunk) by the warp into dst as whole
// aligned words: byte (p & 3) + i of dst is p[i]. A word that would reach
// outside [lo, hi), the mask's bytes, is read a byte at a time (a byte
// outside reads as 1, masked).
__device__ __forceinline__ void copy_mask_async(unsigned* dst, const int8_t* p, int n,
                                                const int8_t* lo, const int8_t* hi, int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const int8_t* w0 = reinterpret_cast<const int8_t*>(a & ~uintptr_t{3});
  const int words = static_cast<int>(((a & 3) + n + 3) >> 2);   // at most 33
  for (int i = lane; i < words; i += 32) {
    const int8_t* w = w0 + 4 * i;
    if (w >= lo && w + 4 <= hi) {
      cp_async4(dst + i, w);
    } else {
      unsigned out = 0;
      for (int b = 0; b < 4; ++b)
        out |= (w + b >= lo && w + b < hi ? static_cast<unsigned>(static_cast<unsigned char>(w[b]))
                                          : 1u) << (8 * b);
      dst[i] = out;
    }
  }
}

// Where request r's rows lie. Kernel 2: row rows[r] (r itself when rows
// is null) of V, of Q (when not null: v = V row + Q row) and of the mask,
// V and Q rows J·K floats apart. Kernel 4's few-users form: the one
// shared V (v_stride 0) and mask row r.
struct RowSource {
  const float* V;
  const float* Q;
  const int8_t* mask;
  const long long* rows;
  int n_rows;         // rows of V, Q and the mask: a row id outside [0, n_rows) traps
  long long v_stride;
};

// Floats of one ring stage: the chunk's V rows and (kQ) its Q rows, each
// with 4 floats of room to start at the source's offset past 16 bytes,
// then the chunk's mask window.
__host__ __device__ __forceinline__ int chunk_floats(int K) { return kChunk * K + 4; }
__host__ __device__ __forceinline__ int stage_floats(int K, bool q) {
  return chunk_floats(K) * (q ? 2 : 1) + kMaskBytes / 4;
}

// The most items one lane scores: a user's ceil(J / kChunk) chunks are
// split over `cluster` blocks in contiguous shares, a block's over its
// warps in turn (chunk w, w + warps, ...), 4 items of a chunk a lane.
__host__ __device__ __forceinline__ int rows_per_lane(int J, int cluster, int warps) {
  const int chunks = (J + kChunk - 1) / kChunk;
  const int per_block = (chunks + cluster - 1) / cluster;
  const int n = 4 * ((per_block + warps - 1) / warps);
  return n > 1 ? n : 1;
}

// Kernels 2 and 4 (few users), one body: block b is user b / cluster,
// share b % cluster of its chunks; blockDim.x = 32 · warps. Each warp
// streams its chunks through a ring of `stages` in its slice of shared
// memory (chunk i + stages − 1 copied while chunk i is scored), each lane
// scores 4 items of a chunk (lane + 32·b) from there into its list. Then
// each warp's k best go to the leader block (one barrier, a cluster
// barrier across blocks), whose first warp merges them.
template <int SLOTS, int KC, bool kQ>
__global__ void __launch_bounds__(kFewMaxThreads)
topk_rows_kernel(const float* __restrict__ U, RowSource src, float* __restrict__ vals,
                 int* __restrict__ idx, int J, int K, int k, int cluster, int stages,
                 int merge) {
  extern __shared__ float4 smem4[];
  __shared__ MergeScratch sm;
  if (cluster > 1) cluster_arrive_relaxed();   // this block has started
  const int Kn = KC > 0 ? KC : K;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int r = blockIdx.x / cluster;
  const int rank = cluster > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  long long row = r;
  if (src.rows != nullptr) {
    row = src.rows[r];
    if (row < 0 || row >= src.n_rows) __trap();   // as the gather it replaces would
  }
  const float* vrow = src.V + row * src.v_stride;
  const float* qrow = kQ ? src.Q + row * src.v_stride : nullptr;
  const int8_t* mrow = src.mask + row * J;
  const int8_t* m_lo = src.mask;
  const int8_t* m_hi = src.mask + static_cast<long long>(src.n_rows) * J;
  const float* u = U + static_cast<size_t>(r) * Kn;
  float ur[KC > 0 ? KC : 1];
  if constexpr (KC > 0) {
#pragma unroll
    for (int c = 0; c < KC; ++c) ur[c] = __ldg(u + c);
  }

  const int chunks = (J + kChunk - 1) / kChunk;
  const int c_begin = static_cast<int>(static_cast<long long>(rank) * chunks / cluster);
  const int c_end = static_cast<int>(static_cast<long long>(rank + 1) * chunks / cluster);
  const int mine = c_end - c_begin > w ? (c_end - c_begin - w + warps - 1) / warps : 0;
  const int sf = stage_floats(Kn, kQ);
  float* ring = reinterpret_cast<float*>(smem4) + static_cast<size_t>(w) * stages * sf;
  // where a chunk's first float lands in its buffer: the row's offset past 16 bytes
  const int v_at = static_cast<int>((reinterpret_cast<uintptr_t>(vrow) >> 2) & 3);
  const int q_at = kQ ? chunk_floats(Kn) + static_cast<int>((reinterpret_cast<uintptr_t>(qrow) >> 2) & 3)
                      : 0;
  const int m_at = chunk_floats(Kn) * (kQ ? 2 : 1);   // the mask window, in floats
  const int m_off = static_cast<int>(reinterpret_cast<uintptr_t>(mrow) & 3);

  auto issue = [&](int i) {   // this warp's chunk i into stage i % stages
    if (i < mine) {
      const int j0 = (c_begin + w + i * warps) * kChunk;
      const int n = min(kChunk, J - j0);
      float* st = ring + (i % stages) * sf;
      copy_floats_async(st + v_at, vrow + static_cast<size_t>(j0) * Kn, n * Kn, lane);
      if constexpr (kQ)
        copy_floats_async(st + q_at, qrow + static_cast<size_t>(j0) * Kn, n * Kn, lane);
      copy_mask_async(reinterpret_cast<unsigned*>(st + m_at), mrow + j0, n, m_lo, m_hi, lane);
    }
    cp_async_commit();   // one group a step, empty or not, so the count of groups is fixed
  };

  LaneTopK<SLOTS> L;
  L.init();
  unsigned thr = 0u;   // the same in every lane: a candidate's key below it is no push
  for (int i = 0; i < stages - 1; ++i) issue(i);
  for (int i = 0; i < mine; ++i) {
    issue(i + stages - 1);
    cp_async_wait(stages - 1);   // chunk i has landed
    __syncwarp();
    const float* st = ring + (i % stages) * sf;
    const unsigned char* mb = reinterpret_cast<const unsigned char*>(st + m_at) + m_off;
    const int j0 = (c_begin + w + i * warps) * kChunk;
    const int n = min(kChunk, J - j0);
    bool pushed = false;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int t = lane + 32 * b;
      if (t >= n || mb[t] != 0) continue;
      const float* pv = st + v_at + t * Kn;
      const float* qv = st + q_at + t * Kn;
      float s = 0.f;
      if constexpr (KC > 0) {
#pragma unroll
        for (int c = 0; c < KC; ++c) s = __fmaf_rn(ur[c], kQ ? __fadd_rn(pv[c], qv[c]) : pv[c], s);
      } else {
        for (int c = 0; c < Kn; ++c)
          s = __fmaf_rn(__ldg(u + c), kQ ? __fadd_rn(pv[c], qv[c]) : pv[c], s);
      }
      if (s > NEG_INF_F && order_key(s) >= thr) {
        L.push(s, j0 + t);
        pushed = true;
      }
    }
    if constexpr (SLOTS == 16) {   // long lane lists: raise the bound after pushes
      if (__any_sync(kFullMask, pushed)) thr = head_bound(order_key(L.head_v()), k);
    }
    __syncwarp();   // the stage is read before it is copied into again
  }

  float* out_v = vals + static_cast<size_t>(r) * k;
  int* out_i = idx + static_cast<size_t>(r) * k;
  if (!merge) {   // a timing form: list checksums, no slate
    if (cluster > 1) cluster_wait();
    if (rank == 0 && threadIdx.x < k) {
      out_v[threadIdx.x] = L.checksum();
      out_i[threadIdx.x] = L.head_id();
    }
    return;
  }
  const int lists = cluster * warps;
  unsigned long long x[SLOTS], top[4];
  pack_list(L, x);
  if (lists == 1) {
    warp_topk(x, 32, k, out_v, out_i, top);
    return;
  }
  warp_topk(x, 32, k, nullptr, nullptr, top);
  MergeScratch* dst = &sm;
  if (cluster > 1) {
    cluster_wait();   // every block of the cluster has started: the leader's memory is there
    dst = cg::this_cluster().map_shared_rank(&sm, 0);
  }
#pragma unroll
  for (int s = 0; s < 4; ++s)   // the warp's best k, at lanes 0-3
    if (lane * 4 + s < k) dst->key[rank * warps + w][lane * 4 + s] = top[s];
  if (cluster > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  if (rank == 0 && w < 2) merge_lists(sm, lists, k, w, out_v, out_i);
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

struct RowsArgs {
  const float* U;
  RowSource src;
  float* vals;
  int* idx;
  int R, J, K, k, cluster, warps, stages, merge;
  cudaStream_t stream;
};

template <int SLOTS, int KC, bool kQ>
int start_rows(const RowsArgs& a) {
  const int smem = static_cast<int>(sizeof(float)) * a.warps * a.stages *
                   stage_floats(KC > 0 ? KC : a.K, kQ);
  auto kern = topk_rows_kernel<SLOTS, KC, kQ>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.cluster == 1) {
    kern<<<a.R, 32 * a.warps, smem, a.stream>>>(a.U, a.src, a.vals, a.idx, a.J, a.K, a.k, 1,
                                                  a.stages, a.merge);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.R) * a.cluster);
  cfg.blockDim = dim3(32 * a.warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a.U, a.src, a.vals, a.idx, a.J, a.K, a.k, a.cluster,
                           a.stages, a.merge);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int SLOTS, bool kQ>
int start_rows_k(const RowsArgs& a) {
  if (a.K == 10) return start_rows<SLOTS, 10, kQ>(a);
  return start_rows<SLOTS, 0, kQ>(a);
}

template <bool kQ>
int start_rows_slots(int slots, const RowsArgs& a) {
  if (slots == 4) return start_rows_k<4, kQ>(a);
  if (slots == 8) return start_rows_k<8, kQ>(a);
  return start_rows_k<16, kQ>(a);
}

// A rows layout the kernel cannot run: cudaErrorInvalidValue, else 0.
int check_rows_layout(int J, int K, int k, int cluster, int warps, int stages, int slots,
                      bool q) {
  if (cluster < 1 || cluster > kMaxCluster || warps < 1 || warps * cluster > MERGE_WARPS ||
      32 * warps > kFewMaxThreads || stages < 1 || stages > kMaxStages || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = 4LL * warps * stages * stage_floats(K, q) +
                         static_cast<long long>(sizeof(MergeScratch));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (k < 1 || k > TOPK_MAX || !slots_fit(slots, k, rows_per_lane(J, cluster, warps)))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
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
int start_shared_many(const SharedArgs& a) {
  const int smem = static_cast<int>(sizeof(float)) * a.K * a.tile;
  auto kern = topk_shared_many_kernel<SLOTS, KC>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<a.blocks, a.threads, smem, a.stream>>>(a.U, a.V, a.mask, a.vals, a.idx, a.R, a.J, a.K,
                                                a.k, a.tile, a.merge);
  return static_cast<int>(cudaGetLastError());
}

template <int SLOTS>
int start_shared_many_k(const SharedArgs& a) {
  if (a.K == 10) return start_shared_many<SLOTS, 10>(a);
  return start_shared_many<SLOTS, 0>(a);
}

}  // namespace

// Kernel 2. Request r (of R, U row r) scores row rows[r] (r when rows is
// null) of V (n_rows × J × K), plus the same
// row of Q when Q is not null, over that row of the mask (n_rows × J).
// Layout: each user's chunks over `cluster` blocks (1-4, a thread block
// cluster above 1) of `warps` warps, a ring of `stages` chunks a warp,
// lane lists of `slots`. merge = 0 scores without merging (list
// checksums, a timing form). A layout the kernel cannot run is refused
// before any launch.
extern "C" int topk_peruser_launch(const float* U, const float* V, const float* Q,
                                   const long long* rows, const int8_t* mask, float* vals,
                                   int* idx, int n_rows, int R, int J, int K, int k,
                                   int cluster, int warps, int stages, int slots, int merge,
                                   void* stream) {
  const int bad = check_rows_layout(J, K, k, cluster, warps, stages, slots, Q != nullptr);
  if (bad) return bad;
  const RowsArgs a{U,
                   RowSource{V, Q, mask, rows, n_rows, static_cast<long long>(J) * K},
                   vals, idx, R, J, K, k, cluster, warps, stages, merge,
                   static_cast<cudaStream_t>(stream)};
  return Q != nullptr ? start_rows_slots<true>(slots, a) : start_rows_slots<false>(slots, a);
}

// Kernel 4. many = 1: persistent blocks of 16 warps (`blocks` of them,
// threads 512) staging V in J tiles of `tile` items (a multiple of 4);
// many = 0: kernel 2's body on the shared V, each user's chunks over a
// cluster of `cluster` blocks of `threads`, a ring of `tile` (1-4)
// 128-item chunks a warp. A layout the kernel cannot run (too much shared
// memory, lane lists too short for k) is refused before any launch.
extern "C" int topk_shared_launch(const float* U, const float* V, const int8_t* mask,
                                  float* vals, int* idx, int R, int J, int K, int k, int many,
                                  int threads, int blocks, int slots, int tile, int cluster,
                                  int merge, void* stream) {
  if (threads % 32 != 0 || threads < 32) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!many) {
    const int bad = check_rows_layout(J, K, k, cluster, threads / 32, tile, slots, false);
    if (bad) return bad;
    const RowsArgs a{U, RowSource{V, nullptr, mask, nullptr, R, 0}, vals, idx, R, J, K, k,
                     cluster, threads / 32, tile, merge, s};
    return start_rows_slots<false>(slots, a);
  }
  const long long smem = 4LL * K * tile + static_cast<long long>(sizeof(MergeScratch));
  if (threads != kManyThreads || blocks < 1 || tile < 4 || tile % 4 != 0 || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k < 1 || k > TOPK_MAX || !slots_fit(slots, k, 4 * ((J + 127) / 128)))
    return static_cast<int>(cudaErrorInvalidValue);
  const SharedArgs a{U, V, mask, vals, idx, R, J, K, k, threads, blocks, tile, merge, s};
  if (slots == 4) return start_shared_many_k<4>(a);
  if (slots == 8) return start_shared_many_k<8>(a);
  return start_shared_many_k<16>(a);
}
