// Geo-pruned serving: per request, scores u·v over its candidate ids, pad
// (cand < 0) and seen masking, and the running top-k that carries global
// item ids. One kernel body, instantiated for five ways of finding a
// request's u, candidate ids, seen bits and candidate rows:
//
//   WindowF32        pre-gathered fp32 windows (R, Cw, K), seen (R, Cw).
//                    Replaces `_serve_topk_window_kernel`
//                    (src/repro/kernels/serve_topk.py:122, pallas_call :162).
//   Slab             whole per-request item slabs (R, J, K), seen (R, J);
//                    the candidates are gathered inside the kernel.
//                    Replaces `_serve_topk_kernel` (serve_topk.py:64,
//                    pallas_call :100).
//   SlabRows<kQ>     the same read in place from the serving engine's state:
//                    request r is user ids[r], whose u is U[id], whose slab
//                    is V[id] (with Q: v = V[id] + Q[id], each factor
//                    rounded on its own before the chain, as the gathered
//                    P[rows, safe] + Q[rows, safe] is), whose seen bits are
//                    seen[id] and whose candidate ids are
//                    bucket_items[user_bucket[id]]: the engine's pruned
//                    dispatch in one launch. Kernel 5 as the reference's
//                    compiled design describes it (V kept in HBM, only the
//                    candidate rows read; ops.py:159-175).
//   WindowQuant<T>   pre-gathered windows stored as int8 codes times a
//                    per-request f32 scale, or as bf16 (scale 1).
//   TiledQuant<T>    the same codes read in place from the tiled store:
//                    request r is user ids[r], whose u is U[id], whose
//                    codes, seen bits and scale are the store's rows at id,
//                    and whose candidate ids are bucket_items[user_bucket[id]].
//                    Both quant sources replace
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
// merge. In place the chain is one step longer: the id, then (together)
// u, the scale and the user's bucket, then the bucket's candidate ids
// with the seen bits and code rows; the six gathers it replaces were six
// launches. A slab's rows are found by the candidate's id, not its slot:
// the id, then its seen bit and row together (a seen candidate's row is
// read and dropped), so in place on the engine's state the chain is the
// id, the bucket (u beside it), the bucket's ids, the seen bits and rows,
// the merge: one launch where the engine's dispatch made seven.
//
// Design: `warps` warps per request, chosen by the wrapper from Cw (one
// for Cw ≤ 128, with several requests a block; ceil(Cw / 128) above, so a
// lane scores at most 4 candidates at the main shapes). A lane holds u in
// registers (K = 8 and 10, the slices' widths, are fixed at build time;
// other K read u and the row in place, a factor at a time), scores its
// strided candidates four at a time (in a window the four ids, seen bits
// and rows at once; in a slab the ids, then the seen bits and rows; all
// issued before any is used), and keeps a 4-, 8- or 16-slot list. A row
// is one contiguous run of loads of one width: fp32 rows 16 or 8 bytes a
// load where the rows are aligned; quant rows `wbytes` a load, the widest
// of 16, 8, 4, 2 and 1 that divides both the row's bytes and the address
// of the first row (int8 K=8: one 8-byte load; bf16 K=8: one 16-byte
// load; bf16 K=10, 20-byte rows: five 4-byte loads). One width for the launch keeps every
// lane on one path: a row size off 8 puts neighbouring rows on different
// alignments, and a head/body/tail split per row would diverge the warp.
// No byte outside the row is read. A warp merges its lanes' lists by the
// bitonic network of topk.cuh with no barrier, and a request of several
// warps takes one barrier. The TPU layout changes (K-major transpose,
// 128-lane padding) are not needed: windows stay (R, Cw, K), slabs
// (R, J, K), the store (I, cap, K).
//
// Bit-for-bit contracts, carried from the reference (serve_topk.py:42-46,
// ops.py:228-230):
// - the score is the same ascending-K fp32 FMA chain from 0.0f in every
//   form and layout, so the slab form, pre-gathered or in place, equals
//   the window form on windows gathered from the same rows (with Q, on
//   the gathered P + Q: each v factor is __fadd_rn(p, q) before the
//   chain), and the fp32 window form equals the kernel of the earlier
//   one-block-a-request design;
// - a quantized factor is dequantized as __fmul_rn(code, scale), rounded
//   on its own before the chain, so the quant form on (codes, scale)
//   equals the fp32 window form on codes.float() * scale, and the in-place
//   form equals the quant form on the gathered windows.
#include <cuda_bf16.h>

#include <type_traits>

#include "topk.cuh"

namespace {

constexpr int kMaxThreads = 512;   // 16 warps a block: up to 128 registers a thread
constexpr int kBatch = 4;          // candidates a lane loads before it scores them

// Each source gives `row(r)`, a view of request r with `ui` and `ci` (its
// rows of U and of the candidate ids), `seen(c, id)`,
// `fetch<KC>(c, id, buf)` (issue the loads of the row's KC factors),
// `unpack(buf, f)` (the factors as fp32, after the loads) and
// `score(u, c, id, K)` (K at run time), for candidate slot c holding item
// id >= 0. kBySlot: the seen bit and the row are found by the slot alone
// (a window), so they load beside the id.
template <int KC>
struct F32Buf {
  float f[KC];
};

struct WindowF32 {
  const float* Vw;
  const int8_t* seen_w;
  int Cw, K, vec;
  struct Row {
    long long ui, ci;
    const float* v;
    const int8_t* s;
    int K, vec;
    static constexpr bool kBySlot = true;
    template <int KC>
    using Buf = F32Buf<KC>;
    __device__ __forceinline__ bool seen(int c, int) const { return s[c] != 0; }
    __device__ __forceinline__ const float* at(int c, int) const { return v + (size_t)c * K; }
    template <int KC>
    __device__ __forceinline__ void fetch(int c, int id, Buf<KC>& b) const {
      load_row<KC>(at(c, id), b.f, vec);
    }
    template <int KC>
    __device__ __forceinline__ void unpack(const Buf<KC>& b, float (&f)[KC]) const {
#pragma unroll
      for (int j = 0; j < KC; ++j) f[j] = b.f[j];
    }
    __device__ __forceinline__ float score(const float* u_, int c, int id, int K_) const {
      return dot_chain(u_, at(c, id), K_);
    }
  };
  __device__ __forceinline__ Row row(int r) const {
    return {r, r, Vw + (size_t)r * Cw * K, seen_w + (size_t)r * Cw, K, vec};
  }
};

// A request's whole item slab (J rows of K factors; with kQ a second slab
// q, and v = v + q) and its J seen bits. 64-bit offsets throughout: R·J·K
// passes 2^31 at modest R. An id past the slab (id >= J) is no candidate
// and reads nothing.
template <int KC>
struct F32PairBuf {
  float f[KC], g[KC];
};

template <bool kQ>
struct SlabRow {
  long long ui, ci;
  const float* v;
  const float* q;
  const int8_t* s;
  int J, K, vec;
  static constexpr bool kBySlot = false;
  template <int KC>
  using Buf = std::conditional_t<kQ, F32PairBuf<KC>, F32Buf<KC>>;
  __device__ __forceinline__ bool has(int id) const { return id >= 0 && id < J; }
  __device__ __forceinline__ bool seen(int, int id) const { return !has(id) || s[id] != 0; }
  template <int KC>
  __device__ __forceinline__ void fetch(int, int id, Buf<KC>& b) const {
    load_row<KC>(v + (size_t)id * K, b.f, vec);
    if constexpr (kQ) load_row<KC>(q + (size_t)id * K, b.g, vec);
  }
  template <int KC>
  __device__ __forceinline__ void unpack(const Buf<KC>& b, float (&f)[KC]) const {
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      if constexpr (kQ) f[j] = __fadd_rn(b.f[j], b.g[j]);
      else f[j] = b.f[j];
    }
  }
  __device__ __forceinline__ float score(const float* u_, int, int id, int K_) const {
    const float* pv = v + (size_t)id * K_;
    if constexpr (kQ) {
      const float* pq = q + (size_t)id * K_;
      float acc = 0.f;
      for (int j = 0; j < K_; ++j)
        acc = __fmaf_rn(__ldg(u_ + j), __fadd_rn(__ldg(pv + j), __ldg(pq + j)), acc);
      return acc;
    } else {
      return dot_chain(u_, pv, K_);
    }
  }
};

// Pre-gathered: request r's slab is the r-th of V (R, J, K), seen (R, J).
struct Slab {
  using Row = SlabRow<false>;
  const float* V;
  const int8_t* seen_j;
  int J, K, vec;
  __device__ __forceinline__ Row row(int r) const {
    return {r, r, V + (size_t)r * J * K, nullptr, seen_j + (size_t)r * J, J, K, vec};
  }
};

// In place on the serving engine's state (the kernel's U is the engine's,
// its candidate ids the index's bucket rows): one load of the id, then the
// user's bucket, then in the body the bucket's candidate ids, then their
// seen bits and rows. An id outside [0, n_users), or a bucket outside
// [0, n_buckets), traps, as the gather it replaces would fault.
template <bool kQ>
struct SlabRows {
  using Row = SlabRow<kQ>;
  const long long* ids;
  const float* V;
  const float* Q;   // kQ only
  const int8_t* seen;
  const long long* user_bucket;
  int n_users, n_buckets, J, K, vec;
  __device__ __forceinline__ Row row(int r) const {
    const long long i = __ldg(ids + r);
    if (i < 0 || i >= n_users) __trap();
    const long long b = __ldg(user_bucket + i);
    if (b < 0 || b >= n_buckets) __trap();
    const size_t o = (size_t)i * J;
    return {i, b, V + o * K, kQ ? Q + o * K : nullptr, seen + o, J, K, vec};
  }
};

// A code's storage type and its exact fp32 value.
template <typename T>
struct Code;
template <>
struct Code<int8_t> {
  using Raw = signed char;
  __device__ static __forceinline__ float value(Raw x) { return static_cast<float>(x); }
};
template <>
struct Code<__nv_bfloat16> {
  using Raw = unsigned short;
  __device__ static __forceinline__ float value(Raw x) {
    return __bfloat162float(__ushort_as_bfloat16(x));
  }
};

// One candidate's KC codes as loaded: the same bytes seen as pieces of
// each load width and as codes.
template <typename Raw, int KC>
union CodeBuf {
  uint4 x16[(KC * sizeof(Raw) + 15) / 16];
  uint2 x8[(KC * sizeof(Raw) + 7) / 8];
  unsigned int x4[(KC * sizeof(Raw) + 3) / 4];
  unsigned short x2[(KC * sizeof(Raw) + 1) / 2];
  unsigned char x1[KC * sizeof(Raw)];
  Raw e[KC];
};

template <typename V, int N>
__device__ __forceinline__ void load_pieces(const void* p, V (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = __ldg(static_cast<const V*>(p) + i);
}

// A request's view of quantized rows, whichever source found them: u, the
// candidate ids, the codes of slot c at v + c·K, the seen bits, the scale.
template <typename T>
struct QuantRow {
  using Raw = typename Code<T>::Raw;
  long long ui, ci;
  const Raw* v;
  const int8_t* s;
  float scale;
  int K, wbytes;
  static constexpr bool kBySlot = true;
  template <int KC>
  using Buf = CodeBuf<Raw, KC>;
  __device__ __forceinline__ bool seen(int c, int) const { return s[c] != 0; }
  __device__ __forceinline__ float factor(Raw x) const {
    return __fmul_rn(Code<T>::value(x), scale);
  }
  // The row's KC·sizeof(Raw) bytes, wbytes a load (uniform over the launch).
  template <int KC>
  __device__ __forceinline__ void fetch(int c, int, Buf<KC>& b) const {
    constexpr int NB = KC * sizeof(Raw);
    const Raw* p = v + (size_t)c * KC;
    if constexpr (NB % 16 == 0)
      if (wbytes == 16) return load_pieces(p, b.x16);
    if constexpr (NB % 8 == 0)
      if (wbytes == 8) return load_pieces(p, b.x8);
    if constexpr (NB % 4 == 0)
      if (wbytes == 4) return load_pieces(p, b.x4);
    if constexpr (NB % 2 == 0)
      if (wbytes == 2) return load_pieces(p, b.x2);
    load_pieces(p, b.x1);
  }
  template <int KC>
  __device__ __forceinline__ void unpack(const Buf<KC>& b, float (&f)[KC]) const {
#pragma unroll
    for (int j = 0; j < KC; ++j) f[j] = factor(b.e[j]);
  }
  // K at run time: the same chain, one code at a time.
  __device__ __forceinline__ float score(const float* u_, int c, int, int K_) const {
    const Raw* p = v + (size_t)c * K_;
    float acc = 0.f;
    for (int j = 0; j < K_; ++j) acc = __fmaf_rn(__ldg(u_ + j), factor(__ldg(p + j)), acc);
    return acc;
  }
};

template <typename T>
struct WindowQuant {
  using Row = QuantRow<T>;
  const typename Row::Raw* Vq;
  const float* scale;
  const int8_t* seen_w;
  int Cw, K, wbytes;
  __device__ __forceinline__ Row row(int r) const {
    return {r, r, Vq + (size_t)r * Cw * K, seen_w + (size_t)r * Cw, scale[r], K, wbytes};
  }
};

// In place (the kernel's U is the store's, its candidate ids the
// bucket rows): one load of the id, then the loads that depend on it alone
// (u, the scale, the bucket), then in the body the bucket's candidate ids
// beside the seen bits and code rows. An id outside [0, n_users), or a
// bucket outside [0, n_buckets), traps, as the gather it replaces would
// fault.
template <typename T>
struct TiledQuant {
  using Row = QuantRow<T>;
  const long long* ids;
  const typename Row::Raw* Vq;
  const float* scale;   // nullptr: 1
  const int8_t* seen;
  const long long* user_bucket;
  int n_users, n_buckets, cap, K, wbytes;
  __device__ __forceinline__ Row row(int r) const {
    const long long i = __ldg(ids + r);
    if (i < 0 || i >= n_users) __trap();
    const long long b = __ldg(user_bucket + i);
    if (b < 0 || b >= n_buckets) __trap();
    return {i, b, Vq + i * cap * K, seen + i * cap, scale != nullptr ? __ldg(scale + i) : 1.f, K,
            wbytes};
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
    const int* crow = cand + row.ci * Cw;
    const float* u = U + row.ui * K;
    if constexpr (KC > 0) {
      float ur[KC];
#pragma unroll
      for (int j = 0; j < KC; ++j) ur[j] = __ldg(u + j);
      // kBatch of the lane's candidates at a time, all their loads issued
      // before any is used: in a window the ids, seen bits and rows at once
      // (a pad slot's row is read and dropped); in a slab the ids, then the
      // seen bits and rows together at the valid ids (a seen row is read
      // and dropped). Issuing a window's rows before its ids, so that in
      // place they need not wait for the bucket, was slower in every form
      // (PERF.md §6).
      for (int c0 = t; c0 < Cw; c0 += kBatch * per_request) {
        int id[kBatch];
        bool ok[kBatch];
        typename Src::Row::template Buf<KC> raw[kBatch];
        if constexpr (Src::Row::kBySlot) {
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            const int c = c0 + b * per_request;
            id[b] = c < Cw ? crow[c] : -1;
            ok[b] = c < Cw && !row.seen(c, 0);
            if (c < Cw) row.template fetch<KC>(c, 0, raw[b]);
          }
#pragma unroll
          for (int b = 0; b < kBatch; ++b) ok[b] = ok[b] && id[b] >= 0;
        } else {
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            const int c = c0 + b * per_request;
            id[b] = c < Cw ? crow[c] : -1;
          }
          bool seen[kBatch];
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            const int c = c0 + b * per_request;
            ok[b] = row.has(id[b]);
            seen[b] = true;
            if (ok[b]) {
              seen[b] = row.seen(c, id[b]);
              row.template fetch<KC>(c, id[b], raw[b]);
            }
          }
#pragma unroll
          for (int b = 0; b < kBatch; ++b) ok[b] = ok[b] && !seen[b];
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (!ok[b]) continue;
          float f[KC];
          row.unpack(raw[b], f);
          const float s = dot_chain(ur, f);
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

// The load width of quant rows of `row_bytes` bytes from `base`: the
// widest of 16, 8, 4, 2, 1 that divides both.
int code_wbytes(const void* base, int row_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  for (int w = 16; w > 1; w /= 2)
    if (a % w == 0 && row_bytes % w == 0) return w;
  return 1;
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

// In place on the serving engine's state: ids (R,) int64 user ids; U
// (n_users, K); V (n_users, J, K); Q (n_users, J, K), or null: no Q; seen
// (n_users, J); user_bucket (n_users,) int64; bucket_items (n_buckets, Cw)
// int32.
extern "C" int serve_topk_rows_launch(const long long* ids, const float* U, const float* V,
                                      const float* Q, const int8_t* seen,
                                      const long long* user_bucket, const int* bucket_items,
                                      float* vals, int* idx, int R, int n_users, int n_buckets,
                                      int J, int Cw, int K, int k, int warps, int rpb, int slots,
                                      int merge, void* stream) {
  const Launch a{U, bucket_items, vals, idx, R, Cw, K, k, warps, rpb, slots, merge,
                 static_cast<cudaStream_t>(stream)};
  if (Q != nullptr) {
    const int vec_v = row_vec(V, K), vec_q = row_vec(Q, K);
    return launch(a, SlabRows<true>{ids, V, Q, seen, user_bucket, n_users, n_buckets, J, K,
                                    vec_v < vec_q ? vec_v : vec_q});
  }
  return launch(a, SlabRows<false>{ids, V, nullptr, seen, user_bucket, n_users, n_buckets, J, K,
                                   row_vec(V, K)});
}

// bf16 != 0: Vq holds bf16 factors, else int8 codes.
extern "C" int serve_topk_window_quant_launch(const float* U, const void* Vq,
                                              const float* scale, const int* cand,
                                              const int8_t* seen, float* vals, int* idx, int R,
                                              int Cw, int K, int k, int bf16, int warps, int rpb,
                                              int slots, int merge, void* stream) {
  const Launch a{U, cand, vals, idx, R, Cw, K, k, warps, rpb, slots, merge,
                 static_cast<cudaStream_t>(stream)};
  const int wbytes = code_wbytes(Vq, K * (bf16 ? 2 : 1));
  if (bf16)
    return launch(a, WindowQuant<__nv_bfloat16>{static_cast<const unsigned short*>(Vq), scale,
                                                seen, Cw, K, wbytes});
  return launch(a, WindowQuant<int8_t>{static_cast<const signed char*>(Vq), scale, seen, Cw, K,
                                       wbytes});
}

// In place on the tiled store: ids (R,) int64 user ids; U (n_users, K);
// Vq (n_users, cap, K) codes; scale (n_users,) or null (1); seen
// (n_users, cap); user_bucket (n_users,) int64; bucket_items
// (n_buckets, cap) int32.
extern "C" int serve_topk_tiled_quant_launch(const long long* ids, const float* U,
                                             const void* Vq, const float* scale,
                                             const int8_t* seen, const long long* user_bucket,
                                             const int* bucket_items, float* vals, int* idx,
                                             int R, int n_users, int n_buckets, int cap, int K,
                                             int k, int bf16, int warps, int rpb, int slots,
                                             int merge, void* stream) {
  const Launch a{U, bucket_items, vals, idx, R, cap, K, k, warps, rpb, slots, merge,
                 static_cast<cudaStream_t>(stream)};
  const int wbytes = code_wbytes(Vq, K * (bf16 ? 2 : 1));
  if (bf16)
    return launch(a, TiledQuant<__nv_bfloat16>{ids, static_cast<const unsigned short*>(Vq), scale,
                                               seen, user_bucket, n_users, n_buckets, cap, K,
                                               wbytes});
  return launch(a, TiledQuant<int8_t>{ids, static_cast<const signed char*>(Vq), scale, seen,
                                      user_bucket, n_users, n_buckets, cap, K, wbytes});
}
