// Random-walk propagation mixing Y = M @ X (Alg. 1 lines 13-15 over every
// learner at once): M (I, I) is the walk-propagation matrix, X (I, F) the
// flattened per-learner global factors, fp32 in and out, fp32 accumulate.
//
// Replaces the TPU kernel `_mix_kernel` (src/repro/kernels/gossip_mix.py:22,
// pallas_call at :42), a 128-cubed MXU tiling whose (bm, bn) accumulator
// stays in the output block across the in-order k grid axis.
//
// Every route computes each Y[i, f] as ONE fp32 FMA chain over k in
// ascending order, starting from 0: acc = fmaf(M[i, k], X[k, f], acc). A
// zero of M adds exactly nothing to that chain when X[k, f] is finite
// (fmaf(0, x, acc) == acc, up to the sign of a zero), so the two routes
// below give the same bits for finite X. No TF32, no tensor cores, no
// split-k: each would change the order or the precision of the sum.
//
// Two routes, chosen by the wrapper (kernels/gossip_mix.py):
//
// * Sparse, for M as sparse as the walk matrix (6,524², 60,374 nonzeros,
//   at most 21 a row). `mix_count_kernel` reads M once and counts each
//   row's nonzeros; its other blocks check X for non-finite values (0·Inf
//   is NaN in the plain product, and this route skips the zeros).
//   `mix_scan_kernel` turns the counts into row offsets and the total. The
//   host reads back {nonzeros, non-finite flag} — one 16-byte copy — and
//   takes this route only when X is finite and nonzeros·16 ≤ I². Then
//   `mix_fill_kernel` writes each row's nonzero columns and values in
//   ascending column order (CSR) and `mix_spmm_kernel` forms each Y row as
//   the FMA chain over those X rows. Bound at the walk shape by bytes: M
//   170 MB read, X 834 MB read once, Y 834 MB written: 0.50 ms at 3.35 TB/s
//   (the dense product's 2.72 TFLOP would take 40.6 ms). The gathered X
//   reads (nnz·F·4 = 7.7 GB) must come from L2: a block covers 32 rows × a
//   strip of 128 columns, and row blocks vary fastest in the grid, so the
//   blocks in flight share a few strips (3.3 MB of X each) and each strip
//   is read from HBM about once.
//   Threshold: a nonzero costs F gathered loads (4 bytes each, from L2 at a
//   few TB/s) where the dense product spends 2·I·F operations per row of M
//   at tens of TFLOP/s; at a density of 1/16 the two meet within a factor
//   of two, and below it the sparse route wins. The CSR arrays need
//   8 bytes a nonzero.
// * Dense, for everything else (phase 2's random M, the 512 micro-bench,
//   non-finite X, and products too small to be worth the count's host
//   round trip, which the wrapper sends here without counting). A
//   register-tiled SGEMM on the CUDA cores with a cp.async pipeline,
//   16-byte copies where the rows are 16-byte aligned (4-byte copies with
//   zero fill otherwise). Tiles of 64×64 (4×4 a thread, 256 threads, k
//   slices of 64, 2 stages in 64 KB of dynamic shared memory; fewer,
//   longer slices mean fewer barriers): at 512 × 512 @ 512 × 1024 a
//   128×128 tile would launch 32 blocks on 132 SMs, this one launches 128.
//   Bound by operations: 537 MFLOP at 67 TFLOP/s is 8.0 us.
//
// Offsets are size_t: I·F passes 2^31 at modest sizes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ------------------------------------------------------------ sparse route
constexpr int kCountThreads = 256;
constexpr int kCheckBlocks = 1056;    // 8 blocks a SM over 132 SMs
constexpr int kScanThreads = 1024;
constexpr int kFillThreads = 256;
constexpr int kStrip = 128;           // Y columns a warp covers (4 a lane)
constexpr int kRowsPerWarp = 4;
constexpr int kSpmmWarps = 8;
constexpr int kRowsPerBlock = kRowsPerWarp * kSpmmWarps;

__device__ __forceinline__ int block_sum(int v, int* s_warp) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += s_warp[w];
  return total;
}

// Blocks [0, I): nonzeros of row blockIdx.x of M. Blocks [I, I + kCheckBlocks):
// set status[1] if any X value is not finite (status is zeroed by the caller).
__global__ void __launch_bounds__(kCountThreads)
mix_count_kernel(const float* __restrict__ M, const float* __restrict__ X, int I,
                 size_t nx, int* __restrict__ counts, long long* __restrict__ status) {
  __shared__ int s_warp[kCountThreads / 32];
  if (static_cast<int>(blockIdx.x) < I) {
    const float* row = M + (size_t)blockIdx.x * I;
    int c = 0;
    if ((I & 3) == 0 && (reinterpret_cast<uintptr_t>(M) & 15) == 0) {
      const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll 4
      for (int k = threadIdx.x; k < (I >> 2); k += kCountThreads) {
        const float4 v = __ldg(r4 + k);
        c += (v.x != 0.f) + (v.y != 0.f) + (v.z != 0.f) + (v.w != 0.f);
      }
    } else {
#pragma unroll 4
      for (int k = threadIdx.x; k < I; k += kCountThreads) c += __ldg(row + k) != 0.f;
    }
    const int total = block_sum(c, s_warp);
    if (threadIdx.x == 0) counts[blockIdx.x] = total;
    return;
  }
  const size_t stride = (size_t)(gridDim.x - I) * kCountThreads;
  bool bad = false;
  if ((reinterpret_cast<uintptr_t>(X) & 15) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(X);
    const size_t n4 = nx >> 2;
#pragma unroll 4
    for (size_t e = (size_t)(blockIdx.x - I) * kCountThreads + threadIdx.x; e < n4; e += stride) {
      const float4 v = __ldg(x4 + e);
      bad |= !(isfinite(v.x) && isfinite(v.y) && isfinite(v.z) && isfinite(v.w));
    }
    for (size_t e = (n4 << 2) + (blockIdx.x - I) * (size_t)kCountThreads + threadIdx.x; e < nx;
         e += stride)
      bad |= !isfinite(__ldg(X + e));
  } else {
#pragma unroll 4
    for (size_t e = (size_t)(blockIdx.x - I) * kCountThreads + threadIdx.x; e < nx; e += stride)
      bad |= !isfinite(__ldg(X + e));
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0)
    atomicOr(reinterpret_cast<unsigned long long*>(status + 1), 1ull);
}

// One block: row_ptr = exclusive scan of counts (I + 1 entries), status[0] = total.
__global__ void __launch_bounds__(kScanThreads)
mix_scan_kernel(const int* __restrict__ counts, int I, long long* __restrict__ row_ptr,
                long long* __restrict__ status) {
  __shared__ long long s[kScanThreads];
  const int per = (I + kScanThreads - 1) / kScanThreads;
  const int b = min(static_cast<int>(threadIdx.x) * per, I), e = min(b + per, I);
  long long sum = 0;
  for (int i = b; i < e; ++i) sum += counts[i];
  s[threadIdx.x] = sum;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const long long v = threadIdx.x >= off ? s[threadIdx.x - off] : 0;
    __syncthreads();
    s[threadIdx.x] += v;
    __syncthreads();
  }
  long long run = s[threadIdx.x] - sum;
  for (int i = b; i < e; ++i) {
    row_ptr[i] = run;
    run += counts[i];
  }
  if (threadIdx.x == kScanThreads - 1) {
    row_ptr[I] = s[kScanThreads - 1];
    status[0] = s[kScanThreads - 1];
  }
}

// One block a row: its nonzero columns and values, in ascending column order.
__global__ void __launch_bounds__(kFillThreads)
mix_fill_kernel(const float* __restrict__ M, int I, const long long* __restrict__ row_ptr,
                int* __restrict__ col, float* __restrict__ val) {
  __shared__ int s_warp[kFillThreads / 32];
  const float* row = M + (size_t)blockIdx.x * I;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long out = row_ptr[blockIdx.x];
  float next = static_cast<int>(threadIdx.x) < I ? __ldg(row + threadIdx.x) : 0.f;
  for (int k0 = 0; k0 < I; k0 += kFillThreads) {
    const int k = k0 + static_cast<int>(threadIdx.x);
    const float v = next;
    const int kn = k + kFillThreads;
    next = kn < I ? __ldg(row + kn) : 0.f;               // the next chunk, in flight
    const bool nz = v != 0.f;
    const unsigned bal = __ballot_sync(0xffffffffu, nz);
    if (lane == 0) s_warp[warp] = __popc(bal);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kFillThreads / 32; ++w) {
      const int n = s_warp[w];
      before += w < warp ? n : 0;
      total += n;
    }
    if (nz) {
      const long long o = out + before + __popc(bal & ((1u << lane) - 1u));
      col[o] = k;
      val[o] = v;
    }
    out += total;
    __syncthreads();
  }
}

// A warp forms kRowsPerWarp rows of Y over one strip of kStrip columns:
// for each nonzero (ascending column), broadcast (col, val) from the lane
// that loaded it and FMA the X row's strip into 4 accumulators a lane.
__global__ void __launch_bounds__(kSpmmWarps * 32)
mix_spmm_kernel(const long long* __restrict__ row_ptr, const int* __restrict__ col,
                const float* __restrict__ val, const float* __restrict__ X,
                float* __restrict__ Y, int I, int F, int n_strips) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int strip = blockIdx.y; strip < n_strips; strip += gridDim.y) {
    const int f0 = strip * kStrip + lane;
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int i = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp + rr;
      if (i >= I) break;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const long long b = row_ptr[i], e = row_ptr[i + 1];
      for (long long c0 = b; c0 < e; c0 += 32) {
        const int n = static_cast<int>(e - c0 < 32 ? e - c0 : 32);
        int my_col = 0;
        float my_val = 0.f;
        if (lane < n) {
          my_col = col[c0 + lane];
          my_val = val[c0 + lane];
        }
#pragma unroll 4
        for (int j = 0; j < n; ++j) {
          const int k = __shfl_sync(0xffffffffu, my_col, j);
          const float m = __shfl_sync(0xffffffffu, my_val, j);
          const float* xr = X + (size_t)k * F;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int f = f0 + 32 * q;
            if (f < F) acc[q] = fmaf(m, __ldg(xr + f), acc[q]);
          }
        }
      }
      float* yr = Y + (size_t)i * F;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (f0 + 32 * q < F) yr[f0 + 32 * q] = acc[q];
    }
  }
}

// ------------------------------------------------------------- dense route
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Block tile BM×BN of Y, TM×TN a thread: rows ty + m·(BM/TM), columns in
// groups of 4, (tx + g·(BN/TN))·4 + j, so that a warp's shared loads are
// two broadcast rows of M and 16 consecutive float4 of X. k advances in
// slices of BK, STAGES slices in flight.
constexpr int BM = 64, BN = 64, TM = 4, TN = 4, BK = 64, STAGES = 2;
constexpr int kThreads = (BM / TM) * (BN / TN);
constexpr int kDenseBytes = STAGES * (BM * BK + BK * BN) * 4;   // 64 KB
static_assert(TN % 4 == 0 && BK % 4 == 0, "float4 groups");
static_assert((BM * BK / 4) % kThreads == 0 && (BK * BN / 4) % kThreads == 0, "even copies");

// kVec: I and F are multiples of 4 (16-byte copies); else 4-byte copies,
// each predicated.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
mix_dense_kernel(const float* __restrict__ M, const float* __restrict__ X,
                 float* __restrict__ Y, int I, int F) {
  constexpr int kRowT = BM / TM, kColT = BN / TN, kGroups = TN / 4;
  extern __shared__ __align__(16) float s_dyn[];   // the ring of slices: kDenseBytes
  auto s_m = reinterpret_cast<float (*)[BM][BK]>(s_dyn);
  auto s_x = reinterpret_cast<float (*)[BK][BN]>(s_dyn + STAGES * BM * BK);
  const int tid = threadIdx.x, tx = tid % kColT, ty = tid / kColT;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int nk = (I + BK - 1) / BK;

  auto load = [&](int stage, int k0) {
    if constexpr (kVec) {
#pragma unroll
      for (int e = tid; e < BM * BK / 4; e += kThreads) {
        const int r = e / (BK / 4), kc = (e % (BK / 4)) * 4;
        const int gr = row0 + r, gk = k0 + kc;
        const bool ok = gr < I && gk < I;
        cp_async16(&s_m[stage][r][kc], ok ? M + (size_t)gr * I + gk : M, ok);
      }
#pragma unroll
      for (int e = tid; e < BK * BN / 4; e += kThreads) {
        const int kk = e / (BN / 4), c = (e % (BN / 4)) * 4;
        const int gk = k0 + kk, gc = col0 + c;
        const bool ok = gk < I && gc < F;
        cp_async16(&s_x[stage][kk][c], ok ? X + (size_t)gk * F + gc : X, ok);
      }
    } else {
#pragma unroll
      for (int e = tid; e < BM * BK; e += kThreads) {
        const int r = e / BK, kk = e % BK;
        const int gr = row0 + r, gk = k0 + kk;
        const bool ok = gr < I && gk < I;
        cp_async4(&s_m[stage][r][kk], ok ? M + (size_t)gr * I + gk : M, ok);
      }
#pragma unroll
      for (int e = tid; e < BK * BN; e += kThreads) {
        const int kk = e / BN, c = e % BN;
        const int gk = k0 + kk, gc = col0 + c;
        const bool ok = gk < I && gc < F;
        cp_async4(&s_x[stage][kk][c], ok ? X + (size_t)gk * F + gc : X, ok);
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                    // slice kt landed; slice kt-1's stage is free
    const int nt = kt + STAGES - 1;
    if (nt < nk) load(nt % STAGES, nt * BK);
    cp_async_commit();
    const int st = kt % STAGES;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float4 a4[TM];
#pragma unroll
      for (int m = 0; m < TM; ++m)
        a4[m] = *reinterpret_cast<const float4*>(&s_m[st][ty + m * kRowT][kq]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float b[TN];
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const float4 b4 = *reinterpret_cast<const float4*>(&s_x[st][kq + j][(tx + g * kColT) * 4]);
          b[4 * g] = b4.x;
          b[4 * g + 1] = b4.y;
          b[4 * g + 2] = b4.z;
          b[4 * g + 3] = b4.w;
        }
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          const float a = lane_of(a4[m], j);
#pragma unroll
          for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(a, b[n], acc[m][n]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int gr = row0 + ty + m * kRowT;
    if (gr >= I) continue;
    float* yr = Y + (size_t)gr * F;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int gc = col0 + (tx + g * kColT) * 4;
      if constexpr (kVec) {
        if (gc < F)
          *reinterpret_cast<float4*>(yr + gc) =
              make_float4(acc[m][4 * g], acc[m][4 * g + 1], acc[m][4 * g + 2], acc[m][4 * g + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gc + j < F) yr[gc + j] = acc[m][4 * g + j];
      }
    }
  }
}

template <bool kVec>
int launch_dense(const float* M, const float* X, float* Y, int I, int F, cudaStream_t s) {
  static bool allowed[64] = {};     // per device: the opt-in above 48 KB is made once
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!(dev < 64 && allowed[dev])) {
    e = cudaFuncSetAttribute(mix_dense_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDenseBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) allowed[dev] = true;
  }
  const dim3 grid((F + BN - 1) / BN, (I + BM - 1) / BM);
  mix_dense_kernel<kVec><<<grid, kThreads, kDenseBytes, s>>>(M, X, Y, I, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Route selection, step 1: per-row nonzeros of M, row offsets, and
// status = {total nonzeros, X has a non-finite value}. ``status`` must be
// zeroed by the caller.
extern "C" int gossip_mix_count_launch(const float* M, const float* X, int I, int F,
                                       int* counts, long long* row_ptr, long long* status,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  mix_count_kernel<<<I + kCheckBlocks, kCountThreads, 0, s>>>(M, X, I, (size_t)I * F, counts,
                                                               status);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mix_scan_kernel<<<1, kScanThreads, 0, s>>>(counts, I, row_ptr, status);
  return static_cast<int>(cudaGetLastError());
}

// The sparse route, after the count: CSR fill, then Y row by row.
extern "C" int gossip_mix_sparse_launch(const float* M, const float* X, float* Y, int I, int F,
                                        const long long* row_ptr, int* col, float* val,
                                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  mix_fill_kernel<<<I, kFillThreads, 0, s>>>(M, I, row_ptr, col, val);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_strips = (F + kStrip - 1) / kStrip;
  const dim3 grid((I + kRowsPerBlock - 1) / kRowsPerBlock, n_strips < 65535 ? n_strips : 65535);
  mix_spmm_kernel<<<grid, kSpmmWarps * 32, 0, s>>>(row_ptr, col, val, X, Y, I, F, n_strips);
  return static_cast<int>(cudaGetLastError());
}

// The dense route.
extern "C" int gossip_mix_dense_launch(const float* M, const float* X, float* Y, int I, int F,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (I % 4 == 0) && (F % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(M) | reinterpret_cast<uintptr_t>(X) |
                     reinterpret_cast<uintptr_t>(Y)) & 15) == 0;
  return vec ? launch_dense<true>(M, X, Y, I, F, s) : launch_dense<false>(M, X, Y, I, F, s);
}
