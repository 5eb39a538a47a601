// Random-walk propagation mixing Y = M @ X (Alg. 1 lines 13-15 over every
// learner at once): M (I, I) is the walk-propagation matrix, X (I, F) the
// flattened per-learner global factors, fp32 in and out, fp32 accumulate.
//
// Replaces the TPU kernel `_mix_kernel` (src/repro/kernels/gossip_mix.py:22,
// pallas_call at :42), a 128-cubed MXU tiling whose (bm, bn) accumulator
// stays in the output block across the in-order k grid axis.
//
// Bound at the Foursquare shape (I=6,524, F=31,970 = 3,197 POIs × K=10):
// operations. 2·I·I·F = 2.72 TFLOP is 40.6 ms at 67 TFLOP/s fp32; the
// bytes (M 170 MB, X and Y 834 MB each) take 0.55 ms at 3.35 TB/s. At the
// micro-bench shape (512 × 512 @ 512 × 1024) 537 MFLOP take 8.0 us.
//
// Design: a classic register-tiled SGEMM on the CUDA cores, simple first.
// A block of 256 threads owns a 128×128 tile of Y and walks k in slices of
// 8: it stages the M slice (transposed, padded by 4 floats a row against
// bank conflicts) and the X slice in shared memory, and each thread keeps
// an 8×8 micro-tile of Y in registers, rows ty + 16·m and columns tx + 16·n
// so that neighbouring threads read neighbouring shared words. Every
// product is one FMA into the running sum, in ascending k: a zero of M adds
// exactly nothing. No TF32 and no tensor cores: TF32 would move Y by more
// than the reference's 1e-4. The ragged I and F edges are predicated (a
// load past the edge reads 0, a store past it is skipped), where the TPU
// wrapper padded both to 128 (src/repro/kernels/ops.py:130-137). Offsets
// are size_t: I·F passes 2^31 at modest sizes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 8;   // block tile of Y, k slice
constexpr int kTM = 8, kTN = 8;                 // a thread's micro-tile
constexpr int kRowsT = kBM / kTM, kColsT = kBN / kTN;
constexpr int kMixThreads = kRowsT * kColsT;    // 256
constexpr int kPad = 4;
static_assert(kBM * kBK % kMixThreads == 0 && kBK * kBN % kMixThreads == 0, "even loads");

__global__ void __launch_bounds__(kMixThreads)
gossip_mix_kernel(const float* __restrict__ M, const float* __restrict__ X,
                  float* __restrict__ Y, int I, int F) {
  __shared__ float s_m[kBK][kBM + kPad];   // M slice, transposed: s_m[k][row]
  __shared__ float s_x[kBK][kBN];          // X slice: s_x[k][col]
  const int tid = threadIdx.x;
  const int tx = tid % kColsT;
  const int ty = tid / kColsT;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int n = 0; n < kTN; ++n) acc[m][n] = 0.f;

  for (int k0 = 0; k0 < I; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kBM * kBK / kMixThreads; ++i) {
      const int e = tid + i * kMixThreads;
      const int m = e / kBK, kk = e % kBK;      // a warp: 4 rows × 8 consecutive k
      const int gr = row0 + m, gk = k0 + kk;
      s_m[kk][m] = (gr < I && gk < I) ? M[(size_t)gr * I + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBK * kBN / kMixThreads; ++i) {
      const int e = tid + i * kMixThreads;
      const int kk = e / kBN, n = e % kBN;      // a warp: 32 consecutive columns
      const int gk = k0 + kk, gc = col0 + n;
      s_x[kk][n] = (gk < I && gc < F) ? X[(size_t)gk * F + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int m = 0; m < kTM; ++m) a[m] = s_m[kk][ty + m * kRowsT];
#pragma unroll
      for (int n = 0; n < kTN; ++n) b[n] = s_x[kk][tx + n * kColsT];
#pragma unroll
      for (int m = 0; m < kTM; ++m)
#pragma unroll
        for (int n = 0; n < kTN; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    const int gr = row0 + ty + m * kRowsT;
    if (gr >= I) continue;
#pragma unroll
    for (int n = 0; n < kTN; ++n) {
      const int gc = col0 + tx + n * kColsT;
      if (gc < F) Y[(size_t)gr * F + gc] = acc[m][n];
    }
  }
}

}  // namespace

extern "C" int gossip_mix_launch(const float* M, const float* X, float* Y, int I, int F,
                                 void* stream) {
  const dim3 grid((F + kBN - 1) / kBN, (I + kBM - 1) / kBM);
  gossip_mix_kernel<<<grid, kMixThreads, 0, static_cast<cudaStream_t>(stream)>>>(M, X, Y, I, F);
  return static_cast<int>(cudaGetLastError());
}
