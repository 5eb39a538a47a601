// Fused Alg. 1 step (paper Eqs. 9-11) over a minibatch of gathered rows:
//   v = p + q, raw = r − Σ u·v, err = c·raw
//   du = −θ(−err·v + αu), gp = −err·u + βp, dq = −θ(−err·u + γq)
//   loss = ½ Σ c·raw²
// and its DP form, which also clips each outgoing message row to C and adds
// the row's pre-scaled noise z:
//   gp ← gp · min(1, C / ‖gp‖₂) + z
// and the gradients alone (no θ, no loss):
//   gu = −err·v + αu, gp = −err·u + βp, gq = −err·u + γq
//
// Replaces the TPU kernels `_dmf_fused_step_kernel`
// (src/repro/kernels/dmf_update.py:61, pallas_call at :181),
// `_dmf_fused_step_dp_kernel` (dmf_update.py:92, pallas_call at :148) and
// `_dmf_grads_kernel` (dmf_update.py:22, pallas_call at :50).
//
// Bound at the slices' shapes (B=256 rows, K=10): memory, and far below
// the launch cost. A launch reads u/p/q (30 KB) and r/conf (2 KB) and
// writes du/gp/dq (30 KB) and the loss: about 64 KB, 0.02 us at 3.35 TB/s;
// the DP form also reads z (10 KB): about 74 KB, 0.022 us. Its
// ~18·B·K = 46 kFLOP are nothing.
//
// Design: one launch. A block takes 256 rows. It first stages its
// rows of u/p/q (and z) into shared memory with coalesced copies, 16 bytes
// a thread where the rows are aligned, all of them issued before any is
// used. Then one thread a row computes only the row's err (and, with DP,
// its clip scale) into shared memory, and one thread an element computes
// the deltas and writes them out coalesced. Rows too wide for 46 KB of
// staging (K > 11 with z, K > 15 without) are read in place from global
// memory by the same code. K = 10, the paper's width, is fixed at build
// time so that the row loops unroll whole.
// The arithmetic is fixed expression for expression: a sequential
// ascending-c dot, one line per delta, `__fmul_rn`/`__fadd_rn` in the DP
// branch. So is the loss: each group of 128 rows is summed by one
// shared-memory tree (halving strides from 64), and the group partials are
// added in index order from 0, then halved. With one block (B <= 256: the
// training and ingest batches) thread 0 adds its block's partials; with
// more, each block writes its partials, `__threadfence`s, and takes an
// integer ticket; the last block adds all partials in index order and
// resets the ticket for the next launch. No float atomics: the loss is
// the same bits on every run, and does not depend on how many blocks the
// batch takes. The ticket and the partials live in a scratch buffer the
// wrapper keeps per device and stream, zeroed once. The DP branch computes
// each gp entry twice (for the row norm, then for the output) with the
// same expression, and rounds the clip and the noise add separately (no
// FMA), as the reference's two fp32 operations do.
//
// The gradients-only kernel (`dmf_grads_kernel`) is a separate __global__,
// not a third instance of the step's template, so kernels 3 and 7 do not
// depend on it. At B=256, K=10 it reads u/p/q and r/conf (32 KB) and
// writes gu/gp/gq (30 KB): 0.019 us at 3.35 TB/s; at the micro-bench
// shape (B=2048, K=16) 0.8 MB, 0.24 us. Both far below the launch, so the
// chain of dependent steps sets the time. Kernel 3's split of the work
// without its staging: a block of 128 threads takes `rows` rows (chosen on
// the host, `dmf_update.grads_layout`: 32), one thread a row reads its row
// and forms the row's err, and after one barrier one thread an element
// writes gu/gp/gq coalesced, its reads of u/p/q hitting the lines the row
// reads brought into L1. Staging the rows through shared memory first, as
// kernel 3 does, was 0.4 us slower at both shapes (a second barrier and the
// shared-memory round trip; PERF.md §6). K = 10 and 16 (the slices' and
// the micro-bench's widths) are fixed at build time. Its residual and its
// three expressions are written as kernel 3 writes its own, so nvcc
// contracts them alike: gp is kernel 3's gp, and −θ·gu, −θ·gq are kernel
// 3's du, dq, up to the one rounding of the θ product. The TPU wrapper
// padded B to 256 and K to 128 (src/repro/kernels/ops.py:35-45); here B is
// the loop bound and K the row length, and nothing is padded.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGradThreads = 128;     // dmf_grads_kernel: threads a block, at most its rows
constexpr int kLossGroup = 128;       // rows a loss partial sums (one tree)
constexpr int kStepRows = 256;        // rows and threads a block of the step
constexpr int kGroupsPerBlock = kStepRows / kLossGroup;
constexpr int kStageBytes = 46 * 1024;  // + the static 1 KB: under the 48 KB default

// Copies n floats of each of NA arrays from global to shared memory with
// the whole block: every copy of a round is issued before any is stored.
template <int NA>
__device__ __forceinline__ void stage_in(float* const (&dst)[NA], const float* const (&src)[NA],
                                         int n) {
  bool aligned = (n & 3) == 0;
#pragma unroll
  for (int a = 0; a < NA; ++a)
    aligned &= ((reinterpret_cast<uintptr_t>(src[a]) | reinterpret_cast<uintptr_t>(dst[a])) &
                15) == 0;
  constexpr int kRound = 4;
  if (aligned) {
    const int n4 = n >> 2;
    for (int base = threadIdx.x; base < n4; base += kRound * kStepRows) {
      float4 v[kRound][NA];
#pragma unroll
      for (int j = 0; j < kRound; ++j)
#pragma unroll
        for (int a = 0; a < NA; ++a)
          if (base + j * kStepRows < n4)
            v[j][a] = __ldg(reinterpret_cast<const float4*>(src[a]) + base + j * kStepRows);
#pragma unroll
      for (int j = 0; j < kRound; ++j)
#pragma unroll
        for (int a = 0; a < NA; ++a)
          if (base + j * kStepRows < n4)
            reinterpret_cast<float4*>(dst[a])[base + j * kStepRows] = v[j][a];
    }
  } else {
    for (int base = threadIdx.x; base < n; base += kRound * kStepRows) {
      float v[kRound][NA];
#pragma unroll
      for (int j = 0; j < kRound; ++j)
#pragma unroll
        for (int a = 0; a < NA; ++a)
          if (base + j * kStepRows < n) v[j][a] = __ldg(src[a] + base + j * kStepRows);
#pragma unroll
      for (int j = 0; j < kRound; ++j)
#pragma unroll
        for (int a = 0; a < NA; ++a)
          if (base + j * kStepRows < n) dst[a][base + j * kStepRows] = v[j][a];
    }
  }
}

// scratch: [0] the ticket (an unsigned int, 0 between launches), then one
// loss partial per group of 128 rows; unused when the batch is one block.
template <bool kDP, int KC>
__global__ void __launch_bounds__(kStepRows)
dmf_fused_step_kernel(const float* __restrict__ u, const float* __restrict__ p,
                      const float* __restrict__ q, const float* __restrict__ r,
                      const float* __restrict__ conf, const float* __restrict__ z,
                      float* __restrict__ du, float* __restrict__ gp,
                      float* __restrict__ dq, float* __restrict__ scratch,
                      float* __restrict__ loss, int B, int K, float theta, float alpha,
                      float beta, float gamma, float clip, int staged) {
  extern __shared__ __align__(16) float s_rows[];
  __shared__ float s_loss[kStepRows];
  __shared__ float s_err[kStepRows];
  __shared__ float s_scale[kDP ? kStepRows : 1];
  __shared__ bool s_last;
  if constexpr (KC > 0) K = KC;
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * kStepRows;
  const int n_rows = min(kStepRows, B - row0);
  const size_t o0 = (size_t)row0 * K;
  const int span = kStepRows * K;
  // r and conf are read straight into registers, in flight with the staging
  const float rb = t < n_rows ? __ldg(r + row0 + t) : 0.f;
  const float cb = t < n_rows ? __ldg(conf + row0 + t) : 0.f;
  if (staged) {
    float* const su = s_rows;
    if constexpr (kDP) {
      float* const dst[4] = {su, su + span, su + 2 * span, su + 3 * span};
      const float* const src[4] = {u + o0, p + o0, q + o0, z + o0};
      stage_in<4>(dst, src, n_rows * K);
    } else {
      float* const dst[3] = {su, su + span, su + 2 * span};
      const float* const src[3] = {u + o0, p + o0, q + o0};
      stage_in<3>(dst, src, n_rows * K);
    }
    __syncthreads();
  }
  // the block's rows: in shared memory when staged, else in place
  const float* const bu = staged ? s_rows : u + o0;
  const float* const bp = staged ? s_rows + span : p + o0;
  const float* const bq = staged ? s_rows + 2 * span : q + o0;
  const float* const bz = kDP ? (staged ? s_rows + 3 * span : z + o0) : nullptr;
  // one thread a row: its residual (and, with DP, its clip scale)
  float l = 0.f;
  if (t < n_rows) {
    const float* ur = bu + t * K;
    const float* pr = bp + t * K;
    const float* qr = bq + t * K;
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < K; ++c) dot += ur[c] * (pr[c] + qr[c]);
    const float raw = rb - dot;
    const float err = cb * raw;
    s_err[t] = err;
    if constexpr (kDP) {
      float ss = 0.f;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const float g = -err * ur[c] + beta * pr[c];
        ss += g * g;
      }
      const float ratio = clip / sqrtf(ss);             // inf/0 -> scale 1
      s_scale[t] = ratio >= 1.f ? 1.f : ratio;          // NaN stays NaN
    }
    l = cb * raw * raw;
  }
  s_loss[t] = l;
  __syncthreads();
  // one thread an element: the deltas, read and written coalesced
  const int n = n_rows * K;
#pragma unroll 2
  for (int e = t; e < n; e += kStepRows) {
    const int row = e / K;
    const float err = s_err[row];
    const float uc = bu[e], pc = bp[e], qc = bq[e];
    du[o0 + e] = -theta * (-err * (pc + qc) + alpha * uc);
    if constexpr (kDP) {
      const float g = -err * uc + beta * pc;
      gp[o0 + e] = __fadd_rn(__fmul_rn(g, s_scale[row]), bz[e]);
    } else {
      gp[o0 + e] = -err * uc + beta * pc;
    }
    dq[o0 + e] = -theta * (-err * uc + gamma * qc);
  }
  // the tree over each group of 128: strides 64 and 32 across warps in
  // shared memory, 16 to 1 inside the group's first warp by shuffles (the
  // same pairs, so the same sums)
  const int g = t % kLossGroup;
  if (g < 64) s_loss[t] += s_loss[t + 64];
  __syncthreads();
  if (g < 32) {
    float v = s_loss[t] + s_loss[t + 32];
#pragma unroll
    for (int half = 16; half > 0; half >>= 1) v += __shfl_down_sync(0xffffffffu, v, half);
    if (g == 0) s_loss[t] = v;
  }
  __syncthreads();
  const int n_groups = (B + kLossGroup - 1) / kLossGroup;
  if (gridDim.x == 1) {
    if (t == 0) {
      float s = 0.f;
      for (int i = 0; i < n_groups; ++i) s += s_loss[i * kLossGroup];
      loss[0] = 0.5f * s;
    }
    return;
  }
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
  float* partial = scratch + 1;
  if (t < kGroupsPerBlock) {
    const int i = blockIdx.x * kGroupsPerBlock + t;
    if (i < n_groups) partial[i] = s_loss[t * kLossGroup];
    __threadfence();
  }
  __syncthreads();
  if (t == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (s_last && t == 0) {
    __threadfence();
    float s = 0.f;
    for (int i = 0; i < n_groups; ++i) s += __ldcg(partial + i);
    loss[0] = 0.5f * s;
    *ticket = 0u;
  }
}

// A block takes `rows` (<= kGradThreads) rows from blockIdx.x · rows.
template <int KC>
__global__ void __launch_bounds__(kGradThreads)
dmf_grads_kernel(const float* __restrict__ u, const float* __restrict__ p,
                 const float* __restrict__ q, const float* __restrict__ r,
                 const float* __restrict__ conf, float* __restrict__ gu,
                 float* __restrict__ gp, float* __restrict__ gq, int B, int K, int rows,
                 float alpha, float beta, float gamma) {
  __shared__ float s_err[kGradThreads];
  if constexpr (KC > 0) K = KC;
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * rows;
  const int n_rows = min(rows, B - row0);
  const size_t o0 = (size_t)row0 * K;
  const float* const bu = u + o0;
  const float* const bp = p + o0;
  const float* const bq = q + o0;
  // one thread a row: its residual, r and conf in flight with the row
  if (t < n_rows) {
    const float rb = __ldg(r + row0 + t), cb = __ldg(conf + row0 + t);
    const int o = t * K;
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < K; ++c) dot += bu[o + c] * (bp[o + c] + bq[o + c]);
    const float raw = rb - dot;
    s_err[t] = cb * raw;
  }
  __syncthreads();
  // one thread an element: the gradients, read and written coalesced
  const int n = n_rows * K;
#pragma unroll 2
  for (int e = t; e < n; e += kGradThreads) {
    const float err = s_err[e / K];
    const float uc = bu[e], pc = bp[e], qc = bq[e];
    gu[o0 + e] = -err * (pc + qc) + alpha * uc;
    gp[o0 + e] = -err * uc + beta * pc;
    gq[o0 + e] = -err * uc + gamma * qc;
  }
}

template <bool kDP>
int launch_step(const float* u, const float* p, const float* q, const float* r,
                const float* conf, const float* z, float* du, float* gp, float* dq,
                float* scratch, float* loss, int B, int K, float theta, float alpha,
                float beta, float gamma, float clip, void* stream) {
  const int blocks = (B + kStepRows - 1) / kStepRows;
  const size_t bytes = (size_t)(kDP ? 4 : 3) * kStepRows * K * sizeof(float);
  const bool staged = bytes <= kStageBytes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // K = 10, the paper's and every configuration's width, unrolled whole
  auto kernel = K == 10 ? dmf_fused_step_kernel<kDP, 10> : dmf_fused_step_kernel<kDP, 0>;
  kernel<<<blocks, kStepRows, staged ? bytes : 0, s>>>(u, p, q, r, conf, z, du, gp, dq, scratch,
                                                       loss, B, K, theta, alpha, beta, gamma,
                                                       clip, staged ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of scratch a step launch over B rows needs: none for one block,
// else the ticket and one partial per group of 128 rows.
extern "C" int dmf_step_scratch(int B) {
  return B <= kStepRows ? 0 : 1 + (B + kLossGroup - 1) / kLossGroup;
}

extern "C" int dmf_fused_step_launch(const float* u, const float* p, const float* q,
                                     const float* r, const float* conf, float* du,
                                     float* gp, float* dq, float* scratch, float* loss,
                                     int B, int K, float theta, float alpha, float beta,
                                     float gamma, void* stream) {
  return launch_step<false>(u, p, q, r, conf, nullptr, du, gp, dq, scratch, loss, B, K,
                            theta, alpha, beta, gamma, 0.f, stream);
}

extern "C" int dmf_fused_step_dp_launch(const float* u, const float* p, const float* q,
                                        const float* r, const float* conf, const float* z,
                                        float* du, float* gp, float* dq, float* scratch,
                                        float* loss, int B, int K, float theta, float alpha,
                                        float beta, float gamma, float clip, void* stream) {
  return launch_step<true>(u, p, q, r, conf, z, du, gp, dq, scratch, loss, B, K, theta,
                           alpha, beta, gamma, clip, stream);
}

// rows: rows a block, 1..128.
extern "C" int dmf_grads_launch(const float* u, const float* p, const float* q,
                                const float* r, const float* conf, float* gu, float* gp,
                                float* gq, int B, int K, float alpha, float beta, float gamma,
                                int rows, void* stream) {
  if (rows < 1 || rows > kGradThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + rows - 1) / rows;
  auto kernel = K == 10 ? dmf_grads_kernel<10> : K == 16 ? dmf_grads_kernel<16> : dmf_grads_kernel<0>;
  kernel<<<blocks, kGradThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u, p, q, r, conf, gu, gp, gq, B, K, rows, alpha, beta, gamma);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
