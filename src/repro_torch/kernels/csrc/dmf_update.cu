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
// Design: one thread per row, fp32. The TPU kernel accumulated the loss
// into one block that every grid step revisited, which relies on the TPU
// grid running in order. Blocks on the GPU run in no order, so each block
// writes its partial sum (a fixed shared-memory tree) and a second
// one-thread kernel adds the partials in index order. No float atomics:
// the loss is the same bits on every run. Both forms share one template;
// the DP branch (kDP) recomputes each gp entry after the row norm rather
// than keeping K values in registers, and rounds the clip and the noise
// add separately (no FMA), as the reference's two fp32 operations do. The
// non-DP instantiation is the unchanged kernel 3.
//
// The gradients-only kernel (`dmf_grads_kernel`) is a separate __global__,
// not a third instance of the template, so kernels 3 and 7 stay the code
// they were. At B=256, K=10 it reads u/p/q and r/conf (32 KB) and writes
// gu/gp/gq (30 KB): 0.019 us at 3.35 TB/s, far below the launch. One
// thread per row, fp32. Its residual and its three expressions are
// written as kernel 3 writes its own, so nvcc contracts them alike: gp is
// kernel 3's gp, and −θ·gu, −θ·gq are kernel 3's du, dq, up to the one
// rounding of the θ product. The TPU wrapper padded B to 256 and K to 128
// (src/repro/kernels/ops.py:35-45); here B is the loop bound and K the
// row length, and nothing is padded.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStepThreads = 128;

template <bool kDP>
__global__ void __launch_bounds__(kStepThreads)
dmf_fused_step_kernel(const float* __restrict__ u, const float* __restrict__ p,
                      const float* __restrict__ q, const float* __restrict__ r,
                      const float* __restrict__ conf, const float* __restrict__ z,
                      float* __restrict__ du, float* __restrict__ gp,
                      float* __restrict__ dq, float* __restrict__ partial, int B, int K,
                      float theta, float alpha, float beta, float gamma, float clip) {
  __shared__ float s_loss[kStepThreads];
  const int b = blockIdx.x * kStepThreads + threadIdx.x;
  float l = 0.f;
  if (b < B) {
    const size_t o = (size_t)b * K;
    float dot = 0.f;
    for (int c = 0; c < K; ++c) dot += u[o + c] * (p[o + c] + q[o + c]);
    const float raw = r[b] - dot;
    const float err = conf[b] * raw;
    if constexpr (kDP) {
      float ss = 0.f;
      for (int c = 0; c < K; ++c) {
        const float g = -err * u[o + c] + beta * p[o + c];
        ss += g * g;
      }
      const float ratio = clip / sqrtf(ss);             // inf/0 -> scale 1
      const float scale = ratio >= 1.f ? 1.f : ratio;   // NaN stays NaN
      for (int c = 0; c < K; ++c) {
        const float uc = u[o + c], pc = p[o + c], qc = q[o + c];
        const float g = -err * uc + beta * pc;
        du[o + c] = -theta * (-err * (pc + qc) + alpha * uc);
        gp[o + c] = __fadd_rn(__fmul_rn(g, scale), z[o + c]);
        dq[o + c] = -theta * (-err * uc + gamma * qc);
      }
    } else {
      for (int c = 0; c < K; ++c) {
        const float uc = u[o + c], pc = p[o + c], qc = q[o + c];
        du[o + c] = -theta * (-err * (pc + qc) + alpha * uc);
        gp[o + c] = -err * uc + beta * pc;
        dq[o + c] = -theta * (-err * uc + gamma * qc);
      }
    }
    l = conf[b] * raw * raw;
  }
  s_loss[threadIdx.x] = l;
  __syncthreads();
  for (int half = kStepThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) s_loss[threadIdx.x] += s_loss[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[blockIdx.x] = s_loss[0];
}

__global__ void __launch_bounds__(kStepThreads)
dmf_grads_kernel(const float* __restrict__ u, const float* __restrict__ p,
                 const float* __restrict__ q, const float* __restrict__ r,
                 const float* __restrict__ conf, float* __restrict__ gu,
                 float* __restrict__ gp, float* __restrict__ gq, int B, int K,
                 float alpha, float beta, float gamma) {
  const int b = blockIdx.x * kStepThreads + threadIdx.x;
  if (b >= B) return;
  const size_t o = (size_t)b * K;
  float dot = 0.f;
  for (int c = 0; c < K; ++c) dot += u[o + c] * (p[o + c] + q[o + c]);
  const float raw = r[b] - dot;
  const float err = conf[b] * raw;
  for (int c = 0; c < K; ++c) {
    const float uc = u[o + c], pc = p[o + c], qc = q[o + c];
    gu[o + c] = -err * (pc + qc) + alpha * uc;
    gp[o + c] = -err * uc + beta * pc;
    gq[o + c] = -err * uc + gamma * qc;
  }
}

__global__ void sum_partials_kernel(const float* __restrict__ partial, int n,
                                    float* __restrict__ loss) {
  float s = 0.f;
  for (int i = 0; i < n; ++i) s += partial[i];
  loss[0] = 0.5f * s;
}

template <bool kDP>
int launch_step(const float* u, const float* p, const float* q, const float* r,
                const float* conf, const float* z, float* du, float* gp, float* dq,
                float* partial, float* loss, int B, int K, float theta, float alpha,
                float beta, float gamma, float clip, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (B + kStepThreads - 1) / kStepThreads;
  dmf_fused_step_kernel<kDP><<<blocks, kStepThreads, 0, s>>>(
      u, p, q, r, conf, z, du, gp, dq, partial, B, K, theta, alpha, beta, gamma, clip);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sum_partials_kernel<<<1, 1, 0, s>>>(partial, blocks, loss);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dmf_step_blocks(int B) { return (B + kStepThreads - 1) / kStepThreads; }

extern "C" int dmf_fused_step_launch(const float* u, const float* p, const float* q,
                                     const float* r, const float* conf, float* du,
                                     float* gp, float* dq, float* partial, float* loss,
                                     int B, int K, float theta, float alpha, float beta,
                                     float gamma, void* stream) {
  return launch_step<false>(u, p, q, r, conf, nullptr, du, gp, dq, partial, loss, B, K,
                            theta, alpha, beta, gamma, 0.f, stream);
}

extern "C" int dmf_fused_step_dp_launch(const float* u, const float* p, const float* q,
                                        const float* r, const float* conf, const float* z,
                                        float* du, float* gp, float* dq, float* partial,
                                        float* loss, int B, int K, float theta, float alpha,
                                        float beta, float gamma, float clip, void* stream) {
  return launch_step<true>(u, p, q, r, conf, z, du, gp, dq, partial, loss, B, K, theta,
                           alpha, beta, gamma, clip, stream);
}

extern "C" int dmf_grads_launch(const float* u, const float* p, const float* q,
                                const float* r, const float* conf, float* gu, float* gp,
                                float* gq, int B, int K, float alpha, float beta, float gamma,
                                void* stream) {
  const int blocks = (B + kStepThreads - 1) / kStepThreads;
  dmf_grads_kernel<<<blocks, kStepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u, p, q, r, conf, gu, gp, gq, B, K, alpha, beta, gamma);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
