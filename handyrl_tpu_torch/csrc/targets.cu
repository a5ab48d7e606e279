// The backward target recursions on Hopper: TD(lambda) (K3), UPGO (K4) and
// V-Trace (K5), one kernel launch each.
//
// Replace the TPU kernels handyrl_tpu/ops/pallas_targets.py:_td_kernel,
// _upgo_kernel and _vtrace_kernel. There the data was moved to a
// time-major (T, N) layout padded to 128 lanes and the T loop unrolled
// over full lane vectors. Here one thread owns one lane n = b*P + p of the
// batch-first (B, T, P, 1) arrays, reads them in place at stride P, keeps
// the carry in a register and walks t = T-1 .. 0; lanes past N are masked,
// not padded. Each kernel also writes the advantages, and the V-Trace
// kernel forms its deltas, vs and advantages in the same loop (the JAX
// wrapper, pallas_targets.py:220-233, did that around the kernel).
//
// Bound: bytes. At (T, N) = (16, 2048) TD reads values, rewards and lambda
// once (3 x 128 KB), the bootstrap row (8 KB), and writes targets and
// advantages (2 x 128 KB): 0.65 MB, 0.19 us at 3.35 TB/s; about 6 flops a
// step, nothing next to that. What bounds the launch on the card is its
// fixed cost (a few us), not the work. The design keeps the recursion to
// one launch with no transposes, no padding copies and no intermediate
// arrays; its plain version in PyTorch takes some 5 launches per step.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// TD(lambda) and, with upgo, UPGO. g holds the bootstrap row (B, 1, P, 1),
// rew may be null (no rewards).
__global__ void lambda_kernel(const float* __restrict__ v,
                              const float* __restrict__ g,
                              const float* __restrict__ rew,
                              const float* __restrict__ lam,
                              float* __restrict__ target,
                              float* __restrict__ adv, int B, int T, int P,
                              int upgo, float gamma) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= B * P) return;
  const int b = n / P, p = n % P;
  const size_t base = static_cast<size_t>(b) * T * P + p;   // (b, 0, p)
  float carry = g[n];
  size_t i = base + static_cast<size_t>(T - 1) * P;
  target[i] = carry;
  adv[i] = carry - v[i];
  for (int t = T - 2; t >= 0; --t) {
    const size_t next = i;
    i -= P;
    const float v_next = v[next];
    const float l = lam[next];
    float boot = (1.f - l) * v_next + l * carry;
    if (upgo) boot = fmaxf(v_next, boot);
    carry = (rew ? rew[i] : 0.f) + gamma * boot;
    target[i] = carry;
    adv[i] = carry - v[i];
  }
}

// V-Trace: delta_t = rho_t (r_t + gamma V_{t+1} - V_t) with V_T = G,
// vmv_t = delta_t + gamma (lambda_{t+1} c_t) vmv_{t+1}, vs = vmv + V,
// adv_t = r_t + gamma vs_{t+1} - V_t with vs_T = G.
__global__ void vtrace_kernel(const float* __restrict__ v,
                              const float* __restrict__ g,
                              const float* __restrict__ rew,
                              const float* __restrict__ lam,
                              const float* __restrict__ rho,
                              const float* __restrict__ c,
                              float* __restrict__ vs,
                              float* __restrict__ adv, int B, int T, int P,
                              float gamma) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= B * P) return;
  const int b = n / P, p = n % P;
  const float G = g[n];
  size_t i = static_cast<size_t>(b) * T * P + p + static_cast<size_t>(T - 1) * P;
  float r = rew ? rew[i] : 0.f;
  float vt = v[i];
  float vmv = rho[i] * (r + gamma * G - vt);
  float vs_next = vmv + vt;
  vs[i] = vs_next;
  adv[i] = r + gamma * G - vt;
  float v_next = vt;
  for (int t = T - 2; t >= 0; --t) {
    const size_t next = i;
    i -= P;
    r = rew ? rew[i] : 0.f;
    vt = v[i];
    const float delta = rho[i] * (r + gamma * v_next - vt);
    vmv = delta + gamma * (lam[next] * c[i]) * vmv;
    const float vs_t = vmv + vt;
    vs[i] = vs_t;
    adv[i] = r + gamma * vs_next - vt;
    vs_next = vs_t;
    v_next = vt;
  }
}

int blocks_for(int lanes) { return (lanes + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int targets_lambda(const float* v, const float* g, const float* rew,
                              const float* lam, float* target, float* adv,
                              int B, int T, int P, int upgo, float gamma,
                              void* stream) {
  if (B <= 0 || T <= 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  lambda_kernel<<<blocks_for(B * P), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      v, g, rew, lam, target, adv, B, T, P, upgo, gamma);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int targets_vtrace(const float* v, const float* g, const float* rew,
                              const float* lam, const float* rho,
                              const float* c, float* vs, float* adv, int B,
                              int T, int P, float gamma, void* stream) {
  if (B <= 0 || T <= 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  vtrace_kernel<<<blocks_for(B * P), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      v, g, rew, lam, rho, c, vs, adv, B, T, P, gamma);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* targets_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
