// The backward target recursions on Hopper: TD(lambda) (K3), UPGO (K4) and
// V-Trace (K5), one kernel launch each.
//
// Replace the TPU kernels handyrl_tpu/ops/pallas_targets.py:_td_kernel,
// _upgo_kernel and _vtrace_kernel. There the data was moved to a
// time-major (T, N) layout padded to 128 lanes and the T loop unrolled
// over full lane vectors. Here the kernels read the batch-first (B, T, P, 1)
// arrays in place, with no transposes, no padding copies and no
// intermediate arrays. Each kernel also writes the advantages, and the
// V-Trace kernel forms its deltas, vs and advantages in the same pass (the
// JAX wrapper, pallas_targets.py:216-233, did that around the kernel).
//
// What bounds a launch: bytes, and the fixed cost of a launch. At (T, N) =
// (16, 2048) TD reads values, rewards and lambda once (3 x 128 KB) and the
// bootstrap row (8 KB) and writes targets and advantages (2 x 128 KB):
// 0.65 MB, 0.2 us at 3.35 TB/s, with about 6 flops a step. At the update
// step's 128 lanes it is 41 KB, 12 ns: the launch's fixed cost (a few us)
// and the latency of its memory rounds are all there is. The design
// therefore spends as few dependent memory rounds as it can, each fully
// coalesced:
//
// - A block owns `rows` consecutive batch rows b0 .. b0+rows-1: the lanes
//   n = b*P + p of those rows, which cover one contiguous span of
//   rows*T*P floats of every operand. rows = 32 / P (32 lanes, one warp
//   for the recursion; the headline's 128 lanes are 4 blocks on 4 SMs,
//   2048 lanes 64 blocks), fewer where a long T would not fit 48 KB of
//   shared memory.
// - The block's 128 threads stage every operand's span into shared memory
//   in one round: each thread issues its 16-byte loads of all operands
//   before it stores any (neighbouring threads on neighbouring addresses),
//   with scalar loads for the unaligned head and the tail of a span.
// - The recursion runs one lane a thread from shared memory, with the next
//   step's operands loaded before this step's outputs are stored. A
//   buffer holds its span with one pad word after every 32, so that lanes
//   T*P words apart fall on different banks (conflict-free at the update
//   step's T = 16, P = 1). The index math is a shift and an add: a
//   layout padded by rows needed an integer division by T*P for every
//   element staged, 0.45 us more a launch for TD and 0.9 us for V-Trace
//   on an H100 (scripts/torch_targets_variants.py).
// - Targets and advantages go back through shared memory and are stored
//   coalesced, 16 bytes a thread, in one round.
// - The bootstrap row is read in place from `returns`, at (b, T_r - 1, p)
//   through the strides the wrapper passes (0 for a broadcast dimension),
//   and its load is issued before the staging, so nothing is copied
//   before the launch: a target computation is one launch.
// Ragged tiles (B not a multiple of rows), T = 1 and any P up to 128 are
// masked, not padded.
//
// What the design costs: the staging round, two barriers and the store
// round are a fixed cost that a kernel reading its operands in place
// (one thread a lane, T dependent loads) does not pay; they win once its
// T scattered rounds cost more, as they do at T = 16 from about 100 lanes
// up. The recursion stays sequential over T: a warp-level scan would
// compose the affine (and, for UPGO, max-affine) steps in log2(T) rounds,
// but T = 16 steps from shared memory cost less than the launch, and the
// sequential form keeps the plain versions' order of operations.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 32;                 // lanes a block: one warp
constexpr int kMaxOps = 5;                 // operands staged at most
constexpr size_t kSmemBudget = 48 * 1024;  // no opt-in needed below this
constexpr size_t kSmemMax = 232448;        // what a block may opt into

// Position of span element i in a shared buffer: one pad word after every
// 32, so that lanes T*P words apart fall on different banks (no integer
// division: the index math is a shift and an add).
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// Words of a shared buffer that holds a span of n floats.
__host__ __device__ __forceinline__ int plane_words(int n) {
  return n + (n >> 5) + 1;
}

// Floats from `p` to its next 16-byte boundary (p is 4-byte aligned).
__device__ __forceinline__ int head_of(const float* p, int count) {
  const int h = static_cast<int>(
      ((16u - (reinterpret_cast<uintptr_t>(p) & 15u)) & 15u) >> 2);
  return h < count ? h : count;
}

// Copies `count` floats of each of the n spans src[j] (global) into the
// padded shared buffers dst[j]: every 16-byte load of every operand is
// issued before the first store.
__device__ __forceinline__ void stage_in(const float* const* src,
                                         float* const* dst, int n, int count) {
  int head[kMaxOps] = {}, nvec[kMaxOps] = {};
  int maxvec = 0;
#pragma unroll
  for (int j = 0; j < kMaxOps; ++j) {
    if (j < n) {
      head[j] = head_of(src[j], count);
      nvec[j] = (count - head[j]) >> 2;
      maxvec = nvec[j] > maxvec ? nvec[j] : maxvec;
    }
  }
  for (int k = threadIdx.x; k < maxvec; k += blockDim.x) {
    float4 x[kMaxOps];
#pragma unroll
    for (int j = 0; j < kMaxOps; ++j)
      if (j < n && k < nvec[j])
        x[j] = __ldg(reinterpret_cast<const float4*>(src[j] + head[j]) + k);
#pragma unroll
    for (int j = 0; j < kMaxOps; ++j) {
      if (j < n && k < nvec[j]) {
        const int i = head[j] + 4 * k;
        dst[j][padded(i)] = x[j].x;
        dst[j][padded(i + 1)] = x[j].y;
        dst[j][padded(i + 2)] = x[j].z;
        dst[j][padded(i + 3)] = x[j].w;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxOps; ++j) {
    if (j < n) {
      for (int i = threadIdx.x; i < head[j]; i += blockDim.x)
        dst[j][padded(i)] = __ldg(src[j] + i);
      for (int i = head[j] + 4 * nvec[j] + threadIdx.x; i < count;
           i += blockDim.x)
        dst[j][padded(i)] = __ldg(src[j] + i);
    }
  }
}

// The two outputs back from their padded shared buffers, 16 bytes a
// thread where aligned.
__device__ __forceinline__ void stage_out(float* const* dst,
                                          const float* const* src,
                                          int count) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int head = head_of(dst[j], count);
    const int nvec = (count - head) >> 2;
    float4* d4 = reinterpret_cast<float4*>(dst[j] + head);
    for (int k = threadIdx.x; k < nvec; k += blockDim.x) {
      const int i = head + 4 * k;
      d4[k] = make_float4(src[j][padded(i)],
                          src[j][padded(i + 1)],
                          src[j][padded(i + 2)],
                          src[j][padded(i + 3)]);
    }
    for (int i = threadIdx.x; i < head; i += blockDim.x)
      dst[j][i] = src[j][padded(i)];
    for (int i = head + 4 * nvec + threadIdx.x; i < count; i += blockDim.x)
      dst[j][i] = src[j][padded(i)];
  }
}

// The block's tile: its first row, its row count and span, the words of
// each shared buffer, and the bootstrap value of the thread's lane (0 past
// the tile), loaded before anything else.
struct Tile {
  int b0, nrows, count, tp, plane, lanes;
  size_t off;
  float G;
};

__device__ __forceinline__ Tile tile_of(const float* g, long long g_sb,
                                        long long g_sp, int B, int T, int P,
                                        int rows) {
  Tile s;
  s.b0 = blockIdx.x * rows;
  s.nrows = min(rows, B - s.b0);
  s.tp = T * P;
  s.count = s.nrows * s.tp;
  s.plane = plane_words(rows * s.tp);
  s.lanes = s.nrows * P;
  s.off = static_cast<size_t>(s.b0) * s.tp;
  s.G = 0.f;
  const int l = threadIdx.x;
  if (l < s.lanes) {
    const int r = l / P;
    s.G = __ldg(g + (s.b0 + r) * g_sb + (l - r * P) * g_sp);
  }
  return s;
}

// TD(lambda) and, with upgo, UPGO. rew may be null (no rewards).
__global__ void __launch_bounds__(kThreads)
    lambda_kernel(const float* __restrict__ v, const float* __restrict__ g,
                  long long g_sb, long long g_sp,
                  const float* __restrict__ rew,
                  const float* __restrict__ lam, float* __restrict__ target,
                  float* __restrict__ adv, int B, int T, int P, int rows,
                  int upgo, float gamma) {
  extern __shared__ float smem[];
  const Tile s = tile_of(g, g_sb, g_sp, B, T, P, rows);
  float* sv = smem;
  float* sl = sv + s.plane;
  float* st = sl + s.plane;
  float* sa = st + s.plane;
  float* sr = rew ? sa + s.plane : nullptr;
  {
    const float* src[kMaxOps] = {v + s.off, lam + s.off,
                                 rew ? rew + s.off : nullptr};
    float* dst[kMaxOps] = {sv, sl, sr};
    stage_in(src, dst, rew ? 3 : 2, s.count);
  }
  __syncthreads();
  const int l = threadIdx.x;
  if (l < s.lanes) {
    // the operands of step t - 1 are loaded before step t's outputs are
    // stored, so their latency overlaps step t's arithmetic
    const int r = l / P;
    int u = r * s.tp + (l - r * P) + (T - 1) * P;   // span index of (r, t, p)
    int here = padded(u);
    float carry = s.G;
    float v_next = sv[here], l_next = sl[here];
    float vt = 0.f, lt = 0.f, rt = 0.f;
    if (T > 1) {
      u -= P;
      const int k = padded(u);
      vt = sv[k];
      lt = sl[k];
      rt = sr ? sr[k] : 0.f;
    }
    st[here] = carry;
    sa[here] = carry - v_next;
    for (int t = T - 2; t >= 0; --t) {
      here = padded(u);
      float boot = (1.f - l_next) * v_next + l_next * carry;
      if (upgo) boot = fmaxf(v_next, boot);
      carry = rt + gamma * boot;
      const float a = carry - vt;
      v_next = vt;
      l_next = lt;
      if (t > 0) {
        u -= P;
        const int k = padded(u);
        vt = sv[k];
        lt = sl[k];
        rt = sr ? sr[k] : 0.f;
      }
      st[here] = carry;
      sa[here] = a;
    }
  }
  __syncthreads();
  float* out[2] = {target + s.off, adv + s.off};
  const float* from[2] = {st, sa};
  stage_out(out, from, s.count);
}

// V-Trace: delta_t = rho_t (r_t + gamma V_{t+1} - V_t) with V_T = G,
// vmv_t = delta_t + gamma (lambda_{t+1} c_t) vmv_{t+1}, vs = vmv + V,
// adv_t = r_t + gamma vs_{t+1} - V_t with vs_T = G.
__global__ void __launch_bounds__(kThreads)
    vtrace_kernel(const float* __restrict__ v, const float* __restrict__ g,
                  long long g_sb, long long g_sp,
                  const float* __restrict__ rew,
                  const float* __restrict__ lam,
                  const float* __restrict__ rho, const float* __restrict__ c,
                  float* __restrict__ vs, float* __restrict__ adv, int B,
                  int T, int P, int rows, float gamma) {
  extern __shared__ float smem[];
  const Tile s = tile_of(g, g_sb, g_sp, B, T, P, rows);
  float* sv = smem;
  float* sl = sv + s.plane;
  float* sp = sl + s.plane;   // rho
  float* sc = sp + s.plane;
  float* svs = sc + s.plane;
  float* sa = svs + s.plane;
  float* sr = rew ? sa + s.plane : nullptr;
  {
    const float* src[kMaxOps] = {v + s.off, lam + s.off, rho + s.off,
                                 c + s.off, rew ? rew + s.off : nullptr};
    float* dst[kMaxOps] = {sv, sl, sp, sc, sr};
    stage_in(src, dst, rew ? 5 : 4, s.count);
  }
  __syncthreads();
  const int l = threadIdx.x;
  if (l < s.lanes) {
    // pipelined as in lambda_kernel: step t - 1's operands (r, V, rho, c
    // and the lambda step t - 2 takes) load before step t's stores
    const int r = l / P;
    int u = r * s.tp + (l - r * P) + (T - 1) * P;
    int here = padded(u);
    const float G = s.G;
    const float r_last = sr ? sr[here] : 0.f;
    float v_next = sv[here];
    float l_next = sl[here];
    float vmv = sp[here] * (r_last + gamma * G - v_next);
    float vs_next = vmv + v_next;
    const float a_last = r_last + gamma * G - v_next;
    float rt = 0.f, vt = 0.f, pt = 0.f, ct = 0.f, lt = 0.f;
    if (T > 1) {
      u -= P;
      const int k = padded(u);
      rt = sr ? sr[k] : 0.f;
      vt = sv[k];
      pt = sp[k];
      ct = sc[k];
      lt = sl[k];
    }
    svs[here] = vs_next;
    sa[here] = a_last;
    for (int t = T - 2; t >= 0; --t) {
      here = padded(u);
      const float delta = pt * (rt + gamma * v_next - vt);
      vmv = delta + gamma * (l_next * ct) * vmv;
      const float vs_t = vmv + vt;
      const float a = rt + gamma * vs_next - vt;
      vs_next = vs_t;
      v_next = vt;
      l_next = lt;
      if (t > 0) {
        u -= P;
        const int k = padded(u);
        rt = sr ? sr[k] : 0.f;
        vt = sv[k];
        pt = sp[k];
        ct = sc[k];
        lt = sl[k];
      }
      svs[here] = vs_t;
      sa[here] = a;
    }
  }
  __syncthreads();
  float* out[2] = {vs + s.off, adv + s.off};
  const float* from[2] = {svs, sa};
  stage_out(out, from, s.count);
}

// Rows a block and its dynamic shared memory for `nbuf` padded buffers;
// 0 rows when one row does not fit a block, or P lanes exceed its threads.
int tile_rows(int T, int P, int nbuf, size_t* smem) {
  if (P > kThreads) return 0;
  const int tp = T * P;
  int rows = P < kLanes ? kLanes / P : 1;
  while (rows > 1 && nbuf * plane_words(rows * tp) * sizeof(float) > kSmemBudget)
    --rows;
  *smem = static_cast<size_t>(nbuf) * plane_words(rows * tp) * sizeof(float);
  return *smem <= kSmemMax ? rows : 0;
}

template <typename Kernel>
int prepare(Kernel kernel, int B, int T, int P, int nbuf, int* rows,
            size_t* smem, dim3* grid) {
  if (B <= 0 || T <= 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  *rows = tile_rows(T, P, nbuf, smem);
  if (*rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (*smem > kSmemBudget) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(*smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *grid = dim3((B + *rows - 1) / *rows);
  return 0;
}

}  // namespace

// g is the bootstrap row: element (b, p) at g[b * g_sb + p * g_sp].
extern "C" int targets_lambda(const float* v, const float* g, long long g_sb,
                              long long g_sp, const float* rew,
                              const float* lam, float* target, float* adv,
                              int B, int T, int P, int upgo, float gamma,
                              void* stream) {
  int rows;
  size_t smem;
  dim3 grid;
  const int err = prepare(lambda_kernel, B, T, P, rew ? 5 : 4, &rows, &smem,
                          &grid);
  if (err) return err;
  lambda_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      v, g, g_sb, g_sp, rew, lam, target, adv, B, T, P, rows, upgo, gamma);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int targets_vtrace(const float* v, const float* g, long long g_sb,
                              long long g_sp, const float* rew,
                              const float* lam, const float* rho,
                              const float* c, float* vs, float* adv, int B,
                              int T, int P, float gamma, void* stream) {
  int rows;
  size_t smem;
  dim3 grid;
  const int err = prepare(vtrace_kernel, B, T, P, rew ? 7 : 6, &rows, &smem,
                          &grid);
  if (err) return err;
  vtrace_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      v, g, g_sb, g_sp, rew, lam, rho, c, vs, adv, B, T, P, rows, gamma);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* targets_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
