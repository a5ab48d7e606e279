// GeeseNet trunk forward on Hopper: stem + L residual blocks of a 3x3 torus
// conv, GroupNorm and ReLU, in one kernel, for F in {16, 32}.
//
// Replaces the TPU kernel handyrl_tpu/ops/pallas_geese.py:_fwd_kernel (tile
// math tile_forward), which kept a whole batch tile of activations in VMEM
// across all 13 layers. Here one thread block owns one sample, so nothing
// carries across blocks and any N works without the TPU's tile padding. The
// sample's activations never leave shared memory between layers: the input
// (77 x Cin, channels padded to a multiple of 4), the running activation h
// (77 x F), a 77 x 9 table of wrapped neighbour indices, ((r+a-1) mod 7,
// (c+b-1) mod 11), and the weights (9 x C x F) of the layer being computed
// while the next layer's stream in behind it (cp.async into a second
// buffer). No wrap-padded copy exists anywhere.
//
// Bound: per sample 2*77*9*(17*32 + 12*32*32) = 17.8 MFLOP against 0.47 MB
// of weights (shared by the whole batch) plus 15 KB of input and output, so
// at the serving buckets (8..64 rows) the work is arithmetic, in fp32 on
// the CUDA cores, and inside one SM the limit is shared-memory traffic and
// latency per FMA. Design against it: a register tile. Each thread owns 4
// adjacent output channels and kPPT = 5 pixels (16 pixel slots x 5 cover
// the 77 cells), holds 20 fp32 accumulators, and per 4 input channels reads
// 5 float4 activations and 4 float4 weights from shared memory for 80 FMAs.
// Activation rows are padded by 4 floats so the pixels a warp reads at once
// fall in different banks. The conv output never goes to shared memory:
// GroupNorm statistics are reduced from the accumulators (warp shuffles,
// then one partial per warp), two-pass in fp32, and the norm, the residual
// add and the ReLU are applied in registers. The limit this design keeps:
// a sample runs on one SM (4 warps at F=32), so a batch of N rows fills N
// of the 132 SMs, and one SM's fp32 rate bounds a row's latency.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 7;
constexpr int kCols = 11;
constexpr int kPix = kRows * kCols;
constexpr int kTaps = 9;
constexpr int kSlots = 16;                               // pixel slots
constexpr int kPPT = (kPix + kSlots - 1) / kSlots;       // pixels per thread
constexpr int kPadC = 4;                                 // row padding (floats)

__host__ __device__ constexpr int round4(int c) { return (c + 3) & ~3; }

template <int F>
struct Shape {
  static constexpr int kQuads = F / 4;                   // channel quads
  static constexpr int kThreads = kQuads * kSlots;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kHStride = F + kPadC;
  static_assert(F % 4 == 0 && kThreads % 32 == 0 && kQuads <= 32, "F");
};

// Asynchronous 16-byte copy from global to shared memory (through L2 only:
// every SM reads the same weights), and the wait for all of this thread's.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// Start copying one layer's HWIO weights (9, C, F) from global memory into
// shared memory as (9, CP, F), 16 bytes per copy; rows c >= C are left as
// they are (the caller zeroes them once). Complete after cp_async_wait_all
// and a barrier.
template <int F>
__device__ void stage_weights(float* ws, const float* __restrict__ w, int c_in,
                              int cp) {
  constexpr int kQ = F / 4;
  const int total = kTaps * c_in * kQ;
  for (int i = threadIdx.x; i < total; i += Shape<F>::kThreads) {
    const int q = i % kQ;
    const int row = i / kQ;
    const int c = row % c_in;
    const int tap = row / c_in;
    cp_async16(ws + (tap * cp + c) * F + 4 * q, w + 4 * i);
  }
}

// The 3x3 torus conv of one layer for this thread's 4 channels and kPPT
// pixels. CP > 0 is the input channel count known at compile time (the
// blocks); CP == 0 reads it from cp (the stem).
template <int F, int CP>
__device__ __forceinline__ void conv(const float* in, int stride, int cp,
                                     const float* ws, const int* nbr,
                                     const int (&pix)[kPPT], int q,
                                     float (&acc)[kPPT][4]) {
  if constexpr (CP > 0) cp = CP;
#pragma unroll
  for (int k = 0; k < kPPT; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;
  for (int t = 0; t < kTaps; ++t) {
    const float* src[kPPT];
#pragma unroll
    for (int k = 0; k < kPPT; ++k) src[k] = in + nbr[pix[k] * kTaps + t] * stride;
    const float* wt = ws + t * cp * F + 4 * q;
    auto quad = [&](int c) {
      float4 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = *reinterpret_cast<const float4*>(wt + (c + i) * F);
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        const float4 v = *reinterpret_cast<const float4*>(src[k] + c);
        const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[k][0] = fmaf(vs[i], w[i].x, acc[k][0]);
          acc[k][1] = fmaf(vs[i], w[i].y, acc[k][1]);
          acc[k][2] = fmaf(vs[i], w[i].z, acc[k][2]);
          acc[k][3] = fmaf(vs[i], w[i].w, acc[k][3]);
        }
      }
    };
    if constexpr (CP > 0) {
#pragma unroll
      for (int c = 0; c < CP; c += 4) quad(c);
    } else {
      for (int c = 0; c < cp; c += 4) quad(c);
    }
  }
}

// Per-channel sums over the sample's 77 pixels of this thread's 4
// channels, reduced across the pixel slots: shuffles inside the warp, then
// one float4 per (warp, quad) into red (kWarps x F). The caller syncs.
template <int F>
__device__ __forceinline__ void channel_partials(const float (&v)[kPPT][4],
                                                 const bool (&own)[kPPT],
                                                 int q, float* red) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < kPPT; ++k)
    if (own[k])
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] += v[k][j];
#pragma unroll
  for (int o = Shape<F>::kQuads; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
  if ((threadIdx.x & 31) < Shape<F>::kQuads)
    reinterpret_cast<float4*>(red + (threadIdx.x / 32) * F)[q] =
        make_float4(s[0], s[1], s[2], s[3]);
}

// The group statistic (sum over the group's channels and all warps of red)
// for each of this thread's 4 channels, in a fixed order; channels of one
// group share one sum.
template <int F>
__device__ __forceinline__ void group_sums(const float* red, int q, int cpg,
                                           float (&out)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int g = (4 * q + j) / cpg;
    if (j > 0 && g == (4 * q + j - 1) / cpg) {
      out[j] = out[j - 1];
      continue;
    }
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < Shape<F>::kWarps; ++w)
      for (int c = 0; c < cpg; ++c) s += red[w * F + g * cpg + c];
    out[j] = s;
  }
}

template <int F>
__global__ void __launch_bounds__(Shape<F>::kThreads, 1)
trunk_fwd_kernel(const float* __restrict__ x, const float* __restrict__ stem_w,
                 const float* __restrict__ stem_scale,
                 const float* __restrict__ stem_bias,
                 const float* __restrict__ block_w,
                 const float* __restrict__ block_scale,
                 const float* __restrict__ block_bias, float* __restrict__ out,
                 int cin, int layers, int groups, float eps) {
  using S = Shape<F>;
  extern __shared__ __align__(16) float smem[];
  const int cinp = round4(cin);
  const int xstride = cinp + kPadC;
  const int cmax = cinp > F ? cinp : F;
  float* xs = smem;                              // kPix x xstride  stem input
  float* hs = xs + kPix * xstride;               // kPix x kHStride activation
  const int wsize = kTaps * cmax * F;
  float* ws0 = hs + kPix * S::kHStride;          // 9 x cmax x F    weights,
  float* ws1 = ws0 + wsize;                      //   two buffers
  float* red1 = ws1 + wsize;                     // kWarps x F      sums
  float* red2 = red1 + S::kWarps * F;            // kWarps x F      sq. dev.
  int* nbr = reinterpret_cast<int*>(red2 + S::kWarps * F);   // kPix x 9

  const int tid = threadIdx.x;
  stage_weights<F>(ws0, stem_w, cin, cinp);
  for (int i = tid; i < kPix * kTaps; i += S::kThreads) {
    const int p = i / kTaps, t = i % kTaps;
    const int r = p / kCols, c = p % kCols;
    const int a = t / 3, b = t % 3;
    nbr[i] = ((r + a + kRows - 1) % kRows) * kCols + (c + b + kCols - 1) % kCols;
  }
  const float* xn = x + static_cast<size_t>(blockIdx.x) * kPix * cin;
  for (int i = tid; i < kPix * xstride; i += S::kThreads) {
    const int p = i / xstride, c = i % xstride;
    xs[i] = c < cin ? xn[p * cin + c] : 0.f;
  }
  for (int i = tid; i < kTaps * (cinp - cin) * F; i += S::kThreads) {
    const int f = i % F, rest = i / F;
    ws0[((rest / (cinp - cin)) * cinp + cin + rest % (cinp - cin)) * F + f] = 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  const int q = tid % S::kQuads;
  const int slot = tid / S::kQuads;
  const int cpg = F / groups;
  const float inv_count = 1.f / static_cast<float>(kPix * cpg);
  int pix[kPPT];
  bool own[kPPT];
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    const int p = slot + k * kSlots;
    own[k] = p < kPix;
    pix[k] = own[k] ? p : kPix - 1;   // ragged tail: computed, never used
  }
  float* on = out + static_cast<size_t>(blockIdx.x) * kPix * F;

  for (int layer = 0; layer <= layers; ++layer) {
    // layer l runs on buffer l % 2 while the next layer's weights stream
    // into the other one, which the conv of layer l - 1 has finished with
    const float* ws = layer % 2 ? ws1 : ws0;
    if (layer < layers)
      stage_weights<F>(layer % 2 ? ws0 : ws1,
                       block_w + static_cast<size_t>(layer) * kTaps * F * F,
                       F, F);
    float acc[kPPT][4];
    if (layer == 0)
      conv<F, 0>(xs, xstride, cinp, ws, nbr, pix, q, acc);
    else
      conv<F, F>(hs, S::kHStride, F, ws, nbr, pix, q, acc);
    channel_partials<F>(acc, own, q, red1);
    __syncthreads();   // conv done: hs is free; red1 is complete

    float mean[4], rstd[4];
    group_sums<F>(red1, q, cpg, mean);
#pragma unroll
    for (int j = 0; j < 4; ++j) mean[j] *= inv_count;
    float dev[kPPT][4];
#pragma unroll
    for (int k = 0; k < kPPT; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = acc[k][j] - mean[j];
        dev[k][j] = d * d;
      }
    channel_partials<F>(dev, own, q, red2);
    __syncthreads();   // red2 is complete

    group_sums<F>(red2, q, cpg, rstd);
    const float* scale = layer == 0 ? stem_scale : block_scale + (layer - 1) * F;
    const float* bias = layer == 0 ? stem_bias : block_bias + (layer - 1) * F;
    const float4 sc = reinterpret_cast<const float4*>(scale)[q];
    const float4 bi = reinterpret_cast<const float4*>(bias)[q];
    const float scv[4] = {sc.x, sc.y, sc.z, sc.w};
    const float biv[4] = {bi.x, bi.y, bi.z, bi.w};
    float mul[4], add[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      rstd[j] = rsqrtf(rstd[j] * inv_count + eps);
      mul[j] = rstd[j] * scv[j];
      add[j] = biv[j] - mean[j] * mul[j];
    }
#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
      if (!own[k]) continue;
      float4* hp = reinterpret_cast<float4*>(hs + pix[k] * S::kHStride) + q;
      const float4 old = layer == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : *hp;
      const float4 h = make_float4(
          fmaxf(old.x + fmaf(acc[k][0], mul[0], add[0]), 0.f),
          fmaxf(old.y + fmaf(acc[k][1], mul[1], add[1]), 0.f),
          fmaxf(old.z + fmaf(acc[k][2], mul[2], add[2]), 0.f),
          fmaxf(old.w + fmaf(acc[k][3], mul[3], add[3]), 0.f));
      if (layer == layers)
        reinterpret_cast<float4*>(on + pix[k] * F)[q] = h;
      else
        *hp = h;
    }
    cp_async_wait_all();
    __syncthreads();   // hs and the next layer's weights are complete
  }
}

template <int F>
cudaError_t launch(const float* x, const float* stem_w, const float* stem_scale,
                   const float* stem_bias, const float* block_w,
                   const float* block_scale, const float* block_bias,
                   float* out, int n, int cin, int layers, int groups,
                   float eps, cudaStream_t stream) {
  using S = Shape<F>;
  const int cinp = round4(cin);
  const int cmax = cinp > F ? cinp : F;
  const int smem = static_cast<int>(
      sizeof(float) * (kPix * (cinp + kPadC) + kPix * S::kHStride +
                       2 * kTaps * cmax * F + 2 * S::kWarps * F) +
      sizeof(int) * kPix * kTaps);
  // set on every launch: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      trunk_fwd_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  trunk_fwd_kernel<F><<<n, S::kThreads, smem, stream>>>(
      x, stem_w, stem_scale, stem_bias, block_w, block_scale, block_bias, out,
      cin, layers, groups, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int geese_trunk_forward(const float* x, const float* stem_w,
                                   const float* stem_scale,
                                   const float* stem_bias,
                                   const float* block_w,
                                   const float* block_scale,
                                   const float* block_bias, float* out, int n,
                                   int cin, int f, int layers, int groups,
                                   float eps, void* stream) {
  if (n <= 0 || cin <= 0 || layers < 0 || groups <= 0 || f % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (f) {
    case 16:
      return launch<16>(x, stem_w, stem_scale, stem_bias, block_w, block_scale,
                        block_bias, out, n, cin, layers, groups, eps, s);
    case 32:
      return launch<32>(x, stem_w, stem_scale, stem_bias, block_w, block_scale,
                        block_bias, out, n, cin, layers, groups, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* geese_trunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
