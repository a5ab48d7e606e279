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
                 float* __restrict__ saved, int cin, int layers, int groups,
                 float eps) {
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
      if (layer == layers) {
        reinterpret_cast<float4*>(on + pix[k] * F)[q] = h;
      } else {
        *hp = h;
        if (saved)   // training: keep block layer+1's input for K2
          reinterpret_cast<float4*>(
              saved + ((static_cast<size_t>(blockIdx.x) * layers + layer) *
                           kPix + pix[k]) * F)[q] = h;
      }
    }
    cp_async_wait_all();
    __syncthreads();   // hs and the next layer's weights are complete
  }
}

template <int F>
cudaError_t launch(const float* x, const float* stem_w, const float* stem_scale,
                   const float* stem_bias, const float* block_w,
                   const float* block_scale, const float* block_bias,
                   float* out, float* saved, int n, int cin, int layers,
                   int groups, float eps, cudaStream_t stream) {
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
      saved, cin, layers, groups, eps);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ K2
//
// The trunk's backward: dx (optional) and the grads of every layer's conv
// weights, GroupNorm scale and bias, in three launches.
//
// Replaces the TPU kernel handyrl_tpu/ops/pallas_geese.py:_bwd_kernel, which
// recomputed the tile forward in VMEM, transposed it with jax.vjp and added
// the weight grads of each batch tile into one output across the
// sequential grid. On the card blocks run in no order, so the work is split
// by what it reduces over:
//
//  A. trunk_bwd_kernel, one block per sample (as K1), walks the layers from
//     the top down. Each layer's input comes from memory: the training
//     forward of K1 saved the 12 block inputs (N x 12 x 77 x F fp32, 242 MB
//     at N=2048; cheaper than a second forward, and 80 GB has room), the
//     stem's is x. From it the block recomputes the conv and the GroupNorm
//     statistics (the same code as K1). The ReLU masks are read from the
//     saved outputs (the next block's input, y for the top block), not
//     recomputed: a pre-activation within rounding of 0 would flip between
//     any two computations of the forward, and the mask then decides a
//     whole element of the gradient. Then, in registers: the GroupNorm
//     backward (per-channel sums of g and g*xhat reduced like K1's
//     statistics), dc = d(conv output), and the transposed conv (taps
//     flipped through the same wrapped-neighbour table) into the next
//     layer's dh, which stays in shared memory. dc of
//     every layer goes to memory (N x 13 x 77 x F), and so do the sample's
//     scale and bias grads (N x 13 x 2F).
//  B. trunk_wgrad_kernel, one block per (layer, group of kChunk samples):
//     dW[t][ci][f] = sum over the group's samples and pixels p of
//     in[nbr(p, t)][ci] * dc[p][f], each thread a 4 x 8 register tile of
//     (ci, f) for one tap, plus the group's scale and bias sums. One
//     partial row per group.
//  C. column_sum adds the partial rows in group order: the result does not
//     depend on the order in which blocks ran.
//
// Bound: operations. Per sample, A recomputes the convs (17.8 MFLOP) and
// runs the transposed convs (17.0 MFLOP, the stem's only when dx is
// asked for), B the weight products (17.8 MFLOP): about 3x K1, 106 GFLOP
// at N=2048, 1.6 ms at 67 TFLOP/s fp32. The bytes (block inputs and dc
// written and read once: about 1 GB at N=2048) take 0.3 ms at 3.35 TB/s.
// Known limit of this first version: the transposed conv reads weight rows
// 4q..4q+3 across the warp at a stride of 4F floats, a 4-way shared-memory
// bank conflict; the forward layout is kept so that one staged copy of the
// weights serves both convs.

constexpr int kChunk = 16;   // samples per partial row of B

// Group sums of v (F floats in shared memory) for this thread's 4
// channels: channels of one group share one sum.
template <int F>
__device__ __forceinline__ void group_sums_of(const float* v, int q, int cpg,
                                              float (&out)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int g = (4 * q + j) / cpg;
    float s = 0.f;
    for (int c = 0; c < cpg; ++c) s += v[g * cpg + c];
    out[j] = s;
  }
}

// The transposed 3x3 torus conv for output channels 4*oq..4*oq+3 (the
// layer's input channels) at this thread's pixels: sum over taps t and
// conv channels f of dc[nbr(p, 8 - t)][f] * W[t][ci][f]. ws holds the
// layer's weights as (9, cp, F).
template <int F>
__device__ __forceinline__ void conv_transpose(const float* dcs, int stride,
                                               const float* ws, int cp, int oq,
                                               const int* nbr,
                                               const int (&pix)[kPPT],
                                               float (&acc)[kPPT][4]) {
#pragma unroll
  for (int k = 0; k < kPPT; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;
  for (int t = 0; t < kTaps; ++t) {
    const float* src[kPPT];
#pragma unroll
    for (int k = 0; k < kPPT; ++k)
      src[k] = dcs + nbr[pix[k] * kTaps + (kTaps - 1 - t)] * stride;
    const float* wt = ws + (t * cp + 4 * oq) * F;
#pragma unroll
    for (int f = 0; f < F; f += 4) {
      float4 w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = *reinterpret_cast<const float4*>(wt + j * F + f);
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        const float4 v = *reinterpret_cast<const float4*>(src[k] + f);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[k][j] = fmaf(v.x, w[j].x, acc[k][j]);
          acc[k][j] = fmaf(v.y, w[j].y, acc[k][j]);
          acc[k][j] = fmaf(v.z, w[j].z, acc[k][j]);
          acc[k][j] = fmaf(v.w, w[j].w, acc[k][j]);
        }
      }
    }
  }
}

// Stage layer l's weights (0 = the stem, padded to cinp rows whose extra
// rows are zeroed here) into ws; complete after cp_async_wait_all and a
// barrier.
template <int F>
__device__ void stage_layer(float* ws, int l, const float* stem_w,
                            const float* block_w, int cin, int cinp) {
  if (l == 0) {
    stage_weights<F>(ws, stem_w, cin, cinp);
    for (int i = threadIdx.x; i < kTaps * (cinp - cin) * F;
         i += Shape<F>::kThreads) {
      const int f = i % F, rest = i / F;
      ws[((rest / (cinp - cin)) * cinp + cin + rest % (cinp - cin)) * F + f] =
          0.f;
    }
  } else {
    stage_weights<F>(ws, block_w + static_cast<size_t>(l - 1) * kTaps * F * F,
                     F, F);
  }
}

template <int F>
__global__ void __launch_bounds__(Shape<F>::kThreads, 1)
trunk_bwd_kernel(const float* __restrict__ x, const float* __restrict__ stem_w,
                 const float* __restrict__ stem_scale,
                 const float* __restrict__ stem_bias,
                 const float* __restrict__ block_w,
                 const float* __restrict__ block_scale,
                 const float* __restrict__ block_bias,
                 const float* __restrict__ acts, const float* __restrict__ y,
                 const float* __restrict__ dy, float* __restrict__ dx,
                 float* __restrict__ dc_out,
                 float* __restrict__ dsn, int cin, int layers, int groups,
                 float eps) {
  using S = Shape<F>;
  extern __shared__ __align__(16) float smem[];
  const int cinp = round4(cin);
  const int xstride = cinp + kPadC;
  const int cmax = cinp > F ? cinp : F;
  const int astride = xstride > S::kHStride ? xstride : S::kHStride;
  float* as = smem;                              // kPix x astride  layer input
  float* dhs = as + kPix * astride;              // kPix x kHStride d(output)
  float* dcs = dhs + kPix * S::kHStride;         // kPix x kHStride d(conv)
  const int wsize = kTaps * cmax * F;
  float* ws0 = dcs + kPix * S::kHStride;         // 9 x cmax x F    weights,
  float* ws1 = ws0 + wsize;                      //   two buffers
  float* red = ws1 + wsize;                      // 4 x kWarps x F  sums
  float* chan = red + 4 * S::kWarps * F;         // 2 x F           channel sums
  int* nbr = reinterpret_cast<int*>(chan + 2 * F);   // kPix x 9

  const int tid = threadIdx.x;
  const size_t n = blockIdx.x;
  const int nl = layers + 1;
  stage_layer<F>(ws0, layers, stem_w, block_w, cin, cinp);
  for (int i = tid; i < kPix * kTaps; i += S::kThreads) {
    const int p = i / kTaps, t = i % kTaps;
    const int r = p / kCols, c = p % kCols;
    const int a = t / 3, b = t % 3;
    nbr[i] = ((r + a + kRows - 1) % kRows) * kCols + (c + b + kCols - 1) % kCols;
  }
  const float* dyn = dy + n * kPix * F;
  for (int i = tid; i < kPix * (F / 4); i += S::kThreads) {
    const int p = i / (F / 4), c4 = i % (F / 4);
    reinterpret_cast<float4*>(dhs + p * S::kHStride)[c4] =
        reinterpret_cast<const float4*>(dyn + p * F)[c4];
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
    pix[k] = own[k] ? p : kPix - 1;
  }
  float* red1 = red;
  float* red2 = red1 + S::kWarps * F;
  float* red3 = red2 + S::kWarps * F;
  float* red4 = red3 + S::kWarps * F;

  for (int l = layers; l >= 0; --l) {
    // layer l runs on buffer (layers - l) % 2 while layer l - 1's weights
    // stream into the other one, which layer l + 1 has finished with
    const float* ws = (layers - l) % 2 ? ws1 : ws0;
    if (l > 0)
      stage_layer<F>((layers - l) % 2 ? ws0 : ws1, l - 1, stem_w, block_w, cin,
                     cinp);
    if (l > 0) {
      const float* an = acts + (n * layers + (l - 1)) * kPix * F;
      for (int i = tid; i < kPix * (F / 4); i += S::kThreads) {
        const int p = i / (F / 4), c4 = i % (F / 4);
        reinterpret_cast<float4*>(as + p * S::kHStride)[c4] =
            reinterpret_cast<const float4*>(an + p * F)[c4];
      }
    } else {
      const float* xn = x + n * kPix * cin;
      for (int i = tid; i < kPix * xstride; i += S::kThreads) {
        const int p = i / xstride, c = i % xstride;
        as[i] = c < cin ? xn[p * cin + c] : 0.f;
      }
    }
    __syncthreads();   // the layer input is in place

    // the forward of this layer, as K1 computes it
    float acc[kPPT][4];
    if (l == 0)
      conv<F, 0>(as, xstride, cinp, ws, nbr, pix, q, acc);
    else
      conv<F, F>(as, S::kHStride, F, ws, nbr, pix, q, acc);
    channel_partials<F>(acc, own, q, red1);
    __syncthreads();
    float mean[4], rstd[4];
    group_sums<F>(red1, q, cpg, mean);
#pragma unroll
    for (int j = 0; j < 4; ++j) mean[j] *= inv_count;
    float tmp[kPPT][4];
#pragma unroll
    for (int k = 0; k < kPPT; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = acc[k][j] - mean[j];
        tmp[k][j] = d * d;
      }
    channel_partials<F>(tmp, own, q, red2);
    __syncthreads();
    group_sums<F>(red2, q, cpg, rstd);
    const float* scale = l == 0 ? stem_scale : block_scale + (l - 1) * F;
    const float4 sc4 = reinterpret_cast<const float4*>(scale)[q];
    const float scv[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) rstd[j] = rsqrtf(rstd[j] * inv_count + eps);

    // ReLU mask: g = dh where the layer's saved output is positive; acc
    // becomes xhat and tmp g * xhat
    const float* outn = l == layers ? y + n * kPix * F
                                    : acts + (n * layers + l) * kPix * F;
    float g[kPPT][4];
#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
      const float4 dh4 =
          reinterpret_cast<const float4*>(dhs + pix[k] * S::kHStride)[q];
      const float4 o4 = reinterpret_cast<const float4*>(outn + pix[k] * F)[q];
      const float dhv[4] = {dh4.x, dh4.y, dh4.z, dh4.w};
      const float ov[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        g[k][j] = own[k] && ov[j] > 0.f ? dhv[j] : 0.f;
        acc[k][j] = (acc[k][j] - mean[j]) * rstd[j];
        tmp[k][j] = g[k][j] * acc[k][j];
      }
    }
    channel_partials<F>(g, own, q, red3);
    channel_partials<F>(tmp, own, q, red4);
    __syncthreads();
    if (tid < F) {
      float s1 = 0.f, s2 = 0.f;
      for (int w = 0; w < S::kWarps; ++w) {
        s1 += red3[w * F + tid];
        s2 += red4[w * F + tid];
      }
      float* dn = dsn + (n * nl + l) * 2 * F;
      dn[tid] = s2;        // d scale
      dn[F + tid] = s1;    // d bias
      chan[tid] = s1 * scale[tid];
      chan[F + tid] = s2 * scale[tid];
    }
    __syncthreads();

    // GroupNorm backward: dc = rstd (g scale - mean(g scale)
    //                                 - xhat mean(g scale xhat))
    float m1[4], m2[4];
    group_sums_of<F>(chan, q, cpg, m1);
    group_sums_of<F>(chan + F, q, cpg, m2);
    float* dcn = dc_out + (n * nl + l) * kPix * F;
#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
      float d[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        d[j] = rstd[j] * (g[k][j] * scv[j] - m1[j] * inv_count -
                          acc[k][j] * (m2[j] * inv_count));
      if (!own[k]) continue;
      const float4 d4 = make_float4(d[0], d[1], d[2], d[3]);
      reinterpret_cast<float4*>(dcs + pix[k] * S::kHStride)[q] = d4;
      reinterpret_cast<float4*>(dcn + pix[k] * F)[q] = d4;
    }
    __syncthreads();   // dcs is complete

    if (l > 0) {
      // dh of block l's input: the residual g plus the transposed conv
      conv_transpose<F>(dcs, S::kHStride, ws, F, q, nbr, pix, acc);
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        if (!own[k]) continue;
        reinterpret_cast<float4*>(dhs + pix[k] * S::kHStride)[q] =
            make_float4(g[k][0] + acc[k][0], g[k][1] + acc[k][1],
                        g[k][2] + acc[k][2], g[k][3] + acc[k][3]);
      }
    } else if (dx) {
      float* dxn = dx + n * kPix * cin;
      for (int oq = q; oq < cinp / 4; oq += S::kQuads) {
        conv_transpose<F>(dcs, S::kHStride, ws, cinp, oq, nbr, pix, acc);
#pragma unroll
        for (int k = 0; k < kPPT; ++k) {
          if (!own[k]) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (4 * oq + j < cin) dxn[pix[k] * cin + 4 * oq + j] = acc[k][j];
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();   // dhs and the next layer's weights are complete
  }
}

// Offsets into the flat gradient vector: stem W (9, cin, F), block W
// (L, 9, F, F), scales (L+1, F), biases (L+1, F).
__host__ __device__ inline size_t w_offset(int l, int cin, int f) {
  return l == 0 ? 0
                : static_cast<size_t>(kTaps) * cin * f +
                      static_cast<size_t>(l - 1) * kTaps * f * f;
}

template <int F>
struct WShape {
  static constexpr int kFOcts = F / 8;
  __host__ __device__ static int ci_quads(int cin) {
    const int cinp = round4(cin);
    return (cinp > F ? cinp : F) / 4;
  }
  __host__ __device__ static int threads(int cin) {
    return kTaps * ci_quads(cin) * kFOcts;
  }
};

template <int F>
__global__ void trunk_wgrad_kernel(const float* __restrict__ x,
                                   const float* __restrict__ acts,
                                   const float* __restrict__ dc_all,
                                   const float* __restrict__ dsn,
                                   float* __restrict__ partials, int n,
                                   int cin, int layers, size_t total) {
  using W = WShape<F>;
  extern __shared__ __align__(16) float smem[];
  const int l = blockIdx.x;
  const int n0 = blockIdx.y * kChunk;
  const int n1 = min(n, n0 + kChunk);
  const int nl = layers + 1;
  const int cinp = round4(cin);
  const int c_in = l == 0 ? cin : F;        // this layer's input channels
  const int cp = l == 0 ? cinp : F;         // ... padded, the row stride
  const int nciq = W::ci_quads(cin);
  float* as = smem;                         // kPix x cp    layer input
  float* dcs = as + kPix * nciq * 4;        // kPix x F     d(conv)
  int* nbr = reinterpret_cast<int*>(dcs + kPix * F);
  const int tid = threadIdx.x;
  for (int i = tid; i < kPix * kTaps; i += blockDim.x) {
    const int p = i / kTaps, t = i % kTaps;
    const int r = p / kCols, c = p % kCols;
    const int a = t / 3, b = t % 3;
    nbr[i] = ((r + a + kRows - 1) % kRows) * kCols + (c + b + kCols - 1) % kCols;
  }
  const int fo = tid % W::kFOcts;
  const int ciq = (tid / W::kFOcts) % nciq;
  const int t = tid / (W::kFOcts * nciq);
  const bool active = 4 * ciq < c_in;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float sb = 0.f;   // the group's sum of this thread's scale or bias grad

  for (int s = n0; s < n1; ++s) {
    __syncthreads();   // the previous sample is done with as and dcs
    if (l == 0) {
      const float* xn = x + static_cast<size_t>(s) * kPix * cin;
      for (int i = tid; i < kPix * cinp; i += blockDim.x) {
        const int p = i / cinp, c = i % cinp;
        as[i] = c < cin ? xn[p * cin + c] : 0.f;
      }
    } else {
      const float4* an = reinterpret_cast<const float4*>(
          acts + (static_cast<size_t>(s) * layers + (l - 1)) * kPix * F);
      for (int i = tid; i < kPix * F / 4; i += blockDim.x)
        reinterpret_cast<float4*>(as)[i] = an[i];
    }
    const float4* dn = reinterpret_cast<const float4*>(
        dc_all + (static_cast<size_t>(s) * nl + l) * kPix * F);
    for (int i = tid; i < kPix * F / 4; i += blockDim.x)
      reinterpret_cast<float4*>(dcs)[i] = dn[i];
    if (tid < 2 * F) sb += dsn[(static_cast<size_t>(s) * nl + l) * 2 * F + tid];
    __syncthreads();
    if (!active) continue;
    for (int p = 0; p < kPix; ++p) {
      const float4 a4 = *reinterpret_cast<const float4*>(
          as + nbr[p * kTaps + t] * cp + 4 * ciq);
      const float4 d0 = *reinterpret_cast<const float4*>(dcs + p * F + 8 * fo);
      const float4 d1 =
          *reinterpret_cast<const float4*>(dcs + p * F + 8 * fo + 4);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], dv[j], acc[i][j]);
    }
  }

  float* row = partials + blockIdx.y * total;
  if (active) {
    float* dw = row + w_offset(l, cin, F);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ci = 4 * ciq + i;
      if (ci >= c_in) continue;
      float* o = dw + (static_cast<size_t>(t) * c_in + ci) * F + 8 * fo;
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = acc[i][j];
    }
  }
  if (tid < 2 * F) {
    const size_t scales = w_offset(nl, cin, F);
    row[scales + (tid < F ? l * F + tid : nl * F + l * F + tid - F)] = sb;
  }
}

// out[j] = sum over rows r, in order, of in[r * cols + j]
__global__ void column_sum(const float* __restrict__ in, float* __restrict__ out,
                           int rows, size_t cols) {
  const size_t j = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= cols) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += in[r * cols + j];
  out[j] = s;
}

template <int F>
cudaError_t launch_backward(const float* x, const float* stem_w,
                            const float* stem_scale, const float* stem_bias,
                            const float* block_w, const float* block_scale,
                            const float* block_bias, const float* acts,
                            const float* y, const float* dy, float* dx,
                            float* dc_all,
                            float* dsn, float* partials, float* out, int n,
                            int cin, int layers, int groups, float eps,
                            cudaStream_t stream) {
  using S = Shape<F>;
  using W = WShape<F>;
  const int cinp = round4(cin);
  const int cmax = cinp > F ? cinp : F;
  const int astride = cinp + kPadC > S::kHStride ? cinp + kPadC : S::kHStride;
  const int smem_a = static_cast<int>(
      sizeof(float) * (kPix * astride + 2 * kPix * S::kHStride +
                       2 * kTaps * cmax * F + 4 * S::kWarps * F + 2 * F) +
      sizeof(int) * kPix * kTaps);
  cudaError_t err = cudaFuncSetAttribute(
      trunk_bwd_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  if (err != cudaSuccess) return err;
  trunk_bwd_kernel<F><<<n, S::kThreads, smem_a, stream>>>(
      x, stem_w, stem_scale, stem_bias, block_w, block_scale, block_bias, acts,
      y, dy, dx, dc_all, dsn, cin, layers, groups, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int nl = layers + 1;
  const int chunks = (n + kChunk - 1) / kChunk;
  const size_t total = w_offset(nl, cin, F) + 2 * static_cast<size_t>(nl) * F;
  const int smem_b = static_cast<int>(
      sizeof(float) * kPix * (W::ci_quads(cin) * 4 + F) +
      sizeof(int) * kPix * kTaps);
  trunk_wgrad_kernel<F><<<dim3(nl, chunks), W::threads(cin), smem_b, stream>>>(
      x, acts, dc_all, dsn, partials, n, cin, layers, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  column_sum<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      partials, out, chunks, total);
  return cudaGetLastError();
}

}  // namespace

extern "C" int geese_trunk_forward(const float* x, const float* stem_w,
                                   const float* stem_scale,
                                   const float* stem_bias,
                                   const float* block_w,
                                   const float* block_scale,
                                   const float* block_bias, float* out,
                                   float* saved, int n, int cin, int f,
                                   int layers, int groups, float eps,
                                   void* stream) {
  if (n <= 0 || cin <= 0 || layers < 0 || groups <= 0 || f % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (f) {
    case 16:
      return launch<16>(x, stem_w, stem_scale, stem_bias, block_w, block_scale,
                        block_bias, out, saved, n, cin, layers, groups, eps, s);
    case 32:
      return launch<32>(x, stem_w, stem_scale, stem_bias, block_w, block_scale,
                        block_bias, out, saved, n, cin, layers, groups, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// acts (n, layers, 77, f) and y (n, 77, f) are the training forward's block
// inputs and output. Scratch the caller allocates: dc_all (n, layers+1, 77,
// f), dsn (n,
// layers+1, 2f), partials (ceil(n / geese_trunk_backward_chunk()), total)
// and out (total), total = 9*cin*f + layers*9*f*f + 2*(layers+1)*f.
extern "C" int geese_trunk_backward(
    const float* x, const float* stem_w, const float* stem_scale,
    const float* stem_bias, const float* block_w, const float* block_scale,
    const float* block_bias, const float* acts, const float* y,
    const float* dy, float* dx, float* dc_all, float* dsn, float* partials,
    float* out, int n, int cin, int f, int layers, int groups, float eps,
    void* stream) {
  if (n <= 0 || cin <= 0 || layers < 0 || groups <= 0 || f % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (f) {
    case 16:
      return launch_backward<16>(x, stem_w, stem_scale, stem_bias, block_w,
                                 block_scale, block_bias, acts, y, dy, dx,
                                 dc_all, dsn, partials, out, n, cin, layers,
                                 groups, eps, s);
    case 32:
      return launch_backward<32>(x, stem_w, stem_scale, stem_bias, block_w,
                                 block_scale, block_bias, acts, y, dy, dx,
                                 dc_all, dsn, partials, out, n, cin, layers,
                                 groups, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int geese_trunk_backward_chunk() { return kChunk; }

extern "C" const char* geese_trunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
