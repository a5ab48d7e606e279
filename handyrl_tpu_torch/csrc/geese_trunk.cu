// GeeseNet trunk on Hopper, for F in {16, 32}: the forward (K1: stem + L
// residual blocks of a 3x3 torus conv, GroupNorm and ReLU, in one kernel)
// and its backward (K2, below).
//
// ------------------------------------------------------------------ K1
//
// Replaces the TPU kernel handyrl_tpu/ops/pallas_geese.py:_fwd_kernel (tile
// math tile_forward), which kept a whole batch tile of activations in VMEM
// across all 13 layers. Here one thread block owns one sample, so nothing
// carries across blocks and any N works without the TPU's tile padding. The
// sample's activations never leave the SM between layers.
//
// Bound: per sample 2*77*9*(17*32 + 12*32*32) = 17.8 MFLOP of conv against
// 0.47 MB of weights (shared by the whole batch) and 15 KB of input and
// output. The convs run on the tensor cores in 3xTF32 (below), three TF32
// products per fp32 multiply-add: 36.4 GFLOP at N=2048 is 0.221 ms at 495
// TFLOP/s, above the training form's 537 MB of writes (0.160 ms at 3.35
// TB/s), so K1 is bound by operations in both forms.
//
// Design: each layer's conv is an implicit GEMM on the tensor cores,
// mma.sync m16n8k8 TF32 with fp32 accumulation, with the output channels f
// as M and the sample's 77 pixels as N (10 n8 tiles, the last 3 columns
// repeating pixel 76), K = 9 taps x the input channels: A[f][(t, ci)] =
// W[t][ci][f], B[(t, ci)][p] = h[nbr(p, t)][ci] through a 77 x 9 table of
// wrapped neighbours ((r+a-1) mod 7, (c+b-1) mod 11). Each of the 4 warps
// (F=32; 2 at F=16) owns one m16 tile of channels and one half of the
// pixels (5 n8 tiles): per k-step it reads one A and five B fragments for
// 15 mma. The activations live in shared memory as (hi, lo) TF32 pairs,
// split once when a layer writes them (B is 10 of a k-step's 14 values);
// the weights fp32 as they are (HWIO rows (t, ci), f contiguous), A's
// fragments read across those rows and split as they are loaded. Both
// reads are free of bank conflicts (row strides 8 mod 32). The rounding to
// TF32 is two integer operations (tf32_rna): with cvt.rna.tf32 and every
// operand split at its load, the conversions bound an earlier form of this
// kernel. The stem's input is padded to round8(cin) channels, zero in
// both its weight rows and its input columns. The sample's residual stream
// h stays fp32 in registers, in the accumulator layout that every layer
// shares: the residual add, the saved block inputs and the output never
// see the TF32 split. GroupNorm is reduced from the accumulators: per
// channel over the thread's pixels (the repeated columns masked out),
// shuffles over the quad, one partial per (pixel half, channel) in shared
// memory, group sums in a fixed order; two-pass (the mean, then the
// squared deviations).
//
// Shared memory (F=32): the weights 46 KB, h 22 KB as pairs (the stem's
// input pairs in the same place), the neighbour table, 71.5 KB in all, and
// 136 registers a thread, so an SM runs three samples (12 warps) whose
// conv and GroupNorm phases interleave. The next block's weights stream in
// (cp.async) while the statistics are reduced, into the one buffer the
// conv has just finished with; three barriers a layer. The limits kept: a
// sample runs on one SM, so a batch of N rows fills N of the 132 SMs, and
// a row's latency is 13 dependent layers; the conv's mma.sync runs below
// the TF32 peak that the bound counts (wgmma, the only way to it, is not
// used).
//
// Training form (saved != nullptr): besides the output it writes what K2
// reads of the forward, so that K2 recomputes no conv: each block's input
// (acts, N x L x 77 x F; the ReLU masks come from these outputs), and each
// layer's normalised conv output xhat = (conv - mean) rstd (N x (L+1) x 77
// x F) and per-group rstd (N x (L+1) x groups), straight from the
// accumulators. The serving form computes and stores only the output.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 7;
constexpr int kCols = 11;
constexpr int kPix = kRows * kCols;
constexpr int kTaps = 9;
constexpr int kSlots = 16;                               // pixel slots (K2a)
constexpr int kPPT = (kPix + kSlots - 1) / kSlots;       // pixels per thread
constexpr int kPadC = 4;                                 // row padding (floats)
constexpr int kPixTiles = 5;   // n8 pixel tiles of a warp's conv: two warps
static_assert(2 * kPixTiles * 8 >= kPix, "cover the 77 pixels");

__host__ __device__ constexpr int round4(int c) { return (c + 3) & ~3; }
__host__ __device__ constexpr int round8(int c) { return (c + 7) & ~7; }
__host__ __device__ constexpr int round16(int c) { return (c + 15) & ~15; }
// Row stride in floats of c channels as (hi, lo) pairs: 8 or 24 mod 32 for
// c a multiple of 4, so that the rows a quarter warp reads lie in
// different banks.
__host__ __device__ constexpr int pair_stride(int c) { return 2 * (c + kPadC); }

// Asynchronous copies from global to shared memory (16 bytes through L2
// only, 4 bytes), and the wait for all of this thread's.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from 0,
// as cvt.rna.tf32.f32 rounds (add half of the 13 dropped bits to the
// magnitude, then clear them), in two integer operations: with the
// conversion instruction for every operand of the forward's conv, the
// conversions bound the conv.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// 3xTF32: x = hi + lo with both TF32, hi = x rounded and lo the rest
// rounded, so that hi*hi + hi*lo + lo*hi carries fp32's precision (the
// lo*lo term left out is below 2^-22 of the product).
__device__ __forceinline__ float2 split_tf32(float x) {
  const float hi = tf32_rna(x);
  return make_float2(hi, tf32_rna(x - hi));
}

// x as TF32 (hi, lo) by truncation: hi = x with its 13 low bits cleared,
// lo the rest cleared the same way, one integer operation each instead of
// tf32_rna's two. x - hi - lo is below 2^-20 of x (2^-22 rounded), as is
// the lo*lo term 3xTF32 leaves out. K2b splits every operand as its
// fragment loads, and rounding took a tenth of its time on the H100
// (scripts/torch_trunk_variants.py, k2b_rna).
__device__ __forceinline__ float2 split_tf32_trunc(float x) {
  const float hi = __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
  return make_float2(
      hi, __uint_as_float(__float_as_uint(x - hi) & 0xFFFFE000u));
}

// Four floats as (hi, lo) pairs into 8 floats at dst (16-byte aligned).
__device__ __forceinline__ void store_split4(float* dst, float4 v) {
  const float2 a = split_tf32(v.x), b = split_tf32(v.y);
  const float2 c = split_tf32(v.z), d = split_tf32(v.w);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

// c += a * b on the tensor cores: one m16n8k8 TF32 product with fp32
// accumulation; a, b in mma's fragment layouts (row, col).
__device__ __forceinline__ void mma_tf32(float (&c)[4], float a0, float a1,
                                         float a2, float a3, float b0,
                                         float b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)),
        "r"(__float_as_uint(a2)), "r"(__float_as_uint(a3)),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// The wrapped-neighbour table: nbr[p * 9 + t] is the pixel that tap t =
// (a, b) of pixel p = (r, c) reads, ((r+a-1) mod 7, (c+b-1) mod 11).
__device__ void fill_neighbours(int* nbr, int threads) {
  for (int i = threadIdx.x; i < kPix * kTaps; i += threads) {
    const int p = i / kTaps, t = i % kTaps;
    const int r = p / kCols, c = p % kCols;
    const int a = t / 3, b = t % 3;
    nbr[i] = ((r + a + kRows - 1) % kRows) * kCols + (c + b + kCols - 1) % kCols;
  }
}

template <int F>
struct FwdShape {
  static constexpr int kWarps = 2 * (F / 16);   // (m16 tile, pixel half)
  static constexpr int kThreads = 32 * kWarps;
  // weight rows 8 mod 32 banks apart: A's fragment reads four rows of
  // eight channels; rows of (hi, lo) pairs (pair_stride) for B
  static constexpr int kWStride = F + 8;
  static constexpr int kPair = pair_stride(F);
  static_assert(F % 16 == 0 && kWStride % 16 == 8 && kPair % 32 == 8, "F");
};

// The 3x3 torus conv of one layer of one sample, an implicit GEMM on the
// tensor cores: conv[p][f] = sum over taps t and input channels ci of
// W[t][ci][f] * in[nbr(p, t)][ci], K = 9 taps x cw, with the output
// channels as M and the pixels as N. This warp computes m16 tile mt (f =
// 16 mt .. 16 mt + 15) against n8 tiles 5 nh .. 5 nh + 4 (pixels 40 nh ..
// 40 nh + 39; those past 76 repeat pixel 76). ws holds the weights fp32 as
// they are in HWIO, rows (t, ci) of F floats at a stride of kWStride; A is
// read across them, A[f][k] at row (t, k), and split into TF32 (hi, lo) as
// its fragment is loaded (4 values a k-step). in holds the layer's input
// already split, a row of in_pair floats a pixel of (hi, lo) pairs (ci
// contiguous: mma's col layout for B; one 8-byte load gives both halves of
// an element, the four rows a quarter warp reads 8 banks apart). Each
// k-step is three mma, hi*hi into acc and lo*hi + hi*lo into a second set
// of accumulators added at the end, so that the small terms are not
// rounded against the large ones. KC > 0 is cw known at compile time (the
// blocks); KC == 0 takes cw (the stem).
template <int F, int KC>
__device__ __forceinline__ void conv_mma(const float* in, int in_pair,
                                         const float* ws, int cw, int mt,
                                         int nh, const int* nbr,
                                         float (&acc)[kPixTiles][4]) {
  constexpr int kW = FwdShape<F>::kWStride;
  if constexpr (KC > 0) cw = KC;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tq = lane & 3;
  float lo_terms[kPixTiles][4];
#pragma unroll
  for (int j = 0; j < kPixTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = lo_terms[j][e] = 0.f;
#pragma unroll 1
  for (int t = 0; t < kTaps; ++t) {
    const float* bp[kPixTiles];   // this lane's pixel of each n8 tile
#pragma unroll
    for (int j = 0; j < kPixTiles; ++j) {
      const int p = min(8 * (kPixTiles * nh + j) + gid, kPix - 1);
      bp[j] = in + nbr[p * kTaps + t] * in_pair + 2 * tq;
    }
    const float* ap = ws + (t * cw + tq) * kW + 16 * mt + gid;
    auto k_step = [&](int kk) {
      const float* ak = ap + 8 * kk * kW;
      const float2 a0 = split_tf32(ak[0]), a1 = split_tf32(ak[8]);
      const float2 a2 = split_tf32(ak[4 * kW]);
      const float2 a3 = split_tf32(ak[4 * kW + 8]);
#pragma unroll
      for (int j = 0; j < kPixTiles; ++j) {
        const float2 b0 = *reinterpret_cast<const float2*>(bp[j] + 16 * kk);
        const float2 b1 =
            *reinterpret_cast<const float2*>(bp[j] + 16 * kk + 8);
        mma_tf32(lo_terms[j], a0.y, a1.y, a2.y, a3.y, b0.x, b1.x);
        mma_tf32(lo_terms[j], a0.x, a1.x, a2.x, a3.x, b0.y, b1.y);
        mma_tf32(acc[j], a0.x, a1.x, a2.x, a3.x, b0.x, b1.x);
      }
    };
    if constexpr (KC > 0) {
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) k_step(kk);
    } else {
      for (int kk = 0; kk < cw / 8; ++kk) k_step(kk);
    }
  }
#pragma unroll
  for (int j = 0; j < kPixTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += lo_terms[j][e];
}

// Start copying (cp.async) a block's weights, 9 F rows of F floats, into ws
// rows at a stride of kWStride.
template <int F>
__device__ __forceinline__ void stage_rows(float* ws,
                                           const float* __restrict__ w) {
  for (int i = threadIdx.x; i < kTaps * F * F / 4;
       i += FwdShape<F>::kThreads)
    cp_async16(ws + (i / (F / 4)) * FwdShape<F>::kWStride + 4 * (i % (F / 4)),
               w + 4 * i);
}

// The group statistic of channel f: the sum over the group's channels of
// both pixel halves' partials in red (2 x F), in a fixed order, so that
// every channel of a group gets the same value.
template <int F>
__device__ __forceinline__ float group_total(const float* red, int f,
                                             int cpg) {
  const int g0 = f - f % cpg;
  float s = 0.f;
  for (int c = g0; c < g0 + cpg; ++c) s += red[c] + red[F + c];
  return s;
}

// Per-channel sums of v over this thread's pixels that exist (the repeated
// columns past pixel 76 left out), reduced over the quad (the lanes of one
// channel) and written by its first lane to red[nh * F + f] (the caller
// syncs). v is in the accumulator layout: v[j][e] is channel 16 mt + gid +
// 8 (e >> 1) at pixel 8 (5 nh + j) + 2 tq + (e & 1).
template <int F>
__device__ __forceinline__ void channel_sums(const float (&v)[kPixTiles][4],
                                             int nh, const int (&f)[2],
                                             float* red) {
  const int tq = threadIdx.x & 3;
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kPixTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (8 * (kPixTiles * nh + j) + 2 * tq + (e & 1) < kPix)
        s[e >> 1] += v[j][e];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
    if (tq == 0) red[nh * F + f[h]] = s[h];
  }
}

template <int F>
__global__ void __launch_bounds__(FwdShape<F>::kThreads, 3)
trunk_fwd_kernel(const float* __restrict__ x, const float* __restrict__ stem_w,
                 const float* __restrict__ stem_scale,
                 const float* __restrict__ stem_bias,
                 const float* __restrict__ block_w,
                 const float* __restrict__ block_scale,
                 const float* __restrict__ block_bias, float* __restrict__ out,
                 float* __restrict__ saved, float* __restrict__ xhat_out,
                 float* __restrict__ rstd_out, int cin, int layers,
                 int groups, float eps) {
  using S = FwdShape<F>;
  extern __shared__ __align__(16) float smem[];
  const int cw = round8(cin);                    // the stem's K per tap
  const int xpair = pair_stride(cw);             // its input's row stride
  const int wrows = cw > F ? cw : F;
  const int hrow = xpair > S::kPair ? xpair : S::kPair;
  float* ws = smem;                              // 9 x wrows x kWStride  W
  float* hs = ws + kTaps * wrows * S::kWStride;  // kPix x hrow  h as pairs
  float* red1 = hs + kPix * hrow;                // 2 x F  channel sums
  float* red2 = red1 + 2 * F;                    // 2 x F  squared deviations
  int* nbr = reinterpret_cast<int*>(red2 + 2 * F);   // kPix x 9

  const int tid = threadIdx.x;
  const size_t n = blockIdx.x;
  // the stem's weights as (9, cw) rows, the rows ci >= cin zero
  for (int i = tid; i < kTaps * cw * (F / 4); i += S::kThreads) {
    const int c4 = i % (F / 4), row = i / (F / 4);
    const int ci = row % cw, t = row / cw;
    float* dst = ws + row * S::kWStride + 4 * c4;
    if (ci < cin)
      cp_async16(dst, stem_w + (t * cin + ci) * F + 4 * c4);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  fill_neighbours(nbr, S::kThreads);
  const float* xn = x + n * kPix * cin;
  for (int i = tid; i < kPix * cw; i += S::kThreads) {   // x as pairs,
    const int p = i / cw, c = i % cw;                   //   zero-padded
    *reinterpret_cast<float2*>(hs + p * xpair + 2 * c) =
        split_tf32(c < cin ? __ldg(xn + p * cin + c) : 0.f);
  }
  cp_async_wait_all();
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  const int mt = warp >> 1, nh = warp & 1;
  const int f[2] = {16 * mt + gid, 16 * mt + gid + 8};   // this thread's
  const int cpg = F / groups;                            //   channels
  const float inv_count = 1.f / static_cast<float>(kPix * cpg);
  float hv[kPixTiles][4];   // h, fp32, in the accumulator layout
  float* on = out + n * kPix * F;

  for (int layer = 0; layer <= layers; ++layer) {
    const float* scale = layer == 0 ? stem_scale : block_scale + (layer - 1) * F;
    const float* bias = layer == 0 ? stem_bias : block_bias + (layer - 1) * F;
    float sc[2], bi[2];   // needed after the conv; their loads fly meanwhile
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sc[h] = __ldg(scale + f[h]);
      bi[h] = __ldg(bias + f[h]);
    }
    float acc[kPixTiles][4];
    if (layer == 0)
      conv_mma<F, 0>(hs, xpair, ws, cw, mt, nh, nbr, acc);
    else
      conv_mma<F, F>(hs, S::kPair, ws, F, mt, nh, nbr, acc);
    channel_sums<F>(acc, nh, f, red1);
    __syncthreads();   // A: the conv is done with ws and hs; red1 is complete

    // the next block's weights stream in while the statistics are reduced
    if (layer < layers)
      stage_rows<F>(ws, block_w + static_cast<size_t>(layer) * kTaps * F * F);
    float mean[2], rstd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mean[h] = group_total<F>(red1, f[h], cpg) * inv_count;
    float dev[kPixTiles][4];
#pragma unroll
    for (int j = 0; j < kPixTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = acc[j][e] - mean[e >> 1];
        dev[j][e] = d * d;
      }
    channel_sums<F>(dev, nh, f, red2);
    __syncthreads();   // B: red2 is complete

    float mul[2], add[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rstd[h] = rsqrtf(group_total<F>(red2, f[h], cpg) * inv_count + eps);
      mul[h] = rstd[h] * sc[h];
      add[h] = bi[h] - mean[h] * mul[h];
    }
    const size_t nl_index = n * (layers + 1) + layer;
    float* xo = xhat_out ? xhat_out + nl_index * kPix * F : nullptr;
    float* ao = saved && layer < layers
                    ? saved + (n * layers + layer) * kPix * F : nullptr;
    if (xhat_out && nh == 0 && tq == 0)   // one writer per group
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (f[h] % cpg == 0) rstd_out[nl_index * groups + f[h] / cpg] = rstd[h];
#pragma unroll
    for (int j = 0; j < kPixTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 8 * (kPixTiles * nh + j) + 2 * tq + (e & 1);
        if (p >= kPix) continue;
        const int h = e >> 1;
        const int o = p * F + f[h];
        if (xo) xo[o] = (acc[j][e] - mean[h]) * rstd[h];
        const float v = fmaxf((layer == 0 ? 0.f : hv[j][e]) +
                                  fmaf(acc[j][e], mul[h], add[h]), 0.f);
        hv[j][e] = v;
        if (layer == layers) {
          on[o] = v;
        } else {   // the next layer's input; block layer+1's for K2
          *reinterpret_cast<float2*>(hs + p * S::kPair + 2 * f[h]) =
              split_tf32(v);
          if (ao) ao[o] = v;
        }
      }
    cp_async_wait_all();
    __syncthreads();   // C: hs and the next layer's weights are complete
  }
}

template <int F>
cudaError_t launch(const float* x, const float* stem_w, const float* stem_scale,
                   const float* stem_bias, const float* block_w,
                   const float* block_scale, const float* block_bias,
                   float* out, float* saved, float* xhat, float* rstd, int n,
                   int cin, int layers, int groups, float eps,
                   cudaStream_t stream) {
  using S = FwdShape<F>;
  const int cw = round8(cin);
  const int wrows = cw > F ? cw : F;
  const int hrow = pair_stride(cw) > S::kPair ? pair_stride(cw) : S::kPair;
  const int smem = static_cast<int>(
      sizeof(float) * (kTaps * wrows * S::kWStride + kPix * hrow + 4 * F) +
      sizeof(int) * kPix * kTaps);
  // set on every launch: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      trunk_fwd_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  trunk_fwd_kernel<F><<<n, S::kThreads, smem, stream>>>(
      x, stem_w, stem_scale, stem_bias, block_w, block_scale, block_bias, out,
      saved, xhat, rstd, cin, layers, groups, eps);
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
//  A. trunk_bwd_kernel walks the layers from the top down for kSamples = 2
//     samples a block. It replaces the TPU kernel's per-tile recompute:
//     the VMEM budget there (pallas_geese.py:9-14) made recomputing the
//     forward cheaper than keeping it, but this card has 80 GB, so each
//     layer reads the normalised conv output xhat and rstd that K1's
//     training form saved, and recomputes no conv and no statistic. The
//     ReLU masks come from the saved outputs (the next block's input, y
//     for the top block), never from a recomputed pre-activation: one
//     within rounding of 0 flips between any two computations of the
//     forward, and the mask decides a whole element of the gradient.
//     Per layer: (E) the GroupNorm backward in a (quad, slot) register
//     layout (Shape), dc = rstd (g scale - mean(g scale) - xhat mean(g scale
//     xhat)) with g the masked dh, which needs no mean; dc goes to memory
//     for B and, split into TF32 (hi, lo) pairs, to shared memory; then
//     (C) the transposed conv, dh_in = g + sum_t,f W[t][ci][f]
//     dc[nbr(p, 8 - t)][f], on the tensor cores in 3xTF32
//     (conv_transpose_mma: mma.sync m16n8k8, ci as M and the pixels as N,
//     the HWIO weights as A as they are). Each operand is split once:
//     the weights when staged, dc when written to shared memory. The
//     stem's transposed conv (dx) runs on the same path, only when asked.
//     dc of every layer (N x 13 x 77 x F) and the scale and bias grads (N
//     x 13 x 2F) go to memory.
//  B. trunk_wgrad_kernel, one block per (layer, group of kChunk samples):
//     dW[t][ci][f] = sum over the group's samples and pixels p of
//     in[nbr(p, t)][ci] * dc[p][f], a GEMM with K = the samples' pixels on
//     the tensor cores in 3xTF32 (wgrad_mma: f as M, ci as N, a warp all 9
//     taps of one n8 tile of ci), plus the group's scale and bias sums in
//     fp32. One partial row per group.
//  C. column_sum adds the partial rows in group order: the result does not
//     depend on the order in which blocks ran.
//
// Bound of A at N=2048 without dx: bytes. It reads xhat (262 MB), acts
// (242 MB), y, dy (20 MB each) and rstd, and writes dc (262 MB) and the
// scale and bias grads: 815 MB, 0.24 ms at 3.35 TB/s. Its transposed convs
// are 34.9 GFLOP, 0.21 ms as 3xTF32 at 495 TFLOP/s (0.52 ms at the fp32
// peak). How the design goes after it: every byte is read and written
// once; while layer l's conv runs, cp.async brings layer l - 1's xhat,
// mask rows and rstd into the prefetch buffer (xm) and the next block's
// weights arrive in registers (load_block_weights), to be split into
// shared memory when the conv is done with ws. The two samples of a block
// share one weight stage. The shared memory (F=32): weights 83 KB as
// (hi, lo) pairs, per sample dc pairs 22 KB, dh 11 KB and the prefetch
// buffer 20 KB, 194 KB in all with the neighbour table, so an SM holds one
// block: 8 warps, 2 samples. The limit it keeps: the two samples step
// through the layers together, so the conv and the GroupNorm backward with
// its barriers and memory traffic take turns on the SM instead of
// overlapping (offsetting the samples by half a layer measured slower: a
// sample's conv is bound by its warps' dependent mma and shared loads,
// not by the SM's throughput), and each warp reads dc fragments from
// shared memory for every k-step.
//
// Bound of B at N=2048: operations. Its products are 36.4 GFLOP, 0.221 ms
// as 3xTF32 at 495 TFLOP/s (0.54 ms at the fp32 peak); it reads acts (242
// MB), dc (262 MB), x and the scale and bias grads, about 522 MB, 0.156 ms
// at 3.35 TB/s. The mma.sync it runs on issue at about two thirds of that
// peak on the H100 (scripts/torch_mma_rate.py). How the design goes after
// it: every byte of acts and dc is read once, by cp.async straight into
// the layout the fragments are read from, a sample ahead of the products
// (two buffer sets, one barrier a sample). What bounded the earlier forms
// was not the mma but the shared-memory bytes of the fragment loads: with
// one warp a tap (or three taps) and the operands stored as (hi, lo) pairs,
// every warp read all of dc as 8-byte pairs. Here a warp holds all 9 taps
// x all conv channels for one n8 tile of input channels (WShape), so one dc
// fragment serves 27 mma, and both operands stay fp32 in shared memory and
// are split as they load: 26 four-byte loads a lane for 54 mma. 4 warps
// and 80.6 KB a block at F=32, two blocks an SM. Each sample is padded to 80
// pixel rows (10 k8 steps, 4% of the products wasted) with rows of zeros in
// both operands. The partial rows (kChunk samples each) and column_sum keep
// the sum's order fixed. What it keeps: mma.sync, not wgmma, the only way
// to the TF32 peak the bound counts.

constexpr int kChunk = 16;     // samples per partial row of B
constexpr int kKPix = 80;      // B's pixels a sample: 77, padded to k8 steps
// B's layer input as a halo board: kHaloW columns a row (13 used; 15 keeps
// the 4 pixels a quarter warp reads 4 rows apart mod 4 where a board row
// wraps), 9 rows, then the zero rows the padded pixels' taps read
constexpr int kHaloW = 15;
constexpr int kHaloRows = (kRows + 2) * kHaloW;
constexpr int kZeroRows = 2 * kHaloW + 3;
constexpr int kInRows = kHaloRows + kZeroRows;
constexpr int kSamples = 2;    // samples per block of A

// K2a's GroupNorm layout: each thread owns 4 adjacent channels (a quad)
// at kPPT pixels (16 pixel slots x 5 cover the 77 cells).
template <int F>
struct Shape {
  static constexpr int kQuads = F / 4;                   // channel quads
  static constexpr int kThreads = kQuads * kSlots;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kHStride = F + kPadC;
  static_assert(F % 4 == 0 && kThreads % 32 == 0 && kQuads <= 32, "F");
};

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

template <int F>
struct BwdShape {
  static constexpr int kSampleThreads = Shape<F>::kThreads;   // (quad, slot)
  static constexpr int kSampleWarps = Shape<F>::kWarps;
  static constexpr int kThreads = kSamples * kSampleThreads;
  static constexpr int kPair = pair_stride(F);   // (hi, lo) row stride, floats
  static constexpr int kWChunks =                 // float4s of a block's W
      (kTaps * F * F / 4 + kThreads - 1) / kThreads;   //   per thread
  static_assert(kSampleWarps == 2 * (F / 16), "one (m16, pixel half) per warp");
  static_assert(kPair % 32 == 8, "rows of (hi, lo) pairs 8 banks apart");
};

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

// A block's HWIO weights (9, F, F) from global memory into this thread's
// registers, kWChunks float4s, to be split into shared memory later by
// stage_block_weights.
template <int F>
__device__ __forceinline__ void load_block_weights(
    float4 (&wr)[BwdShape<F>::kWChunks], const float* __restrict__ w) {
  using B = BwdShape<F>;
#pragma unroll
  for (int k = 0; k < B::kWChunks; ++k) {
    const int i = threadIdx.x + k * B::kThreads;
    if (i < kTaps * F * F / 4)
      wr[k] = __ldg(reinterpret_cast<const float4*>(w) + i);
  }
}

// Split the weights of load_block_weights into ws as (9, F) rows of F
// (hi, lo) pairs at a row stride of kPair floats.
template <int F>
__device__ __forceinline__ void stage_block_weights(
    float* ws, const float4 (&wr)[BwdShape<F>::kWChunks]) {
  using B = BwdShape<F>;
#pragma unroll
  for (int k = 0; k < B::kWChunks; ++k) {
    const int i = threadIdx.x + k * B::kThreads;
    if (i < kTaps * F * F / 4)
      store_split4(ws + (i / (F / 4)) * B::kPair + 8 * (i % (F / 4)), wr[k]);
  }
}

// The same for the stem's weights (9, cin, F), as (9, cw) rows with the
// rows ci >= cin zero.
template <int F>
__device__ void stage_stem_weights(float* ws, const float* __restrict__ w,
                                   int cin, int cw) {
  using B = BwdShape<F>;
  for (int i = threadIdx.x; i < kTaps * cw * (F / 4); i += B::kThreads) {
    const int f4 = i % (F / 4), row = i / (F / 4);
    const int ci = row % cw, t = row / cw;
    const float4 v = ci < cin ? __ldg(reinterpret_cast<const float4*>(
                                    w + (t * cin + ci) * F) + f4)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    store_split4(ws + row * B::kPair + 8 * f4, v);
  }
}

// The transposed 3x3 torus conv of one sample, an implicit GEMM on the
// tensor cores with the conv's input channels as M and the pixels as N:
// dh[p][ci] = sum over taps t and conv channels f of W[t][ci][f] *
// dc[nbr(p, 8 - t)][f], K = 9 taps x F. A is the HWIO weights as they are
// (f contiguous for each (t, ci): the row layout mma takes for A), B is dc
// gathered through the wrapped-neighbour table with the taps flipped (f
// contiguous for each pixel: the col layout). This warp computes m16 tile
// mt (ci = 16 mt .. 16 mt + 15) against n8 tiles 5 nh .. 5 nh + 4 (pixels
// 40 nh .. 40 nh + 39; those past 76 repeat pixel 76 and are dropped): a
// k-step reads one A and five B fragments for 15 mma. dcs and ws hold
// (hi, lo) TF32 pairs at a row stride of kPair floats (ws as (9, cw)
// rows), so one 8-byte load gives both halves of an element, and with
// kPair = 8 mod 32 the four rows a quarter warp reads lie 8 banks apart:
// no conflicts. Each k-step is three mma: hi*hi into acc, lo*hi + hi*lo
// into a second set of fp32 accumulators added at the end, so that the
// three do not wait on each other and the small terms are not rounded
// against the large ones (it halved K2's error on the card).
template <int F>
__device__ __forceinline__ void conv_transpose_mma(const float* dcs,
                                                   const float* ws, int cw,
                                                   int mt, int nh,
                                                   const int* nbr,
                                                   float (&acc)[kPixTiles][4]) {
  using B = BwdShape<F>;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tq = lane & 3;
  float small[kPixTiles][4];   // the lo*hi + hi*lo terms
#pragma unroll
  for (int j = 0; j < kPixTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = small[j][e] = 0.f;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const float* bp[kPixTiles];   // this lane's pixel of each n8 tile
#pragma unroll
    for (int j = 0; j < kPixTiles; ++j) {
      const int p = min(8 * (kPixTiles * nh + j) + gid, kPix - 1);
      bp[j] = dcs + nbr[p * kTaps + kTaps - 1 - t] * B::kPair + 2 * tq;
    }
    const float* ap = ws + (t * cw + 16 * mt + gid) * B::kPair + 2 * tq;
#pragma unroll
    for (int kk = 0; kk < F / 8; ++kk) {
      const float* ak = ap + 16 * kk;
      const float2 a0 = *reinterpret_cast<const float2*>(ak);
      const float2 a1 = *reinterpret_cast<const float2*>(ak + 8 * B::kPair);
      const float2 a2 = *reinterpret_cast<const float2*>(ak + 8);
      const float2 a3 =
          *reinterpret_cast<const float2*>(ak + 8 * B::kPair + 8);
#pragma unroll
      for (int j = 0; j < kPixTiles; ++j) {
        const float2 b0 = *reinterpret_cast<const float2*>(bp[j] + 16 * kk);
        const float2 b1 =
            *reinterpret_cast<const float2*>(bp[j] + 16 * kk + 8);
        mma_tf32(small[j], a0.y, a1.y, a2.y, a3.y, b0.x, b1.x);
        mma_tf32(small[j], a0.x, a1.x, a2.x, a3.x, b0.y, b1.y);
        mma_tf32(acc[j], a0.x, a1.x, a2.x, a3.x, b0.x, b1.x);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPixTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += small[j][e];
}

template <int F>
__global__ void __launch_bounds__(BwdShape<F>::kThreads, 1)
trunk_bwd_kernel(const float* __restrict__ stem_w,
                 const float* __restrict__ stem_scale,
                 const float* __restrict__ block_w,
                 const float* __restrict__ block_scale,
                 const float* __restrict__ acts, const float* __restrict__ y,
                 const float* __restrict__ xhat,
                 const float* __restrict__ rstd_in,
                 const float* __restrict__ dy, float* __restrict__ dx,
                 float* __restrict__ dc_out, float* __restrict__ dsn, int n,
                 int cin, int layers, int groups) {
  using S = Shape<F>;
  using B = BwdShape<F>;
  extern __shared__ __align__(16) float smem[];
  const int cw = round16(cin);                   // the stem's conv width
  const int wrows = dx && cw > F ? cw : F;
  const int xm_size = 2 * kPix * F + round4(groups);
  float* ws = smem;                              // 9 x wrows x kPair  W
  float* dcs = ws + kTaps * wrows * B::kPair;    // kSamples x kPix x kPair dc
  float* dhs = dcs + kSamples * kPix * B::kPair; // ... x kPix x kHStride dh
  float* xms = dhs + kSamples * kPix * S::kHStride;   // ... x xm_size
  float* red = xms + kSamples * xm_size;         // 2 x all warps x F  sums
  float* chan = red + 2 * kSamples * S::kWarps * F;   // kSamples x 2F
  int* nbr = reinterpret_cast<int*>(chan + kSamples * 2 * F);   // kPix x 9

  const int tid = threadIdx.x;
  const int s = tid / B::kSampleThreads;         // this thread's sample
  const int lt = tid % B::kSampleThreads;
  const int wis = (tid / 32) % B::kSampleWarps;  // warp in the sample
  const size_t ns = static_cast<size_t>(blockIdx.x) * kSamples + s;
  const bool valid = ns < static_cast<size_t>(n);
  const size_t nr = valid ? ns : n - 1;   // an absent sample writes nothing
  const int nl = layers + 1;
  float* dcs_s = dcs + s * kPix * B::kPair;
  float* dhs_s = dhs + s * kPix * S::kHStride;
  float* xm_s = xms + s * xm_size;   // layer l's xhat rows, mask rows, rstd

  // start copying layer l's xhat, the rows its ReLU mask comes from (its
  // saved output) and its rstd into xm_s
  auto prefetch = [&](int l) {
    const float* xg = xhat + (nr * nl + l) * kPix * F;
    const float* og = l == layers ? y + nr * kPix * F
                                  : acts + (nr * layers + l) * kPix * F;
    for (int i = lt; i < kPix * F / 4; i += B::kSampleThreads) {
      cp_async16(xm_s + 4 * i, xg + 4 * i);
      cp_async16(xm_s + kPix * F + 4 * i, og + 4 * i);
    }
    for (int i = lt; i < groups; i += B::kSampleThreads)
      cp_async4(xm_s + 2 * kPix * F + i, rstd_in + (nr * nl + l) * groups + i);
  };

  float4 wr[B::kWChunks];
  if (layers > 0)
    load_block_weights<F>(
        wr, block_w + static_cast<size_t>(layers - 1) * kTaps * F * F);
  fill_neighbours(nbr, B::kThreads);
  const float* dyn = dy + nr * kPix * F;
  for (int i = lt; i < kPix * F / 4; i += B::kSampleThreads)
    cp_async16(dhs_s + (i / (F / 4)) * S::kHStride + 4 * (i % (F / 4)),
               dyn + 4 * i);
  prefetch(layers);
  cp_async_wait_all();
  __syncthreads();

  const int q = lt % S::kQuads;
  const int slot = lt / S::kQuads;
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
  float* red1 = red;                               // sums of g, by warp
  float* red2 = red + kSamples * S::kWarps * F;    // ... of g * xhat
  float* chan_s = chan + s * 2 * F;

  for (int l = layers; l >= 0; --l) {
    // the GroupNorm backward of layer l in the (quad, slot) layout: g =
    // dh where the layer's saved output is positive, from xhat and rstd
    // as K1 saved them
    const float* scale = l == 0 ? stem_scale : block_scale + (l - 1) * F;
    const float4 sc4 = reinterpret_cast<const float4*>(scale)[q];
    const float scv[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
    const float* xh = xm_s;
    const float* ov = xm_s + kPix * F;
    float rstd[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) rstd[j] = xm_s[2 * kPix * F + (4 * q + j) / cpg];
    float g[kPPT][4], xv[kPPT][4], tmp[kPPT][4];
#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
      float4* dhp = reinterpret_cast<float4*>(dhs_s + pix[k] * S::kHStride) + q;
      const float4 dh4 = *dhp;
      const float4 o4 = reinterpret_cast<const float4*>(ov + pix[k] * F)[q];
      const float4 x4 = reinterpret_cast<const float4*>(xh + pix[k] * F)[q];
      const float dhv[4] = {dh4.x, dh4.y, dh4.z, dh4.w};
      const float ovv[4] = {o4.x, o4.y, o4.z, o4.w};
      const float xvv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        g[k][j] = own[k] && ovv[j] > 0.f ? dhv[j] : 0.f;
        xv[k][j] = xvv[j];
        tmp[k][j] = g[k][j] * xvv[j];
      }
      // dh of the layer's input starts as the residual g (blocks)
      if (own[k]) *dhp = make_float4(g[k][0], g[k][1], g[k][2], g[k][3]);
    }
    channel_partials<F>(g, own, q, red1);
    channel_partials<F>(tmp, own, q, red2);
    if (l > 0) stage_block_weights<F>(ws, wr);   // the last conv is done
    __syncthreads();
    if (lt < F) {
      float s1 = 0.f, s2 = 0.f;
      for (int w = s * B::kSampleWarps; w < (s + 1) * B::kSampleWarps; ++w) {
        s1 += red1[w * F + lt];
        s2 += red2[w * F + lt];
      }
      if (valid) {
        float* dn = dsn + (ns * nl + l) * 2 * F;
        dn[lt] = s2;        // d scale
        dn[F + lt] = s1;    // d bias
      }
      chan_s[lt] = s1 * scale[lt];
      chan_s[F + lt] = s2 * scale[lt];
    }
    __syncthreads();

    // dc = rstd (g scale - mean(g scale) - xhat mean(g scale xhat)), to
    // memory for phase B and, split into (hi, lo), to dcs for the conv
    float m1[4], m2[4];
    group_sums_of<F>(chan_s, q, cpg, m1);
    group_sums_of<F>(chan_s + F, q, cpg, m2);
    float* dcn = dc_out + (ns * nl + l) * kPix * F;
#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
      float d[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        d[j] = rstd[j] * (g[k][j] * scv[j] - m1[j] * inv_count -
                          xv[k][j] * (m2[j] * inv_count));
      if (!own[k]) continue;
      const float4 d4 = make_float4(d[0], d[1], d[2], d[3]);
      store_split4(dcs_s + pix[k] * B::kPair + 8 * q, d4);
      if (valid) reinterpret_cast<float4*>(dcn + pix[k] * F)[q] = d4;
    }
    if (l == 0 && dx) stage_stem_weights<F>(ws, stem_w, cin, cw);
    __syncthreads();   // dcs and ws are complete; xm_s is free

    const int lane = tid & 31;
    const int gid = lane >> 2, tq = lane & 3;
    float acc[kPixTiles][4];
    if (l > 0) {
      // layer l - 1's weights, xhat, mask rows and rstd come in meanwhile
      if (l > 1)
        load_block_weights<F>(
            wr, block_w + static_cast<size_t>(l - 2) * kTaps * F * F);
      prefetch(l - 1);
      // dh of block l's input: the residual g plus the transposed conv
      const int mt = wis >> 1, nh = wis & 1;
      conv_transpose_mma<F>(dcs_s, ws, F, mt, nh, nbr, acc);
#pragma unroll
      for (int j = 0; j < kPixTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = 8 * (kPixTiles * nh + j) + 2 * tq + (e & 1);
          if (p < kPix)
            dhs_s[p * S::kHStride + 16 * mt + gid + 8 * (e >> 1)] += acc[j][e];
        }
    } else if (dx) {
      for (int job = wis; job < 2 * (cw / 16); job += B::kSampleWarps) {
        const int mt = job >> 1, nh = job & 1;
        conv_transpose_mma<F>(dcs_s, ws, cw, mt, nh, nbr, acc);
        if (!valid) continue;
#pragma unroll
        for (int j = 0; j < kPixTiles; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = 8 * (kPixTiles * nh + j) + 2 * tq + (e & 1);
            const int ci = 16 * mt + gid + 8 * (e >> 1);
            if (p < kPix && ci < cin) dx[(ns * kPix + p) * cin + ci] = acc[j][e];
          }
      }
    }
    cp_async_wait_all();
    __syncthreads();   // dhs, xm_s and the next layer's weights are complete
  }
}

// Offsets into the flat gradient vector: stem W (9, cin, F), block W
// (L, 9, F, F), scales (L+1, F), biases (L+1, F).
__host__ __device__ inline size_t w_offset(int l, int cin, int f) {
  return l == 0 ? 0
                : static_cast<size_t>(kTaps) * cin * f +
                      static_cast<size_t>(l - 1) * kTaps * f * f;
}

// K2b's shape: kNT warps a block, warp ct owning n8 tile ct of the input
// channels for all 9 taps and every conv channel f (kMT m16 tiles): 2 x 9
// m16n8 tiles at F=32 in two accumulator sets, 144 floats a lane. Two
// blocks an SM (8 warps at F=32, two on each scheduler). Both operands lie
// in shared memory as fp32 and are split into (hi, lo) as their fragments
// load: a lane's 8 dc values of a k-step feed 54 mma, its 18 input values 6
// each.
template <int F>
struct WShape {
  static constexpr int kMT = F / 16;
  static constexpr int kNT = F / 8;    // n8 tiles of input channels a pass
  static constexpr int kWarps = kNT;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kDcStride = F + 8;   // dc rows: 8 mod 32 banks apart
  static_assert(F % 16 == 0 && kDcStride % 32 % 16 == 8, "F");
  // the input's row stride (floats) for c channels, c a multiple of 8: 8
  // or 24 mod 32, so that the four rows a fragment load reads at once lie
  // in different banks
  __host__ __device__ static int in_stride(int cin) {
    const int c = round8(cin > F ? cin : F);
    return c + (c % 16 ? 16 : 8);
  }
  // floats of one of the two buffer sets: dc (kKPix rows), then the layer
  // input as a halo board and its zero rows (kInRows)
  __host__ __device__ static int set_floats(int cin) {
    return kKPix * kDcStride + kInRows * in_stride(cin);
  }
};

// One sample's products of K2b for this warp's n8 tile ct of input
// channels: dW[t][ci][f] += sum over the sample's pixels p of
// in[nbr(p, t)][ci] * dc[p][f] for all 9 taps t, as GEMMs C_t[f][ci] +=
// A[f][p] B_t[p][ci] on the tensor cores (mma.sync m16n8k8, K = the pixels,
// kKPix = 80 of them, 77 real and 3 zero rows in both operands). A is dc as
// it lies in shared memory, B_t the layer's input on a halo board (kHaloW
// columns a row; halo (r, c) holds the input at ((r - 1) mod 7, (c - 1) mod
// 11)), so that tap (a, b) of pixel (r, c) reads halo row (r + a) kHaloW +
// c + b: one lookup a pixel (base), whatever the tap; the padded pixels'
// base points at kZeroRows zero rows. Which operand is M: with the conv
// channels as M, one A fragment serves all 9 taps and B's 9 taps the 2
// m16 tiles, 26 loads a lane for 54 mma (the input channels as M would
// read 9 taps' A of 4 values and dc's B of 2 for each n8 tile of f: 4 x 9 +
// 2 x 4 loads for 72 mma a warp, with 32 input channels; and the stem's 17
// would pad to 32, not 24). Each value is split as it loads
// (split_tf32_trunc): stored as (hi, lo) pairs the fragments doubled the
// shared-memory bytes, and an earlier form of this kernel (12 warps of
// three taps each, operands as pairs) was bound by them; splitting the
// input once a sample onto the halo board instead cost a pass and a
// barrier a sample that took more than the splits it saved. Three mma a
// tile pair, as in K1 and K2a: hi*hi into acc, lo*hi + hi*lo into small,
// added by the caller at the end. The mma issue in the order written (asm
// volatile), so a k-step issues every tile's lo*hi, then every hi*hi, then
// every hi*lo: the two into one small accumulator lie 36 mma apart (back
// to back, the products ran at half the rate).
template <int F>
__device__ __forceinline__ void wgrad_mma(
    const float* dcs, const float* ins, int is, const int* base, int ct,
    float (&acc)[WShape<F>::kMT][9][4], float (&small)[WShape<F>::kMT][9][4]) {
  using W = WShape<F>;
  constexpr int kMT = W::kMT;
  constexpr int kS = W::kDcStride;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tq = lane & 3;
  const float* ap0 = dcs + tq * kS + gid;           // A[f][p] = dc[p][f]
  const float* bp0 = ins + 8 * ct + gid;
  int tap[9];   // each tap's halo offset, floats
#pragma unroll
  for (int t = 0; t < 9; ++t) tap[t] = ((t / 3) * kHaloW + t % 3) * is;
#pragma unroll 2
  for (int kk = 0; kk < kKPix / 8; ++kk) {
    const float* ap = ap0 + 8 * kk * kS;
    float2 av[kMT][4];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      av[mi][0] = split_tf32_trunc(ap[16 * mi]);
      av[mi][1] = split_tf32_trunc(ap[16 * mi + 8]);
      av[mi][2] = split_tf32_trunc(ap[4 * kS + 16 * mi]);
      av[mi][3] = split_tf32_trunc(ap[4 * kS + 16 * mi + 8]);
    }
    const float* b0p = bp0 + base[8 * kk + tq] * is;
    const float* b1p = bp0 + base[8 * kk + tq + 4] * is;
    float2 bv[9][2];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      bv[t][0] = split_tf32_trunc(b0p[tap[t]]);
      bv[t][1] = split_tf32_trunc(b1p[tap[t]]);
    }
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int t = 0; t < 9; ++t)
        mma_tf32(small[mi][t], av[mi][0].y, av[mi][1].y, av[mi][2].y,
                 av[mi][3].y, bv[t][0].x, bv[t][1].x);
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int t = 0; t < 9; ++t)
        mma_tf32(acc[mi][t], av[mi][0].x, av[mi][1].x, av[mi][2].x,
                 av[mi][3].x, bv[t][0].x, bv[t][1].x);
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int t = 0; t < 9; ++t)
        mma_tf32(small[mi][t], av[mi][0].x, av[mi][1].x, av[mi][2].x,
                 av[mi][3].x, bv[t][0].y, bv[t][1].y);
  }
}

template <int F>
__global__ void __launch_bounds__(WShape<F>::kThreads, 2)
trunk_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ acts,
                   const float* __restrict__ dc_all,
                   const float* __restrict__ dsn, float* __restrict__ partials,
                   int n, int cin, int layers, size_t total) {
  using W = WShape<F>;
  extern __shared__ __align__(16) float smem[];
  const int l = blockIdx.x;
  const int n0 = blockIdx.y * kChunk;
  const int n1 = min(n, n0 + kChunk);
  const int nl = layers + 1;
  const int c_in = l == 0 ? cin : F;        // this layer's input channels
  const int nct = round8(c_in) / 8;         // ... in n8 tiles
  const int is = W::in_stride(cin);
  // two buffer sets, each: dc (kKPix x kDcStride), the input's halo board
  // and zero rows (kInRows x is); then each pixel's halo row (base), each
  // halo cell's row and the pixel it holds (halo)
  const int set = W::set_floats(cin);
  auto dcs = [&](int b) { return smem + b * set; };
  auto ins = [&](int b) { return smem + b * set + kKPix * W::kDcStride; };
  constexpr int kBoard = (kRows + 2) * (kCols + 2);   // the halo's cells
  int* base = reinterpret_cast<int*>(smem + 2 * set);   // kKPix
  int2* halo = reinterpret_cast<int2*>(base + kKPix);   // kBoard

  const int tid = threadIdx.x;
  for (int p = tid; p < kKPix; p += W::kThreads)
    base[p] = p < kPix ? (p / kCols) * kHaloW + p % kCols : kHaloRows;
  // each halo cell's row and the pixel it holds
  for (int h = tid; h < kBoard; h += W::kThreads) {
    const int r = h / (kCols + 2), c = h % (kCols + 2);
    halo[h] = make_int2(
        r * kHaloW + c,
        ((r + kRows - 1) % kRows) * kCols + (c + kCols - 1) % kCols);
  }
  // zero for good, as no copy writes them: dc's padded pixel rows, the
  // input's zero rows, and its channels from c_in to the n8 tiles' end
  const int cpad = 8 * nct - c_in;
  for (int b = 0; b < 2; ++b) {
    for (int i = tid; i < (kKPix - kPix) * W::kDcStride; i += W::kThreads)
      dcs(b)[kPix * W::kDcStride + i] = 0.f;
    for (int i = tid; i < kZeroRows * is; i += W::kThreads)
      ins(b)[kHaloRows * is + i] = 0.f;
    for (int i = tid; i < kBoard * cpad; i += W::kThreads) {
      const int r = i / cpad, c = i % cpad;
      ins(b)[(r / (kCols + 2) * kHaloW + r % (kCols + 2)) * is + c_in + c] =
          0.f;
    }
  }
  __syncthreads();   // halo is complete

  // start copying sample s's dc rows and input (onto the halo board) into
  // set b, as they are
  auto stage = [&](int s, int b) {
    const float* dn = dc_all + (static_cast<size_t>(s) * nl + l) * kPix * F;
    for (int i = tid; i < kPix * F / 4; i += W::kThreads)
      cp_async16(dcs(b) + (i / (F / 4)) * W::kDcStride + 4 * (i % (F / 4)),
                 dn + 4 * i);
    if (l == 0) {   // x rows of cin floats: not 16-byte aligned
      const float* xn = x + static_cast<size_t>(s) * kPix * cin;
      for (int i = tid; i < kBoard * cin; i += W::kThreads) {
        const int2 h = halo[i / cin];
        const int c = i % cin;
        cp_async4(ins(b) + h.x * is + c, xn + h.y * cin + c);
      }
    } else {
      const float* an =
          acts + (static_cast<size_t>(s) * layers + l - 1) * kPix * F;
      for (int i = tid; i < kBoard * F / 4; i += W::kThreads) {
        const int2 h = halo[i / (F / 4)];
        const int q = 4 * (i % (F / 4));
        cp_async16(ins(b) + h.x * is + q, an + h.y * F + q);
      }
    }
  };

  const int lane = tid & 31, ct_w = tid >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  float* row = partials + blockIdx.y * total;
  float* dw = row + w_offset(l, cin, F);
  float sb = 0.f;   // the chunk's sum of this thread's scale or bias grad
  auto add_sb = [&](int s, int ct0) {
    if (ct0 == 0 && tid < 2 * F)
      sb += dsn[(static_cast<size_t>(s) * nl + l) * 2 * F + tid];
  };
  // more than one pass only when the stem is wider than F (not GeeseNet's
  // F=32; its stem at F=16): each pass stages the chunk again. A warp whose
  // tile is past the layer's input channels (the stem at F=32: tile 3)
  // copies and runs no products.
  for (int ct0 = 0; ct0 < nct; ct0 += W::kNT) {
    const int ct = ct0 + ct_w;
    float acc[W::kMT][9][4], small[W::kMT][9][4];
#pragma unroll
    for (int mi = 0; mi < W::kMT; ++mi)
#pragma unroll
      for (int t = 0; t < 9; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][t][e] = small[mi][t][e] = 0.f;
    __syncthreads();   // the last pass's products are done with both sets
    stage(n0, 0);
    add_sb(n0, ct0);
    // sample s is in set b; while its products run, sample s + 1 arrives
    // in set b ^ 1, which the products of s - 1 are done with: one barrier
    // a sample
    for (int s = n0; s < n1; ++s) {
      const int b = (s - n0) & 1;
      cp_async_wait_all();
      __syncthreads();   // sample s has arrived; the products of s - 1 are
                         // done with set b ^ 1
      if (s + 1 < n1) {
        stage(s + 1, b ^ 1);
        add_sb(s + 1, ct0);
      }
      if (ct < nct) wgrad_mma<F>(dcs(b), ins(b), is, base, ct, acc, small);
    }
    if (ct < nct) {
#pragma unroll
      for (int mi = 0; mi < W::kMT; ++mi)
#pragma unroll
        for (int t = 0; t < 9; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ci = 8 * ct + 2 * tq + (e & 1);
            const int f = 16 * mi + gid + 8 * (e >> 1);
            if (ci < c_in)
              dw[(static_cast<size_t>(t) * c_in + ci) * F + f] =
                  acc[mi][t][e] + small[mi][t][e];
          }
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
                            const float* stem_scale, const float* block_w,
                            const float* block_scale, const float* acts,
                            const float* y, const float* xhat,
                            const float* rstd, const float* dy, float* dx,
                            float* dc_all, float* dsn, float* partials,
                            float* out, int n, int cin, int layers,
                            int groups, cudaStream_t stream) {
  using S = Shape<F>;
  using B = BwdShape<F>;
  using W = WShape<F>;
  const int cw = round16(cin);
  const int wrows = dx && cw > F ? cw : F;
  const int smem_a = static_cast<int>(
      sizeof(float) * (kTaps * wrows * B::kPair +
                       kSamples * (kPix * (B::kPair + S::kHStride) +
                                   2 * kPix * F + round4(groups)) +
                       2 * kSamples * S::kWarps * F + kSamples * 2 * F) +
      sizeof(int) * kPix * kTaps);
  cudaError_t err = cudaFuncSetAttribute(
      trunk_bwd_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  if (err != cudaSuccess) return err;
  trunk_bwd_kernel<F><<<(n + kSamples - 1) / kSamples, B::kThreads, smem_a,
                        stream>>>(stem_w, stem_scale, block_w, block_scale,
                                  acts, y, xhat, rstd, dy, dx, dc_all, dsn, n,
                                  cin, layers, groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int nl = layers + 1;
  const int chunks = (n + kChunk - 1) / kChunk;
  const size_t total = w_offset(nl, cin, F) + 2 * static_cast<size_t>(nl) * F;
  const int smem_b = static_cast<int>(
      sizeof(float) * 2 * W::set_floats(cin) +
      sizeof(int) * (kKPix + 2 * (kRows + 2) * (kCols + 2)));
  err = cudaFuncSetAttribute(trunk_wgrad_kernel<F>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_b);
  if (err != cudaSuccess) return err;
  trunk_wgrad_kernel<F><<<dim3(nl, chunks), W::kThreads, smem_b, stream>>>(
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
                                   float* saved, float* xhat, float* rstd,
                                   int n, int cin, int f, int layers,
                                   int groups, float eps, void* stream) {
  if (n <= 0 || cin <= 0 || layers < 0 || groups <= 0 || f % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (f) {
    case 16:
      return launch<16>(x, stem_w, stem_scale, stem_bias, block_w, block_scale,
                        block_bias, out, saved, xhat, rstd, n, cin, layers,
                        groups, eps, s);
    case 32:
      return launch<32>(x, stem_w, stem_scale, stem_bias, block_w, block_scale,
                        block_bias, out, saved, xhat, rstd, n, cin, layers,
                        groups, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// acts (n, layers, 77, f), y (n, 77, f), xhat (n, layers+1, 77, f) and
// rstd (n, layers+1, groups) are what the training forward saved. Scratch
// the caller allocates: dc_all (n, layers+1, 77, f), dsn (n, layers+1, 2f),
// partials (ceil(n / geese_trunk_backward_chunk()), total) and out (total),
// total = 9*cin*f + layers*9*f*f + 2*(layers+1)*f.
extern "C" int geese_trunk_backward(
    const float* x, const float* stem_w, const float* stem_scale,
    const float* block_w, const float* block_scale, const float* acts,
    const float* y, const float* xhat, const float* rstd, const float* dy,
    float* dx, float* dc_all, float* dsn, float* partials, float* out, int n,
    int cin, int f, int layers, int groups, void* stream) {
  if (n <= 0 || cin <= 0 || layers < 0 || groups <= 0 || f % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (f) {
    case 16:
      return launch_backward<16>(x, stem_w, stem_scale, block_w, block_scale,
                                 acts, y, xhat, rstd, dy, dx, dc_all, dsn,
                                 partials, out, n, cin, layers, groups, s);
    case 32:
      return launch_backward<32>(x, stem_w, stem_scale, block_w, block_scale,
                                 acts, y, xhat, rstd, dy, dx, dc_all, dsn,
                                 partials, out, n, cin, layers, groups, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int geese_trunk_backward_chunk() { return kChunk; }

extern "C" const char* geese_trunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
