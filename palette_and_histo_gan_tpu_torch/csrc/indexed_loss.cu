// The indexed variant's two losses over softmax logits, and their gradient:
// the sparse categorical cross-entropy and the one-hot L1 of the 256-way
// head, each a mean over every pixel.
//
// Replaces no TPU kernel: the JAX package leaves these losses to XLA
// (palette_and_histo_gan_tpu/train/losses.py:108-146). It exists because the
// port's float32 b1024 indexed step spent 65.6 ms a step in them (forward and
// backward up to the logits' gradient) at 5.9% of their bytes floor on an
// NVIDIA H100 80GB HBM3, in elementwise passes that each moved the 4.29 GB of
// logits: two logsumexps forward, two logsumexp and two gather backwards
// added together.
//
// For a row (a pixel) of C = 256 logits z with label t (valid when
// 0 <= t < C):
//   lse = log(sum(exp(z)))
//   seg = clip(lse - z_t, lo, hi) if valid, else 0
//   l1  = 2 (1 - exp(z_t - lse)) / C if valid, else 1 / C
// and the losses are the means of seg and l1 over the N rows. Backward, with
// p_j = exp(z_j - lse), m = valid and lo <= lse - z_t <= hi (the mask of a
// clamp's backward, bounds included):
//   dz_j = g_seg m (p_j - d_jt) / N + g_l1 (-2 / C) p_t (d_jt - p_j) / N
//        = k (p_j - d_jt),  k = g_seg m / N - valid g_l1 (-2 / C) / N p_t.
//
// What bounds it on an H100: bytes. The forward reads the logits once, the
// backward reads them once and writes the gradient once, and each reads the
// int32 labels: at b1024 float32 12.9 GB, 3.86 ms at 3.35 TB/s, against
// ~2.1e9 exponentials (~0.3 ms of the SFU's rate). The forward saves each
// row's lse and z_t (33.6 MB at b1024) for the backward, 0.5% more.
//
// The logits are (images, pixels, C) with strides (image, 1, class) in
// elements: the generator's (B, H, W, C) view of its NCHW head output, the
// pixels of a class next to each other and the classes H W apart. One thread
// takes 4 neighbouring pixels, one 16-byte (float32) or 8-byte (bfloat16)
// load a class, so a warp reads 512 or 256 contiguous bytes a class. Each
// pixel's lse is taken online over chunks of 8 classes: the chunk's max
// m' = max(m, chunk), s = s exp(m - m') + sum(exp(z - m')) (a row holding an
// infinite logit gets a NaN lse). The backward is elementwise: each pixel's k
// from the saved lse and z_t, then one exponential a logit. bfloat16 logits
// are upcast in registers and the gradient rounded once to bfloat16; the
// gradient takes the logits' strides. The forward adds each row's two terms
// in double; a block writes the sum of its rows, in a fixed order, as one
// double2 partial, and a second launch of one block adds the partials in a
// fixed order and divides by N. No atomics: a relaunch gives the same bits.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kClasses = 256;
constexpr int kQuad = 4;  // neighbouring pixels a thread
constexpr int kThreads = 256;
constexpr int kTile = kQuad * kThreads;  // pixels a block
constexpr int kChunk = 8;  // classes a thread loads at once (a step of the online lse)
// the partials' sum
constexpr int kSumThreads = 1024;

struct Layout {
  int64_t images, pixels, image_stride, class_stride;  // the pixel stride is 1
};

__device__ __forceinline__ bool is_valid(int t) { return t >= 0 && t < kClasses; }

__device__ __forceinline__ float bf16_lower(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_upper(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }
__device__ __forceinline__ uint32_t bf16_pack(float lo, float hi) {
  const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}

// A row's two loss terms, added to the running sums.
__device__ __forceinline__ void add_terms(int t, float lse, float z_t, float lo, float hi,
                                          double& seg, double& l1) {
  const float d = lse - z_t;
  const float p_t = expf(z_t - lse);
  // a NaN stays NaN, as through torch.clamp
  seg += is_valid(t) ? (d < lo ? lo : (d > hi ? hi : d)) : 0.0f;
  l1 += (is_valid(t) ? 2.0f * (1.0f - p_t) : 1.0f) / kClasses;
}

// A row's k: dz_j = k (p_j - d_jt).
__device__ __forceinline__ float row_scale(int t, float lse, float z_t, float lo, float hi,
                                           float seg_scale, float l1_scale) {
  const float d = lse - z_t;
  const bool inside = is_valid(t) && d >= lo && d <= hi;
  const float p_t = expf(z_t - lse);
  return (inside ? seg_scale : 0.0f) - (is_valid(t) ? l1_scale * p_t : 0.0f);
}

// the means' backward, as autograd takes it: the upstream gradient / N
__device__ __forceinline__ float2 scales(const float* g_seg, const float* g_l1, int64_t n_rows) {
  const float n = static_cast<float>(n_rows);
  return make_float2(__ldg(g_seg) / n, __ldg(g_l1) * (-2.0f / kClasses) / n);
}

__device__ __forceinline__ void load4(const float* p, float v[kQuad]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[kQuad]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = bf16_lower(u.x); v[1] = bf16_upper(u.x); v[2] = bf16_lower(u.y); v[3] = bf16_upper(u.y);
}
__device__ __forceinline__ void store4(float* p, const float g[kQuad]) {
  *reinterpret_cast<float4*>(p) = make_float4(g[0], g[1], g[2], g[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float g[kQuad]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pack(g[0], g[1]), bf16_pack(g[2], g[3]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cce_forward(const T* __restrict__ logits, Layout x, int tiles,
                       const int32_t* __restrict__ labels, float lo, float hi,
                       float2* __restrict__ stats, double2* __restrict__ partials) {
  __shared__ double seg_sums[kThreads];
  __shared__ double l1_sums[kThreads];
  const int64_t image = blockIdx.x / tiles;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x % tiles) * kTile + threadIdx.x * kQuad;
  double seg = 0.0, l1 = 0.0;
  if (p0 < x.pixels) {  // pixels is a multiple of kQuad
    const T* base = logits + image * x.image_stride + p0;
    const int64_t row0 = image * x.pixels + p0;
    int t[kQuad];
    float m[kQuad], s[kQuad], z_t[kQuad];
#pragma unroll
    for (int i = 0; i < kQuad; ++i) {
      t[i] = __ldg(labels + row0 + i);
      m[i] = -INFINITY;
      s[i] = 0.0f;
      z_t[i] = 0.0f;
    }
    for (int c0 = 0; c0 < kClasses; c0 += kChunk) {
      float v[kChunk][kQuad];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) load4(base + (c0 + j) * x.class_stride, v[j]);
#pragma unroll
      for (int i = 0; i < kQuad; ++i) {
        float top = m[i];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) top = fmaxf(top, v[j][i]);
        float add = 0.0f;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          add += expf(v[j][i] - top);
          z_t[i] = c0 + j == t[i] ? v[j][i] : z_t[i];
        }
        s[i] = s[i] * expf(m[i] - top) + add;
        m[i] = top;
      }
    }
#pragma unroll
    for (int i = 0; i < kQuad; ++i) {
      const float lse = logf(s[i]) + m[i];
      stats[row0 + i] = make_float2(lse, z_t[i]);
      add_terms(t[i], lse, z_t[i], lo, hi, seg, l1);
    }
  }
  seg_sums[threadIdx.x] = seg;
  l1_sums[threadIdx.x] = l1;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      seg_sums[threadIdx.x] += seg_sums[threadIdx.x + half];
      l1_sums[threadIdx.x] += l1_sums[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[blockIdx.x] = make_double2(seg_sums[0], l1_sums[0]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cce_backward(const T* __restrict__ logits, Layout x, int tiles,
                        const int32_t* __restrict__ labels, const float2* __restrict__ stats,
                        const float* __restrict__ g_seg, const float* __restrict__ g_l1,
                        float lo, float hi, T* __restrict__ grad) {
  const int64_t image = blockIdx.x / tiles;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x % tiles) * kTile + threadIdx.x * kQuad;
  if (p0 >= x.pixels) return;
  const float2 scale = scales(g_seg, g_l1, x.images * x.pixels);
  const int64_t at = image * x.image_stride + p0;
  const int64_t row0 = image * x.pixels + p0;
  int t[kQuad];
  float lse[kQuad], k[kQuad];
#pragma unroll
  for (int i = 0; i < kQuad; ++i) {
    t[i] = __ldg(labels + row0 + i);
    const float2 st = __ldg(stats + row0 + i);
    lse[i] = st.x;
    k[i] = row_scale(t[i], st.x, st.y, lo, hi, scale.x, scale.y);
  }
  for (int c0 = 0; c0 < kClasses; c0 += kChunk) {
    // a chunk's loads before its stores: kChunk of them in flight
    float v[kChunk][kQuad];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) load4(logits + at + (c0 + j) * x.class_stride, v[j]);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      float g[kQuad];
#pragma unroll
      for (int i = 0; i < kQuad; ++i) {
        const float p = expf(v[j][i] - lse[i]);
        g[i] = k[i] * (c0 + j == t[i] ? p - 1.0f : p);
      }
      store4(grad + at + (c0 + j) * x.class_stride, g);
    }
  }
}

// ---------------------------------------------------------------- launches

__global__ void __launch_bounds__(kSumThreads)
    cce_mean(const double2* __restrict__ partials, int n_partials, int64_t n_rows,
             float* __restrict__ seg_out, float* __restrict__ l1_out) {
  __shared__ double seg[kSumThreads];
  __shared__ double l1[kSumThreads];
  const int t = threadIdx.x;
  double a = 0.0, b = 0.0;
  for (int i = t; i < n_partials; i += kSumThreads) {
    a += partials[i].x;
    b += partials[i].y;
  }
  seg[t] = a;
  l1[t] = b;
  __syncthreads();
  for (int half = kSumThreads / 2; half > 0; half >>= 1) {
    if (t < half) {
      seg[t] += seg[t + half];
      l1[t] += l1[t + half];
    }
    __syncthreads();
  }
  if (t == 0) {
    *seg_out = static_cast<float>(seg[0] / static_cast<double>(n_rows));
    *l1_out = static_cast<float>(l1[0] / static_cast<double>(n_rows));
  }
}

// the grid of either pass: -1 for a layout the kernels do not take
int64_t blocks(const Layout& x) {
  if (x.images < 1 || x.pixels < 1 || x.pixels % kQuad) return -1;
  const int64_t n = x.images * ((x.pixels + kTile - 1) / kTile);
  return n <= INT32_MAX ? n : -1;
}

int tiles(const Layout& x) { return static_cast<int>((x.pixels + kTile - 1) / kTile); }

}  // namespace

// The forward's partial sums: one double2 a block of its grid; -1 for a
// layout the kernels do not take.
extern "C" int64_t phg_cce_partials(int64_t images, int64_t pixels, int64_t image_stride,
                                    int64_t class_stride) {
  return blocks(Layout{images, pixels, image_stride, class_stride});
}

// logits: (images, pixels, 256) of `dtype` (0 float32, 1 bfloat16) at the
// element strides given, the pixel stride 1 (pixels a multiple of 4, each
// 4 pixels' class entries aligned to 4 elements); labels: int32 (images * pixels,); stats:
// float2 (images * pixels,), each row's (lse, z_t); partials: double2
// (phg_cce_partials(...),); seg, l1: one float32 each. Returns the CUDA
// error of the two launches (0 on success).
extern "C" int phg_cce_forward(const void* logits, int dtype, int64_t images, int64_t pixels,
                               int64_t image_stride, int64_t class_stride,
                               const int32_t* labels, float lo, float hi, void* stats,
                               void* partials, float* seg, float* l1, void* stream) {
  const Layout x{images, pixels, image_stride, class_stride};
  const int64_t grid = blocks(x);
  if (grid < 1 || dtype < 0 || dtype > 1) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* st = static_cast<float2*>(stats);
  double2* sums = static_cast<double2*>(partials);
  const int g = static_cast<int>(grid);
  if (dtype == 0) {
    cce_forward<float><<<g, kThreads, 0, s>>>(
        static_cast<const float*>(logits), x, tiles(x), labels, lo, hi, st, sums);
  } else {
    cce_forward<__nv_bfloat16><<<g, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), x, tiles(x), labels, lo, hi, st, sums);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  cce_mean<<<1, kSumThreads, 0, s>>>(sums, g, images * pixels, seg, l1);
  return int(cudaGetLastError());
}

// The gradient of g_seg * seg + g_l1 * l1 with respect to the logits, into
// grad (the logits' dtype and strides); g_seg and g_l1 are one float32 each
// on the device, stats the forward's.
extern "C" int phg_cce_backward(const void* logits, int dtype, int64_t images, int64_t pixels,
                                int64_t image_stride, int64_t class_stride,
                                const int32_t* labels, const void* stats, const float* g_seg,
                                const float* g_l1, float lo, float hi, void* grad, void* stream) {
  const Layout x{images, pixels, image_stride, class_stride};
  const int64_t grid = blocks(x);
  if (grid < 1 || dtype < 0 || dtype > 1) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* st = static_cast<const float2*>(stats);
  const int g = static_cast<int>(grid);
  if (dtype == 0) {
    cce_backward<float><<<g, kThreads, 0, s>>>(
        static_cast<const float*>(logits), x, tiles(x), labels, st, g_seg, g_l1, lo, hi,
        static_cast<float*>(grad));
  } else {
    cce_backward<__nv_bfloat16><<<g, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), x, tiles(x), labels, st, g_seg, g_l1, lo, hi,
        static_cast<__nv_bfloat16*>(grad));
  }
  return int(cudaGetLastError());
}
