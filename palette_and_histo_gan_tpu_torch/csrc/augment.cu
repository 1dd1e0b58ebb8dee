// Fused paired augmentation for 64x64 RGBA sprites: shared hue rotation,
// keep-with-probability select, shared integer translation with zero fill,
// optional [0, 255] -> [-1, 1] normalize, one write in float32 or bfloat16.
//
// Replaces the TPU kernels
//   palette_and_histo_gan_tpu/ops/augment_pallas.py::_augment_kernel_packed
//     (packed little-endian RGBA u32 input, the train chunk's default), and
//   palette_and_histo_gan_tpu/ops/augment_pallas.py::_augment_kernel
//     (unpacked uint8 or float32 RGBA input),
// as one source templated on the input format and the output type.
//
// What bounds it on an H100: memory. Per image pair at batch 1024 with
// bfloat16 output it reads 2 x 16 KB (packed or uint8) and writes
// 2 x 32 KB, about 100 MB for the batch, about 30 us at 3.35 TB/s. The hue
// chain is ~40 flops per pixel, far below the card's compute rate.
//
// Design: one thread per output pixel handles both images of the pair, so
// the pair's four draws are read once per thread from L1/L2 and the
// translation is a gather at a per-image offset. A pixel is 4 contiguous
// bytes (or one float4), so each image read is one 4- or 16-byte load and
// each write one 16-byte (float32) or 8-byte (bfloat16) store; neighbouring
// threads touch neighbouring pixels. The TPU kernel's one-hot interleave
// matmul and lane rolls exist only for the TPU's (8, 128) tiling and have
// no counterpart here.
//
// Numerics follow the TPU kernel's hue algebra exactly (one reciprocal,
// saturation never formed, hue kept in the [0, 6) sextant domain), with
// floor-mod as fmod plus a sign fix-up (jnp's `%`), IEEE division, and the
// build's -fmad=false so no multiply-add is contracted: the f32 result is
// the plain PyTorch version's op for op, except at the normalize, where
// PyTorch divides by a scalar through its reciprocal (one f32 ulp apart).
// The bfloat16 output is the f32 value rounded once to nearest-even at the
// write.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSide = 64;
constexpr int kPixels = kSide * kSide;
constexpr int kThreads = 256;

enum InputFormat { kPackedU32 = 0, kRgbaU8 = 1, kRgbaF32 = 2 };

__device__ __forceinline__ float floor_mod6(float x) {
  // jnp.remainder: C fmod, then add the divisor when the signs differ
  const float r = fmodf(x, 6.0f);
  return r < 0.0f ? r + 6.0f : r;
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ void hue_rotate(float& r, float& g, float& b,
                                           float delta) {
  const float vmax = fmaxf(fmaxf(r, g), b);
  const float mn = fminf(fminf(r, g), b);
  const float rng = vmax - mn;
  const float inv_rng = 1.0f / (rng == 0.0f ? 1.0f : rng);
  float h;
  if (rng == 0.0f) {
    h = 0.0f;
  } else if (vmax == r) {
    h = floor_mod6((g - b) * inv_rng);
  } else if (vmax == g) {
    h = (b - r) * inv_rng + 2.0f;
  } else {
    h = (r - g) * inv_rng + 4.0f;
  }
  const float dh = floor_mod6(h + 6.0f * delta);
  const float dr = clamp01(fabsf(dh - 3.0f) - 1.0f);
  const float dg = clamp01(2.0f - fabsf(dh - 2.0f));
  const float db = clamp01(2.0f - fabsf(dh - 4.0f));
  r = mn + rng * dr;
  g = mn + rng * dg;
  b = mn + rng * db;
}

template <int FMT>
__device__ __forceinline__ float4 load_pixel(const void* base, long idx) {
  if constexpr (FMT == kPackedU32) {
    const uint32_t v = static_cast<const uint32_t*>(base)[idx];
    return make_float4(float(v & 0xFFu), float((v >> 8) & 0xFFu),
                       float((v >> 16) & 0xFFu), float(v >> 24));
  } else if constexpr (FMT == kRgbaU8) {
    const uchar4 v = static_cast<const uchar4*>(base)[idx];
    return make_float4(float(v.x), float(v.y), float(v.z), float(v.w));
  } else {
    return static_cast<const float4*>(base)[idx];
  }
}

__device__ __forceinline__ void store_pixel(float* out, long idx, float4 v) {
  reinterpret_cast<float4*>(out)[idx] = v;
}

__device__ __forceinline__ void store_pixel(__nv_bfloat16* out, long idx,
                                            float4 v) {
  __nv_bfloat162 lo, hi;
  lo.x = __float2bfloat16_rn(v.x);
  lo.y = __float2bfloat16_rn(v.y);
  hi.x = __float2bfloat16_rn(v.z);
  hi.y = __float2bfloat16_rn(v.w);
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out) + 2 * idx;
  dst[0] = lo;
  dst[1] = hi;
}

template <int FMT, typename OutT, bool NORMALIZE>
__global__ void __launch_bounds__(kThreads)
augment_kernel(const void* __restrict__ src, const void* __restrict__ tgt,
               const float* __restrict__ delta, const int* __restrict__ sy,
               const int* __restrict__ sx, const int* __restrict__ keep,
               OutT* __restrict__ out_s, OutT* __restrict__ out_t) {
  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int y = p / kSide;
  const int x = p % kSide;

  const bool kept = keep[b] != 0;
  const float d = delta[b];
  // a pair left as it is (keep == 0) is neither rotated nor shifted
  const int ys = kept ? y - sy[b] : y;
  const int xs = kept ? x - sx[b] : x;
  const bool inside = ys >= 0 && ys < kSide && xs >= 0 && xs < kSide;

  const long out_idx = long(b) * kPixels + p;
  const long in_idx = long(b) * kPixels + ys * kSide + xs;

  const void* ins[2] = {src, tgt};
  OutT* outs[2] = {out_s, out_t};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (inside) {
      v = load_pixel<FMT>(ins[k], in_idx);
      if (kept) hue_rotate(v.x, v.y, v.z, d);
    }
    if (NORMALIZE) {
      v.x = v.x / 127.5f - 1.0f;
      v.y = v.y / 127.5f - 1.0f;
      v.z = v.z / 127.5f - 1.0f;
      v.w = v.w / 127.5f - 1.0f;
    }
    store_pixel(outs[k], out_idx, v);
  }
}

template <int FMT, typename OutT>
void launch(bool normalize, const void* src, const void* tgt,
            const float* delta, const int* sy, const int* sx, const int* keep,
            void* out_s, void* out_t, int batch, cudaStream_t stream) {
  const dim3 grid(kPixels / kThreads, batch);
  OutT* os = static_cast<OutT*>(out_s);
  OutT* ot = static_cast<OutT*>(out_t);
  if (normalize) {
    augment_kernel<FMT, OutT, true><<<grid, kThreads, 0, stream>>>(
        src, tgt, delta, sy, sx, keep, os, ot);
  } else {
    augment_kernel<FMT, OutT, false><<<grid, kThreads, 0, stream>>>(
        src, tgt, delta, sy, sx, keep, os, ot);
  }
}

template <int FMT>
void launch_fmt(int out_bf16, bool normalize, const void* src, const void* tgt,
                const float* delta, const int* sy, const int* sx,
                const int* keep, void* out_s, void* out_t, int batch,
                cudaStream_t stream) {
  if (out_bf16) {
    launch<FMT, __nv_bfloat16>(normalize, src, tgt, delta, sy, sx, keep,
                               out_s, out_t, batch, stream);
  } else {
    launch<FMT, float>(normalize, src, tgt, delta, sy, sx, keep, out_s, out_t,
                       batch, stream);
  }
}

}  // namespace

// C entry point, bound with ctypes. Returns the cudaError_t of the launch
// (0 on success); cudaErrorInvalidValue for an unknown format or a batch
// the grid cannot hold.
extern "C" int phg_augment(int fmt, int out_bf16, int normalize,
                           const void* src, const void* tgt,
                           const float* delta, const int* sy, const int* sx,
                           const int* keep, void* out_s, void* out_t,
                           int batch, void* stream) {
  if (batch < 1 || batch > 65535) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case kPackedU32:
      launch_fmt<kPackedU32>(out_bf16, normalize != 0, src, tgt, delta, sy,
                             sx, keep, out_s, out_t, batch, s);
      break;
    case kRgbaU8:
      launch_fmt<kRgbaU8>(out_bf16, normalize != 0, src, tgt, delta, sy, sx,
                          keep, out_s, out_t, batch, s);
      break;
    case kRgbaF32:
      launch_fmt<kRgbaF32>(out_bf16, normalize != 0, src, tgt, delta, sy, sx,
                           keep, out_s, out_t, batch, s);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
