// InstanceNorm moments: for each (sample, channel) row of a (B, C, H, W)
// tensor, mean = sum(x) * (1/HW) and mean2 = sum(x * x) * (1/HW), with x
// upcast to float32 before the square, both written as (B, C) float32.
//
// Replaces the TPU kernel
//   scripts/bench_in_stats.py::_moments_kernel (reached by stats_pallas)
// which reads a block of 8 samples (8, HW, C) into VMEM and reduces both
// moments over HW in one pass. Its grid is B // 8 blocks, so it leaves the
// rows past the last whole block of 8 unwritten; this kernel writes every
// row, whatever B is.
//
// What bounds it on an H100: bytes. Each input element is read once and
// costs three float32 operations (an add, a multiply-add); at bfloat16 that
// is 1.5 operations a byte against the card's 67e12 / 3.35e12 = 20 float32
// operations a byte of memory. At the four decoder shapes of the TPU
// script, B = 1024 in bfloat16, the reads are 33.5-268 MB: 0.010-0.080 ms
// at 3.35 TB/s.
//
// Design: one template, instantiated for the two memory orders the port's
// callers hold (and for float32 / bfloat16 input, 16-byte vector loads or
// single elements):
//  * NCHW: each row is HW contiguous elements. A group of `width` lanes of
//    a warp (a power of two up to 32) owns a row, so a warp reduces
//    32 / width rows at once where a row is short (HW = 64 in bfloat16: 8
//    vectors, four rows a warp). Each lane reads 16-byte vectors strided by
//    the group's width, keeps a float32 sum and sum of squares in
//    registers, the group adds them with warp shuffles (xor, within the
//    group), and its first lane writes the row's two outputs.
//  * NHWC: a block owns one sample and a tile of channels. `width` threads
//    run along the contiguous channel axis (a 16-byte vector of channels
//    each), so a warp reads whole pixels' channel runs, coalesced; the
//    block's 256 / width thread rows split HW among them, each looping
//    over its pixels with VEC float32 sums and sums of squares in
//    registers. The partial sums go to shared memory and each channel's
//    are added in thread-row order.
// No atomics anywhere: every sum is taken in a fixed order, so a result
// repeats bit for bit from launch to launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
enum Layout { kNCHW = 0, kNHWC = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(uint16_t v) {  // bfloat16 bits
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// VEC elements at p as float32: one 16-byte load (p 16-byte aligned) when
// VEC > 1, else one element. The data is read once: streaming loads.
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_float(__ldcs(p));
  } else {
    static_assert(VEC * sizeof(T) == 16, "a vector is 16 bytes");
    const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        v[i] = __uint_as_float(w[i]);
      } else {  // two bfloat16 a word, the lower address in the low half
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
      }
    }
  }
}

// NCHW: groups of `1 << width_log2` lanes, a row each.
template <typename T, int VEC>
__device__ __forceinline__ void rows_nchw(const T* __restrict__ x, float* __restrict__ mean,
                                          float* __restrict__ mean2, long long rows, int hw,
                                          int width_log2, float inv_hw) {
  const int lane = threadIdx.x & 31;
  const int width = 1 << width_log2;
  const int sub = lane & (width - 1);
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long row = (warp << (5 - width_log2)) + (lane >> width_log2);
  float s = 0.0f, q = 0.0f;
  if (row < rows) {
    const T* p = x + row * hw;
    const int n = hw / VEC;
#pragma unroll 4
    for (int i = sub; i < n; i += width) {
      float v[VEC];
      load<T, VEC>(p + static_cast<long long>(i) * VEC, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        s += v[k];
        q = fmaf(v[k], v[k], q);
      }
    }
  }
  // every lane of the warp takes part: a group past the last row adds zeros
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (off < width) {
      s += __shfl_xor_sync(0xFFFFFFFFu, s, off);
      q += __shfl_xor_sync(0xFFFFFFFFu, q, off);
    }
  }
  if (row < rows && sub == 0) {
    mean[row] = s * inv_hw;
    mean2[row] = q * inv_hw;
  }
}

// NHWC: block (sample, channel tile); `1 << width_log2` threads along the
// channels (VEC channels each), kThreads >> width_log2 thread rows along HW.
template <typename T, int VEC>
__device__ __forceinline__ void columns_nhwc(const T* __restrict__ x, float* __restrict__ mean,
                                             float* __restrict__ mean2, int c, int hw,
                                             int width_log2, float inv_hw) {
  __shared__ float part_s[kThreads * VEC];
  __shared__ float part_q[kThreads * VEC];
  const int width = 1 << width_log2;
  const int thread_rows = kThreads >> width_log2;
  const int col = threadIdx.x & (width - 1);
  const int thread_row = threadIdx.x >> width_log2;
  const long long sample = blockIdx.x;
  const int vector = blockIdx.y * width + col;  // this thread's channels / VEC
  const int tile_channels = width * VEC;
  float s[VEC], q[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s[k] = q[k] = 0.0f;
  if (vector * VEC < c) {
    const T* p = x + sample * hw * c + static_cast<long long>(vector) * VEC;
#pragma unroll 4
    for (int pixel = thread_row; pixel < hw; pixel += thread_rows) {
      float v[VEC];
      load<T, VEC>(p + static_cast<long long>(pixel) * c, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        s[k] += v[k];
        q[k] = fmaf(v[k], v[k], q[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    part_s[thread_row * tile_channels + col * VEC + k] = s[k];
    part_q[thread_row * tile_channels + col * VEC + k] = q[k];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < tile_channels; j += kThreads) {
    const int channel = blockIdx.y * tile_channels + j;
    if (channel >= c) continue;
    float ts = 0.0f, tq = 0.0f;
    for (int r = 0; r < thread_rows; ++r) {
      ts += part_s[r * tile_channels + j];
      tq += part_q[r * tile_channels + j];
    }
    mean[sample * c + channel] = ts * inv_hw;
    mean2[sample * c + channel] = tq * inv_hw;
  }
}

template <Layout L, typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    moments_kernel(const T* __restrict__ x, float* __restrict__ mean, float* __restrict__ mean2,
                   int b, int c, int hw, int width_log2, float inv_hw) {
  if constexpr (L == kNCHW) {
    rows_nchw<T, VEC>(x, mean, mean2, static_cast<long long>(b) * c, hw, width_log2, inv_hw);
  } else {
    columns_nhwc<T, VEC>(x, mean, mean2, c, hw, width_log2, inv_hw);
  }
}

int ceil_log2(long long n) {  // smallest k with 2^k >= n, n >= 1
  int k = 0;
  while ((1LL << k) < n) ++k;
  return k;
}

template <Layout L, typename T, int VEC>
int launch(const void* x, float* mean, float* mean2, int b, int c, int hw, cudaStream_t stream) {
  const float inv_hw = static_cast<float>(1.0 / hw);  // float32(1/HW), as the TPU kernel
  dim3 grid;
  int width_log2;
  if constexpr (L == kNCHW) {
    width_log2 = ceil_log2(hw / VEC);
    if (width_log2 > 5) width_log2 = 5;
    const long long rows = static_cast<long long>(b) * c;
    const long long rows_per_block = (kThreads / 32LL) << (5 - width_log2);
    const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
    if (blocks > 0x7FFFFFFFLL) return int(cudaErrorInvalidValue);
    grid = dim3(static_cast<unsigned>(blocks));
  } else {
    const int vectors = c / VEC;
    width_log2 = ceil_log2(vectors);
    if (width_log2 > 8) width_log2 = 8;  // at most kThreads threads along C
    const int tiles = (vectors + (1 << width_log2) - 1) >> width_log2;
    if (tiles > 65535) return int(cudaErrorInvalidValue);
    grid = dim3(b, tiles);
  }
  moments_kernel<L, T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), mean, mean2, b, c, hw, width_log2, inv_hw);
  return int(cudaGetLastError());
}

template <typename T>
int launch_dtype(const void* x, float* mean, float* mean2, int layout, int b, int c, int hw,
                 cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  // 16-byte loads need every row (NCHW) or pixel (NHWC) to start on 16 bytes
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (layout == kNCHW) {
    if (aligned && (static_cast<long long>(hw) * sizeof(T)) % 16 == 0)
      return launch<kNCHW, T, kVec>(x, mean, mean2, b, c, hw, stream);
    return launch<kNCHW, T, 1>(x, mean, mean2, b, c, hw, stream);
  }
  if (aligned && (static_cast<long long>(c) * sizeof(T)) % 16 == 0)
    return launch<kNHWC, T, kVec>(x, mean, mean2, b, c, hw, stream);
  return launch<kNHWC, T, 1>(x, mean, mean2, b, c, hw, stream);
}

}  // namespace

// x: (b, c, hw) (layout 0, NCHW) or (b, hw, c) (layout 1, NHWC), float32
// (dtype 0) or bfloat16 (dtype 1), fewer than 2^31 elements; mean, mean2:
// float32 (b, c). Returns the CUDA error of the launch (0 on success).
extern "C" int phg_moments(const void* x, float* mean, float* mean2, int dtype, int layout,
                           int b, int c, int hw, void* stream) {
  if (b < 1 || c < 1 || hw < 1 || (layout != kNCHW && layout != kNHWC))
    return int(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dtype<float>(x, mean, mean2, layout, b, c, hw, s);
  if (dtype == 1) return launch_dtype<uint16_t>(x, mean, mean2, layout, b, c, hw, s);
  return int(cudaErrorInvalidValue);
}
