// Palette indexing of RGBA sprites: for each pixel, the sum of the indices
// of the 256 palette slots whose colour equals the pixel's.
//
// Replaces the TPU kernel
//   palette_and_histo_gan_tpu/ops/palette_pallas.py::_index_kernel
// (the reference's broadcast-equality + scatter-sum: a pixel that matches
// nothing gets 0, a pixel equal to the hotpink filler matches every filler
// slot and gets a sum past 255).
//
// Input: N images of `pixels` RGBA8 pixels (uint8, pixel-major), N palettes
// of 256 int32 RGBA slots with values in [0, 255]; image i is indexed with
// palette i, so the sources and the targets of a split are two launches
// against the same palettes, which are never copied. Output: N x pixels
// int32.
//
// What bounds it on an H100: integer compares. Each pixel is compared with
// all 256 slots (a compare and a select-add each): 2 x 256 int32 operations
// for 8 bytes moved (4 read, 4 written). At the default dataset build, 588
// images of 4096 pixels, that is 1.2e9 operations on ~22 MB; at 16.7e12
// int32 operations/s (132 SMs x 64 INT32 lanes x 1.98 GHz) about 0.074 ms
// against ~0.007 ms for the bytes at 3.35 TB/s.
//
// Design: one thread per pixel, 256 threads a block, grid (image, pixel
// tile). The block packs its image's 256 slots into 1 KB of shared memory,
// one slot a thread, in the byte order of the pixel word; each thread reads
// its pixel as one 32-bit little-endian word (byte 0 = R) and compares it
// with the slots, four at a time through 16-byte shared-memory reads that
// every thread of the warp makes at the same address (a broadcast, no bank
// conflict). The TPU kernel's (N, 256) equality matrix exists for the TPU's
// vector lanes and has no counterpart here. Equality does not care which
// byte order the packing uses, only that pixel and slot share it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 256;
constexpr int kThreads = 256;

__device__ __forceinline__ int match(uint32_t v, uint32_t slot, int index) {
  return v == slot ? index : 0;
}

__global__ void __launch_bounds__(kThreads)
    palette_index_kernel(const uint32_t* __restrict__ pixels,
                         const int32_t* __restrict__ palettes,
                         int32_t* __restrict__ out, int n_pixels) {
  __shared__ __align__(16) uint32_t slots[kSlots];
  const int image = blockIdx.x;
  const int t = threadIdx.x;
  const int32_t* slot = palettes + (static_cast<size_t>(image) * kSlots + t) * 4;
  slots[t] = (static_cast<uint32_t>(slot[0]) & 0xFFu) |
             ((static_cast<uint32_t>(slot[1]) & 0xFFu) << 8) |
             ((static_cast<uint32_t>(slot[2]) & 0xFFu) << 16) |
             ((static_cast<uint32_t>(slot[3]) & 0xFFu) << 24);
  __syncthreads();

  const int p = blockIdx.y * kThreads + t;
  if (p >= n_pixels) return;
  const size_t at = static_cast<size_t>(image) * n_pixels + p;
  const uint32_t v = pixels[at];
  const uint4* quads = reinterpret_cast<const uint4*>(slots);
  int sum = 0;
#pragma unroll 8
  for (int q = 0; q < kSlots / 4; ++q) {
    const uint4 s = quads[q];
    sum += match(v, s.x, 4 * q) + match(v, s.y, 4 * q + 1) +
           match(v, s.z, 4 * q + 2) + match(v, s.w, 4 * q + 3);
  }
  out[at] = sum;
}

}  // namespace

// images: uint8 (n_images, n_pixels, 4), 4-byte aligned; palettes: int32
// (n_images, 256, 4); out: int32 (n_images, n_pixels). Returns the CUDA
// error of the launch (0 on success).
extern "C" int phg_palette_index(const void* images, const int32_t* palettes,
                                 int32_t* out, int n_images, int n_pixels,
                                 void* stream) {
  if (n_images < 1 || n_pixels < 1) return int(cudaErrorInvalidValue);
  const int tiles = (n_pixels + kThreads - 1) / kThreads;
  if (tiles > 65535) return int(cudaErrorInvalidValue);
  const dim3 grid(n_images, tiles);
  palette_index_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(images), palettes, out, n_pixels);
  return int(cudaGetLastError());
}
