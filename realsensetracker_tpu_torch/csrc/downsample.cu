// Depth-pyramid downsample, hand-written for Hopper (sm_90a).
//
// Replaces the TPU's stride-2 compaction probes stride2_slice and
// stride2_reshape (tools/tpu/mosaic_probe5.py:99-119), the in-kernel 2x2
// downsample that Mosaic refused, and with them the chain of
// realsensetracker_tpu/ops/pyramid.py:downsample_depth calls between
// pyramid levels. From one masked level-0 depth batch (B, H, W) f32
// (0 = invalid) it writes every coarser level 1..n in one launch; each
// level is downsample_depth of the level above:
//   * a coarse pixel is valid iff any of its 4 children is;
//   * its depth is the sum of the valid children over their count;
//   * a trailing odd row or column is dropped (floor), as
//     Intrinsics.halved() assumes.
//
// Validity. The kernel reads depth only: a child is valid iff its depth is
// > 0. That is exact when the level-0 depth was masked with min_depth >= 0
// (then every valid pixel has depth > 0, and a mean of positive depths is
// positive); the wrapper raises on min_depth < 0. Each level's validity is
// written as bool beside its depth, so no caller recomputes it.
//
// Rounding. The sum pairs the rows first, (a00 + a01) + (a10 + a11) -- the
// order the plain version (ops/pyramid.py:downsample_depth) writes out --
// and the mean is a true IEEE divide by the count (nvcc's default
// -prec-div=true; -fmad=false leaves nothing to fuse). So the kernel is
// bit-identical to the plain version on the card and on the CPU.
//
// Bound: device memory. Level 0 is read once (4 B/pixel) and the levels
// below write 5 B per pixel (depth + bool), a third of level 0's pixel
// count, against ~5 flops per output pixel. Design: a block of 32x8
// threads owns a 32x16 tile of level-1 pixels (a 64x32 tile of level 0).
// Each thread pools two level-1 pixels from their 2x2 children -- a warp
// reads two full 256-byte runs of two level-0 rows -- writes them and
// stages them in shared memory; after a barrier a quarter of the threads
// pool level 2 from the tile, then an eighth of those level 3, and so on.
// The tile's origin is a multiple of 2^(n-1) at every level up to the
// fifth, so every child of a coarser pixel lies in the block's own tile:
// no block needs another block's output. Ragged tiles are masked at each
// level by that level's own dimensions (level-1 row 240 of a 482-row image
// is written and has no level-2 parent), and pixels outside them stage 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kTileW = 32;  // level-1 columns per block
constexpr int kTileH = 16;  // level-1 rows per block
constexpr int kMaxLevels = 5;  // coarse levels per launch: the 32x16 tile halves to 2x1

struct Levels {
  float* depth[kMaxLevels];  // level l + 1, (B, h[l + 1], w[l + 1])
  bool* valid[kMaxLevels];
  int h[kMaxLevels + 1];  // h[0], w[0]: the input level
  int w[kMaxLevels + 1];
  int count;  // coarse levels written, 1..kMaxLevels
};

__device__ __forceinline__ float pool(float a00, float a01, float a10, float a11) {
  const int cnt = (a00 > 0.f) + (a01 > 0.f) + (a10 > 0.f) + (a11 > 0.f);
  const float s = (a00 + a01) + (a10 + a11);  // invalid children are +0
  return cnt > 0 ? s / static_cast<float>(cnt) : 0.f;
}

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
downsample_kernel(const float* __restrict__ depth, Levels lv) {
  __shared__ float tile[kTileH][kTileW];
  const int64_t b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;  // level-1 origin of the tile
  const int y0 = blockIdx.y * kTileH;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;

  // Level 1 from level 0: two rows of the tile per thread.
  const int w0 = lv.w[0];
  const float* d0 = depth + b * lv.h[0] * static_cast<int64_t>(w0);
  for (int r = ty; r < kTileH; r += kThreadsY) {
    const int x = x0 + tx;
    const int y = y0 + r;
    float v = 0.f;
    if (x < lv.w[1] && y < lv.h[1]) {
      const float* p = d0 + static_cast<int64_t>(2 * y) * w0 + 2 * x;
      v = pool(p[0], p[1], p[w0], p[w0 + 1]);
      const int64_t o = (b * lv.h[1] + y) * lv.w[1] + x;
      lv.depth[0][o] = v;
      lv.valid[0][o] = v > 0.f;
    }
    tile[r][tx] = v;
  }

  // Levels 2..count from the tile, which shrinks to its top-left corner.
  const int t = ty * kThreadsX + tx;
  for (int l = 1; l < lv.count; ++l) {
    const int tw = kTileW >> l;
    const int th = kTileH >> l;
    const bool active = t < tw * th;
    const int lx = t % tw;
    const int ly = t / tw;
    __syncthreads();  // level l staged
    float v = 0.f;
    if (active) {
      v = pool(tile[2 * ly][2 * lx], tile[2 * ly][2 * lx + 1],
               tile[2 * ly + 1][2 * lx], tile[2 * ly + 1][2 * lx + 1]);
    }
    __syncthreads();  // every child read before the tile is overwritten
    if (active) {
      const int x = (x0 >> l) + lx;
      const int y = (y0 >> l) + ly;
      const bool inside = x < lv.w[l + 1] && y < lv.h[l + 1];
      if (inside) {
        const int64_t o = (b * lv.h[l + 1] + y) * lv.w[l + 1] + x;
        lv.depth[l][o] = v;
        lv.valid[l][o] = v > 0.f;
      }
      tile[ly][lx] = inside ? v : 0.f;
    }
  }
}

}  // namespace

// Writes `levels` coarse levels (1..5) of the (b, h, w) masked depth batch
// into out_depth / out_valid, level after level, each level (b, h_l, w_l)
// contiguous with h_l = h_{l-1} / 2, w_l = w_{l-1} / 2. Launches on
// `stream` (a cudaStream_t) and returns cudaGetLastError() as an int: 0
// when the launch was accepted. Returns cudaErrorInvalidValue, launching
// nothing, for levels outside 1..5 or b above 65535; the caller launches
// nothing when level 1 is empty.
extern "C" int rst_downsample_levels(const float* depth, float* out_depth, bool* out_valid,
                                     int b, int h, int w, int levels, void* stream) {
  if (levels < 1 || levels > kMaxLevels || b < 1 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv{};
  lv.h[0] = h;
  lv.w[0] = w;
  lv.count = levels;
  int64_t offset = 0;
  for (int l = 0; l < levels; ++l) {
    lv.h[l + 1] = lv.h[l] / 2;
    lv.w[l + 1] = lv.w[l] / 2;
    lv.depth[l] = out_depth + offset;
    lv.valid[l] = out_valid + offset;
    offset += static_cast<int64_t>(b) * lv.h[l + 1] * lv.w[l + 1];
  }
  if (lv.h[1] > 0 && lv.w[1] > 0) {
    const dim3 block(kThreadsX, kThreadsY);
    const dim3 grid((lv.w[1] + kTileW - 1) / kTileW, (lv.h[1] + kTileH - 1) / kTileH, b);
    downsample_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(depth, lv);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rst_downsample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
