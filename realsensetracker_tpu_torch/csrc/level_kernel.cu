// Pyramid-level plane-table builder, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel build_level_packed
// (realsensetracker_tpu/kernels/level_kernel.py: build_level_packed, body
// _level_kernel -> _level_math). For every pixel of a (B, H, W) depth
// batch (0 = invalid) it writes the planar plane table (B, 4, H, W) =
// [nx, ny, nz, d = n . q]:
//   1. unproject the pixel and its 4 neighbours with the level's intrinsics;
//   2. n = (right - left) x (down - up), central differences;
//   3. valid iff the pixel and its 4 neighbours have depth > 0,
//      |n| > 1e-12 and the pixel is not on the image border;
//   4. normalize, flip so that n . q <= 0;
//   5. zero n and d where invalid.
//
// Bound: device memory. Each pixel reads 4 bytes of depth and writes 16
// bytes of plane table, against ~60 flops, far below the H100's ~20
// flop/byte ridge. Design: one thread per output pixel over a
// (col-tile, row-tile, batch) grid of 32x8 blocks. A warp reads 32
// consecutive depths of one row and writes 32 consecutive floats of each
// output plane, so every load and store is coalesced; the 4 neighbour
// reads of a block overlap its own rows and are served by L1/L2, so device
// memory sees the depth about once. The ragged right/bottom edge is
// masked in the kernel, so any H and W work with no padding (the TPU
// version's halo blocks, lane rolls and VMEM tile plan are not needed).
//
// Rounding: the arithmetic follows the plain torch version
// (kernels/level_kernel.py:build_level_packed_reference) operation by
// operation -- a true sqrt and divide rather than rsqrt -- and the library
// is built with -fmad=false, so no multiply-add is fused. Normals of
// grazing surfaces are ill-conditioned in f32: an FMA build was as close
// to an f64 evaluation as the plain version, yet differed from it by up
// to 3.2e-5 there, above the 2e-5 parity tolerance.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;

__global__ void __launch_bounds__(kTileW * kTileH)
level_packed_kernel(const float* __restrict__ depth, float* __restrict__ out,
                    int h, int w, float fx, float fy, float cx, float cy) {
  const int u = blockIdx.x * kTileW + threadIdx.x;
  const int v = blockIdx.y * kTileH + threadIdx.y;
  if (u >= w || v >= h) return;
  const int64_t plane = static_cast<int64_t>(h) * w;
  const int64_t pix = static_cast<int64_t>(v) * w + u;
  const float* d = depth + static_cast<int64_t>(blockIdx.z) * plane;
  float* o = out + static_cast<int64_t>(blockIdx.z) * 4 * plane + pix;

  float nx = 0.f, ny = 0.f, nz = 0.f, dp = 0.f;
  if (u > 0 && u < w - 1 && v > 0 && v < h - 1) {
    const float zc = d[pix];
    const float zl = d[pix - 1];
    const float zr = d[pix + 1];
    const float zu = d[pix - w];
    const float zd = d[pix + w];
    // Unprojection as _level_math writes it: (z * (col - cx)) * (1 / fx).
    const float ifx = 1.f / fx;
    const float ify = 1.f / fy;
    const float uc = static_cast<float>(u) - cx;
    const float vc = static_cast<float>(v) - cy;
    const float ul = static_cast<float>(u - 1) - cx;
    const float ur = static_cast<float>(u + 1) - cx;
    const float vu = static_cast<float>(v - 1) - cy;
    const float vd = static_cast<float>(v + 1) - cy;
    const float dux = zr * ur * ifx - zl * ul * ifx;
    const float duy = zr * vc * ify - zl * vc * ify;
    const float duz = zr - zl;
    const float dvx = zd * uc * ifx - zu * uc * ifx;
    const float dvy = zd * vd * ify - zu * vu * ify;
    const float dvz = zd - zu;
    float cx_ = duy * dvz - duz * dvy;
    float cy_ = duz * dvx - dux * dvz;
    float cz_ = dux * dvy - duy * dvx;
    const float n2 = cx_ * cx_ + cy_ * cy_ + cz_ * cz_;
    const float norm = sqrtf(n2);
    const bool ok = zc > 0.f && zl > 0.f && zr > 0.f && zu > 0.f && zd > 0.f &&
                    norm > 1e-12f;
    if (ok) {
      cx_ /= norm;
      cy_ /= norm;
      cz_ /= norm;
      const float xc = zc * uc * ifx;
      const float yc = zc * vc * ify;
      const float s = (cx_ * xc + cy_ * yc + cz_ * zc > 0.f) ? -1.f : 1.f;
      nx = cx_ * s;
      ny = cy_ * s;
      nz = cz_ * s;
      dp = nx * xc + ny * yc + nz * zc;
    }
  }
  o[0] = nx;
  o[plane] = ny;
  o[2 * plane] = nz;
  o[3 * plane] = dp;
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError() as an int: 0 when the launch was accepted.
extern "C" int rst_level_packed(const float* depth, float* out, int b, int h,
                                int w, float fx, float fy, float cx, float cy,
                                void* stream) {
  if (b > 0 && h > 0 && w > 0) {
    const dim3 block(kTileW, kTileH);
    const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, b);
    level_packed_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        depth, out, h, w, fx, fy, cx, cy);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
