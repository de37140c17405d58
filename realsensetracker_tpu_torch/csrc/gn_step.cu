// Fused Gauss-Newton step of projective point-to-plane ICP, hand-written
// for Hopper (sm_90a).
//
// The TPU never had this kernel: its Pallas version stopped at Mosaic
// lowering blockers, kept as minimal reproducers in
// tools/tpu/mosaic_probe5.py -- the dynamic gathers lane_gather_w256,
// lane_gather_w640 and sublane_gather (the plane-table load) and
// reshape_cross_lane (the (128,16) -> (2048,1) layout of the reduction).
// JAX ran the step as plain XLA (realsensetracker_tpu/align/projective.py:
// associate_planes_t + normal_equations_fixed_t). Here the gather is an
// ordinary load and the reduction a block reduction.
//
// Two entries, one CTA per pair:
//   gn_associate_reduce: per point, transform by T, project, test bounds
//     and depth, round to the nearest pixel (half to even, as torch.round),
//     load the 4-float plane-table row [n | d], test |n|^2 > 0.5; write n,
//     d and ok for the later inner iterations; then reduce the system at
//     the same T.
//   gn_reduce_fixed: the same reduction against stored n, d, ok at an
//     updated T (inner iterations 2 .. inner_iters).
// The reduction applies the plane-distance gate and the GNC weight
// w = (mu / (r^2 + mu))^2, J = [n, p x n], and sums 30 floats per pair:
// the 21 upper-triangle terms of J^T W J (row-major), the 6 of J^T W r,
// then wsse, wsum and the matched count.
//
// Bound: launch and latency, not the card. A pair reads 16-28 bytes per
// point (P = 256..2048) and does ~80 flops per point, so a 512-pair call
// moves ~25 MB: microseconds at 3.35 TB/s. What the kernel removes is the
// ~150 small torch launches of an association round. Design: 256 threads
// stride over the points of their pair with register partials, reduce
// with warp shuffles, then across the 8 warps through shared memory, in a
// fixed order with no atomics, so a run is bit-identical to the next.
// Ragged point counts are masked by the stride loop.
//
// Rounding: built with -fmad=false, the arithmetic follows the plain torch
// version operation by operation (gnc_mu / x as reciprocal(x) * gnc_mu, as
// torch's __rtruediv__), except the 3x3 point transform: torch runs it in
// a GEMM with fused multiply-adds, so the kernel chains explicit fmaf in
// the order of a GEMM's inner loop. A point that projects within an ulp
// of a pixel's half-way line can still land on the neighbouring pixel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSystem = 30;
constexpr int kUpper = 21;

struct Pose {
  float r[9];
  float t[3];
};

__device__ __forceinline__ Pose load_pose(const float* T) {
  Pose p;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) p.r[3 * i + j] = T[4 * i + j];
    p.t[i] = T[4 * i + 3];
  }
  return p;
}

// R x + t, each row as a GEMM's inner loop computes it: fma chain over k.
__device__ __forceinline__ void transform(const Pose& T, float x, float y, float z,
                                          float& px, float& py, float& pz) {
  px = fmaf(T.r[2], z, fmaf(T.r[1], y, T.r[0] * x)) + T.t[0];
  py = fmaf(T.r[5], z, fmaf(T.r[4], y, T.r[3] * x)) + T.t[1];
  pz = fmaf(T.r[8], z, fmaf(T.r[7], y, T.r[6] * x)) + T.t[2];
}

// Round-half-to-even pixel index clamped to [0, size - 1]; NaN -> 0,
// +inf -> size - 1, -inf -> 0 (fmaxf returns the non-NaN operand).
__device__ __forceinline__ int pixel_index(float c, int size) {
  return static_cast<int>(rintf(fminf(fmaxf(c, 0.f), static_cast<float>(size - 1))));
}

// One point's contribution to the pair's 30 partial sums.
__device__ __forceinline__ void accumulate(float (&acc)[kSystem], float px, float py,
                                           float pz, float nx, float ny, float nz,
                                           float d, bool ok, float dist_threshold,
                                           float gnc_mu) {
  const float r = (nx * px + ny * py) + nz * pz - d;
  if (!ok || !(fabsf(r) < dist_threshold)) return;
  const float l = (1.f / (r * r + gnc_mu)) * gnc_mu;
  const float w = l * l;
  const float J[6] = {nx, ny, nz, py * nz - pz * ny, pz * nx - px * nz, px * ny - py * nx};
  float Jw[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) Jw[i] = J[i] * w;
  int q = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) acc[q++] += Jw[i] * J[j];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[kUpper + i] += Jw[i] * r;
  acc[27] += w * r * r;
  acc[28] += w;
  acc[29] += 1.f;
}

// Sums the block's partials in a fixed order and writes the pair's 30
// floats: warp shuffles first, then the 8 warp sums in warp order.
__device__ __forceinline__ void block_reduce_store(float (&acc)[kSystem], float* out) {
  __shared__ float partial[kWarps][kSystem];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSystem; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) partial[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kSystem) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += partial[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
gn_associate_reduce_kernel(const float* __restrict__ T, const float* __restrict__ pts,
                           const uint8_t* __restrict__ src_ok,
                           const float* __restrict__ packed, int p, int h, int w,
                           float fx, float fy, float cx, float cy, float min_depth,
                           float dist_threshold, float gnc_mu, float* __restrict__ n_out,
                           float* __restrict__ d_out, uint8_t* __restrict__ ok_out,
                           float* __restrict__ system) {
  const int64_t pair = blockIdx.x;
  const Pose pose = load_pose(T + pair * 16);
  const float* X = pts + pair * 3 * p;
  const uint8_t* sok = src_ok + pair * p;
  const int64_t plane = static_cast<int64_t>(h) * w;
  const float* table = packed + pair * 4 * plane;
  float* n = n_out + pair * 3 * p;
  float* dd = d_out + pair * p;
  uint8_t* okk = ok_out + pair * p;
  const float u_max = static_cast<float>(w - 1);
  const float v_max = static_cast<float>(h - 1);

  float acc[kSystem];
#pragma unroll
  for (int k = 0; k < kSystem; ++k) acc[k] = 0.f;

  for (int i = threadIdx.x; i < p; i += kThreads) {
    float px, py, pz;
    transform(pose, X[i], X[p + i], X[2 * p + i], px, py, pz);
    const float zs = fabsf(pz) > 1e-12f ? pz : 1e-12f;
    const float u = fx * px / zs + cx;
    const float v = fy * py / zs + cy;
    const bool inb = u >= 0.f && u <= u_max && v >= 0.f && v <= v_max && pz > min_depth;
    const int64_t pix = static_cast<int64_t>(pixel_index(v, h)) * w + pixel_index(u, w);
    const float nx = table[pix];
    const float ny = table[plane + pix];
    const float nz = table[2 * plane + pix];
    const float dp = table[3 * plane + pix];
    const bool ok = sok[i] != 0 && inb && (nx * nx + ny * ny) + nz * nz > 0.5f;
    n[i] = nx;
    n[p + i] = ny;
    n[2 * p + i] = nz;
    dd[i] = dp;
    okk[i] = ok ? 1 : 0;
    accumulate(acc, px, py, pz, nx, ny, nz, dp, ok, dist_threshold, gnc_mu);
  }
  block_reduce_store(acc, system + pair * kSystem);
}

__global__ void __launch_bounds__(kThreads)
gn_reduce_fixed_kernel(const float* __restrict__ T, const float* __restrict__ pts,
                       const float* __restrict__ n_in, const float* __restrict__ d_in,
                       const uint8_t* __restrict__ ok_in, int p, float dist_threshold,
                       float gnc_mu, float* __restrict__ system) {
  const int64_t pair = blockIdx.x;
  const Pose pose = load_pose(T + pair * 16);
  const float* X = pts + pair * 3 * p;
  const float* n = n_in + pair * 3 * p;
  const float* dd = d_in + pair * p;
  const uint8_t* okk = ok_in + pair * p;

  float acc[kSystem];
#pragma unroll
  for (int k = 0; k < kSystem; ++k) acc[k] = 0.f;

  for (int i = threadIdx.x; i < p; i += kThreads) {
    float px, py, pz;
    transform(pose, X[i], X[p + i], X[2 * p + i], px, py, pz);
    accumulate(acc, px, py, pz, n[i], n[p + i], n[2 * p + i], dd[i], okk[i] != 0,
               dist_threshold, gnc_mu);
  }
  block_reduce_store(acc, system + pair * kSystem);
}

}  // namespace

// Both entries launch on `stream` (a cudaStream_t) and return
// cudaGetLastError() as an int: 0 when the launch was accepted.
extern "C" int rst_gn_associate_reduce(const float* T, const float* pts,
                                       const uint8_t* src_ok, const float* packed,
                                       int b, int p, int h, int w, float fx, float fy,
                                       float cx, float cy, float min_depth,
                                       float dist_threshold, float gnc_mu, float* n_out,
                                       float* d_out, uint8_t* ok_out, float* system,
                                       void* stream) {
  if (b > 0) {
    gn_associate_reduce_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        T, pts, src_ok, packed, p, h, w, fx, fy, cx, cy, min_depth, dist_threshold, gnc_mu,
        n_out, d_out, ok_out, system);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rst_gn_reduce_fixed(const float* T, const float* pts, const float* n,
                                   const float* d, const uint8_t* ok, int b, int p,
                                   float dist_threshold, float gnc_mu, float* system,
                                   void* stream) {
  if (b > 0) {
    gn_reduce_fixed_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        T, pts, n, d, ok, p, dist_threshold, gnc_mu, system);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rst_gn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
