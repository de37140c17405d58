// THE PREVIOUS DESIGN, kept only so that chip_smoke.py can time it in turns
// with csrc/tsdf_integrate.cu (voxel bricks culled on the device), which
// replaced it. No path of the port launches it. Its original notes follow.
//
// TSDF integration (KinectFusion's running average), hand-written for Hopper (sm_90a).
//
// The JAX package has no Pallas kernel here: integrate
// (realsensetracker_tpu/mapping/tsdf.py:236-411, _fuse_block :277-324) is
// plain XLA. This kernel is the port's own, one launch per fused frame.
//
// rst_tsdf_integrate updates a (V, V, V) volume [x, y, z] (z fastest) in
// place from one (H, W) depth frame seen from pose_cam_from_world, and on a
// colored volume its (V, V, V, 3) color and (V, V, V) color weight from an
// (H, W, 3) color frame:
//   cam = R (origin + (idx + 0.5) vs) + t; pixel = round(f cam / z + c);
//   d = depth[pixel] (valid: finite, min_depth < d < max_depth);
//   sdf = d - cam_z; update where cam_z > min_depth, the pixel lies in the
//   frame, d is valid and sdf >= -trunc: tsdf <- (tsdf w + min(sdf/trunc, 1))
//   / max(w + 1, 1), w <- min(w + 1, max_weight); color likewise over
//   |sdf| <= trunc.
//
// Slab storage: the arrays may hold an x-slab of the grid, nx planes from
// global x0 ((nx, V, V), the layout of mapping/sharded.py, one slab per
// rank); x0 = 0, nx = V is the whole volume. A voxel's centre comes from
// its GLOBAL index x0 + ix, so a slab rounds every voxel as the whole
// volume does and the slabs together are bit-identical to it.
//
// Gates, read from device memory so that no frame waits on the host:
// `gate` (the tracker's failure hold and integrate_every cadence), and the
// slab window `start` (3 ints) with its `fits` flag (TsdfConfig.
// integrate_slab = S). A thread whose voxel the gates close -- gate false,
// or fits true and the voxel outside start..start+S on an axis -- exits
// before touching memory. Outside the slab no voxel can meet the update
// predicate (mapping/tsdf.py, slab_bound_ok), so the slab and the full pass
// give the same volume; a closed gate leaves it bit-identical.
//
// Design: one thread per voxel over the whole grid, consecutive threads
// along z (the fastest axis), so each warp reads and writes 128 contiguous
// bytes of each plane. A voxel out of the frustum or behind the surface's
// band exits after ~20 flops and one depth gather (the 1.2 MB frame stays in
// L2); only updated voxels read and write the volume (16 B, 48 B colored).
// Linear indices are int32: V <= 1290 (kernels/tsdf.py checks it).
//
// Rounding: the operations and their order are the plain torch version's
// (mapping/tsdf.py _fuse_block, _grid_cam_coords): where compiled JAX fuses
// a multiply-add, both compute the f32 product exactly in f64 and round the
// f64 sum to f32 (fma_r below); round() is rintf (half to even, as
// torch.round and jnp.round); built with -fmad=false (kernels/build.py).
// The kernel and its plain version agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Params {
  int v, h, w, slab;
  int x0, nx;
  float fx, fy, cx, cy;
  float ox, oy, oz, vs;
  float trunc, inv_trunc, min_depth, max_depth, max_weight;
};

__device__ __forceinline__ float fma_r(float a, float b, float c) {
  return static_cast<float>(static_cast<double>(a) * static_cast<double>(b) + static_cast<double>(c));
}

__global__ void __launch_bounds__(kThreads)
integrate_kernel(float* __restrict__ tsdf, float* __restrict__ weight, float* __restrict__ color,
                 float* __restrict__ color_weight, const float* __restrict__ depth,
                 const float* __restrict__ rgb, const float* __restrict__ pose, const bool* gate,
                 const int* start, const bool* fits, Params p) {
  const int n = p.nx * p.v * p.v;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  if (gate != nullptr && !*gate) return;
  const int iz = idx % p.v;
  const int iy = (idx / p.v) % p.v;
  const int ix = p.x0 + idx / (p.v * p.v);  // global x of the slab's plane
  if (start != nullptr && *fits) {
    const int sx = start[0], sy = start[1], sz = start[2];
    if (ix < sx || ix >= sx + p.slab || iy < sy || iy >= sy + p.slab || iz < sz || iz >= sz + p.slab) return;
  }
  const float wx = fma_r(static_cast<float>(ix) + 0.5f, p.vs, p.ox);
  const float wy = fma_r(static_cast<float>(iy) + 0.5f, p.vs, p.oy);
  const float wz = p.oz + (static_cast<float>(iz) + 0.5f) * p.vs;
  float cam[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* row = pose + 4 * a;
    cam[a] = (fma_r(row[1], wy, row[0] * wx) + row[2] * wz) + row[3];
  }
  const float cz = cam[2];
  const float zs = cz > 1e-6f ? cz : 1e-6f;
  const float u = p.fx * cam[0] / zs + p.cx;
  const float v = p.fy * cam[1] / zs + p.cy;
  const bool inb = (cz > p.min_depth) && (u >= -0.5f) && (u < static_cast<float>(p.w) - 0.5f) && (v >= -0.5f) &&
                   (v < static_cast<float>(p.h) - 0.5f);
  if (!inb) return;
  const int ui = min(max(static_cast<int>(rintf(u)), 0), p.w - 1);
  const int vi = min(max(static_cast<int>(rintf(v)), 0), p.h - 1);
  const int pix = vi * p.w + ui;
  const float d = depth[pix];
  if (!(isfinite(d) && d > p.min_depth && d < p.max_depth)) return;
  const float sdf = d - cz;
  if (!(sdf >= -p.trunc)) return;
  const float obs = fminf(sdf * p.inv_trunc, 1.0f);
  const float wb = weight[idx];
  const float w_new = wb + 1.0f;
  tsdf[idx] = fma_r(tsdf[idx], wb, obs) / fmaxf(w_new, 1.0f);
  weight[idx] = fminf(w_new, p.max_weight);
  if (color == nullptr || !(sdf <= p.trunc)) return;
  const float cwb = color_weight[idx];
  const float cw_new = cwb + 1.0f;
  const float den = fmaxf(cw_new, 1.0f);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    color[3 * idx + c] = fma_r(color[3 * idx + c], cwb, rgb[3 * pix + c]) / den;
  }
  color_weight[idx] = fminf(cw_new, p.max_weight);
}

}  // namespace

// Launches one integration of the slab of planes x0 .. x0 + nx - 1 of a V^3
// grid (arrays (nx, V, V)) on `stream` (a cudaStream_t) and returns
// cudaGetLastError() as an int: 0 when the launch was accepted. color,
// color_weight and rgb are all null (depth-only volume) or all set; gate may
// be null (open); start and fits are both null (whole volume) or both set.
// Returns cudaErrorInvalidValue, launching nothing, for V outside 1..1290,
// a slab outside the grid or an empty frame.
extern "C" int rst_tsdf_integrate(float* tsdf, float* weight, float* color, float* color_weight,
                                  const float* depth, const float* rgb, const float* pose_cam_from_world,
                                  const bool* gate, const int* start, const bool* fits,
                                  int v, int x0, int nx, int h, int w, int slab,
                                  float fx, float fy, float cx, float cy,
                                  float ox, float oy, float oz, float vs,
                                  float trunc, float inv_trunc, float min_depth, float max_depth, float max_weight,
                                  void* stream) {
  if (v < 1 || v > 1290 || x0 < 0 || nx < 1 || x0 + nx > v || h < 1 || w < 1 ||
      ((color == nullptr) != (rgb == nullptr)) || ((start == nullptr) != (fits == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{v, h, w, slab, x0, nx, fx, fy, cx, cy, ox, oy, oz, vs,
                 trunc, inv_trunc, min_depth, max_depth, max_weight};
  const int n = nx * v * v;
  const int blocks = (n + kThreads - 1) / kThreads;
  integrate_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tsdf, weight, color, color_weight, depth, rgb, pose_cam_from_world, gate, start, fits, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rst_tsdf_integrate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
