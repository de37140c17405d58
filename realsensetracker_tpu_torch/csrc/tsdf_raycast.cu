// TSDF raycast march with trilinear refinement, hand-written for Hopper (sm_90a).
//
// The JAX package has no Pallas kernel here: the raycast
// (realsensetracker_tpu/mapping/tsdf.py:446-500 _march, :503-575
// _trilinear_tsdf and _refine_subvoxel) is a plain-XLA fori_loop marching
// all H*W rays in lockstep. Eager PyTorch would pay ~15 launches per step
// for it; this kernel is the port's own, one launch per march.
//
// rst_tsdf_raycast renders one (H, W) depth map from a flat (V^3,) march
// field (clip(tsdf, -1, 1) where observed, 2.0 elsewhere) seen from
// pose_world_from_cam; rst_tsdf_raycast_planes renders it from the volume's
// (V, V, V) tsdf and weight planes, computing each sample's field value from
// them where it reads it, so that no V^3 field is built. Both run one body,
// raycast_kernel, templated on where a sample's value comes from. Ray (u, v)
// has direction R [(u - cx)/fx, (v - cy)/fy, 1] per unit depth and starts at
// z_start[ray] (or z0 when z_start is null):
//   march: z_k = z_start + k * step for k = 1..n_steps, the field sampled
//     nearest-neighbour at t + z_k dir (outside the grid: +1, unobserved);
//     the first step from an observed positive value to an observed value
//     <= 0 is a hit, interpolated linearly between the two samples.
//   refine (hits only, subvoxel_iters times): two observation-gated
//     trilinear samples at z -+ delta along the ray; where both are valid
//     and they fall by more than 1e-6, the hit moves to their linear zero
//     crossing.
//   out = the hit where found and gate[ray] (gate null: all), else 0.
// raycast uses it with z0 = min_depth and the full step budget;
// raycast_coarse_to_fine with z0 at 1/coarse resolution (no refinement),
// then with per-ray z_start, the coarse seeds as gate and refine_steps.
//
// The planes source yields at index i exactly the value the field holds
// there, torch.where(weight > 0, tsdf.clamp(-1, 1), 2.0): weight[i] > 0
// (false for NaN) selects the clamped tsdf, and the clamp is written as
// torch.clamp computes it, passing NaN and -0.0 through unchanged (fminf and
// fmaxf would drop a NaN). So the two sources give the same bits.
//
// Design: one thread per ray. The march stops at the first crossing: JAX
// runs the fixed trip count, but its `found` latches and its hit never
// moves after it, so the result is the same. A ray the gate closes is 0
// whatever its march finds, so it is not marched (its gate word is read
// beside z_start, before the ray's setup). z_k is computed afresh at each
// step (never accumulated), as JAX computes it. Each step is one gather
// of the field, or one of each plane; each refinement 8 of each. The
// planes source issues both loads together, reading the tsdf word whatever
// the weight: skipping it where the weight is 0 made the second load wait
// on the first and measured slower on every march (PERF.md section 6). A
// warp-cooperative march (a team of lanes per ray, one step per lane, a
// ballot for the first crossing) gave the same bits and took several times
// as long on the H100; it was not kept (PERF.md section 6).
//
// Bound: at 640x480 into 128^3 the march's gathers are 20.7 M of one 8 MB
// field (two 8 MB planes for the planes source), so neither bytes nor f32
// operations bound it (0.0093 ms). Building the field instead takes three
// elementwise passes over the volume, ~2.9 GB moved per render at 512^3,
// where a coarse-to-fine render's ~10 M gathers touch a few percent of it.
//
// Rounding: the operations and their order are the plain torch version's
// (mapping/tsdf.py _ray_dirs, _march, _trilinear_tsdf, _refine_subvoxel):
// where compiled JAX fuses a multiply-add, both compute the f32 product
// exactly in f64 and round the f64 sum to f32 (fma_r); round() is rintf
// (half to even); built with -fmad=false. The kernel and its plain version
// agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

struct Params {
  int h, w;
  float cx, cy, rfx, rfy;  // principal point, f32 reciprocals of the focal lengths
  int v;
  float ox, oy, oz, inv_vs;
  float step;
  int n_steps, iters;
  float delta;
};

__device__ __forceinline__ float fma_r(float a, float b, float c) {
  return static_cast<float>(static_cast<double>(a) * static_cast<double>(b) + static_cast<double>(c));
}

__device__ __forceinline__ float clamp01(float x) { return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x); }

struct Ray {
  float t[3], dir[3], o[3];
};

constexpr float kUnobserved = 2.0f;  // the field's value where weight == 0 (mapping/tsdf.py UNOBSERVED)

// A sample's field value, read from the flat march field.
struct FieldSource {
  const float* __restrict__ field;
  __device__ __forceinline__ float operator()(int i) const { return __ldg(field + i); }
};

// A sample's field value, computed from the tsdf and weight planes: the
// tsdf clamped to [-1, 1] (NaN and -0.0 pass, as in torch.clamp) where
// weight > 0, kUnobserved elsewhere (a NaN weight included).
struct PlanesSource {
  const float* __restrict__ tsdf;
  const float* __restrict__ weight;
  __device__ __forceinline__ float operator()(int i) const {
    const float w = __ldg(weight + i);
    const float t = __ldg(tsdf + i);
    return w > 0.0f ? (t < -1.0f ? -1.0f : (t > 1.0f ? 1.0f : t)) : kUnobserved;
  }
};

// Nearest-neighbour march sample at depth z: (value, seen).
template <class Source>
__device__ __forceinline__ float sample(const Source& field, const Ray& r, float z, const Params& p, bool* seen) {
  float g[3];
  bool inside = true;
  const float hi = static_cast<float>(p.v) - 0.5f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    g[a] = fma_r(fma_r(z, r.dir[a], r.t[a]) - r.o[a], p.inv_vs, -0.5f);
    inside = inside && (g[a] > -0.5f) && (g[a] < hi);
  }
  if (!inside) {
    *seen = false;
    return 1.0f;
  }
  const int ix = static_cast<int>(rintf(g[0]));
  const int iy = static_cast<int>(rintf(g[1]));
  const int iz = static_cast<int>(rintf(g[2]));
  const float raw = field((ix * p.v + iy) * p.v + iz);
  *seen = raw < 1.5f;
  return raw;
}

// Observation-gated trilinear sample at depth z: (value, valid).
template <class Source>
__device__ __forceinline__ float trilinear(const Source& field, const Ray& r, float z, const Params& p, bool* valid) {
  int i0[3];
  float fr[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float g = fma_r(fma_r(z, r.dir[a], r.t[a]) - r.o[a], p.inv_vs, -0.5f);
    const float f = fminf(fmaxf(floorf(g), 0.0f), static_cast<float>(p.v - 2));
    i0[a] = static_cast<int>(f);
    fr[a] = clamp01(g - static_cast<float>(i0[a]));
  }
  float acc = 0.0f, w_acc = 0.0f;
  bool first = true;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        float w = ((dx ? fr[0] : 1.0f - fr[0]) * (dy ? fr[1] : 1.0f - fr[1])) * (dz ? fr[2] : 1.0f - fr[2]);
        const float cval = field(((i0[0] + dx) * p.v + i0[1] + dy) * p.v + i0[2] + dz);
        w = w * (cval < 1.5f ? 1.0f : 0.0f);
        if (first) {
          acc = w * cval;
          w_acc = w;
          first = false;
        } else {
          acc = fma_r(w, cval, acc);
          w_acc = w_acc + w;
        }
      }
    }
  }
  *valid = w_acc > 1e-6f;
  return acc / fmaxf(w_acc, 1e-12f);
}

template <class Source>
__global__ void __launch_bounds__(kThreads)
raycast_kernel(const Source field, const float* __restrict__ pose, const float* __restrict__ z_start, float z0,
               const bool* __restrict__ gate, float* __restrict__ out, Params p) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= p.h * p.w) return;
  const bool open = gate == nullptr || gate[ray];  // loaded beside z_start, before the ray's setup
  const float zs = z_start != nullptr ? z_start[ray] : z0;
  const int u = ray % p.w;
  const int v = ray / p.w;
  Ray r;
  const float uu = (static_cast<float>(u) - p.cx) * p.rfx;
  const float vv = (static_cast<float>(v) - p.cy) * p.rfy;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* row = pose + 4 * a;
    r.dir[a] = fma_r(row[0], uu, row[1] * vv) + row[2];
    r.t[a] = row[3];
  }
  r.o[0] = p.ox;
  r.o[1] = p.oy;
  r.o[2] = p.oz;
  if (!open) {  // 0 whatever the march finds
    out[ray] = 0.0f;
    return;
  }

  bool prev_seen;
  float prev_val = sample(field, r, zs, p, &prev_seen);
  float z_hit = 0.0f;
  bool found = false;
  for (int k = 0; k < p.n_steps; ++k) {
    const float z = fma_r(static_cast<float>(k + 1), p.step, zs);
    bool seen;
    const float val = sample(field, r, z, p, &seen);
    if (prev_seen && seen && prev_val > 0.0f && val <= 0.0f) {
      const float denom = prev_val - val;
      const float frac = prev_val / (fabsf(denom) > 1e-12f ? denom : 1e-12f);
      z_hit = fma_r(p.step, clamp01(frac), z - p.step);
      found = true;
      break;
    }
    prev_val = val;
    prev_seen = seen;
  }
  if (!found) {
    out[ray] = 0.0f;
    return;
  }
  float z = z_hit;
  for (int it = 0; it < p.iters; ++it) {
    const float zm = z - p.delta;
    const float zp = z + p.delta;
    bool okm, okp;
    const float pm = trilinear(field, r, zm, p, &okm);
    const float pp = trilinear(field, r, zp, p, &okp);
    const float denom = pm - pp;
    const bool ok = okm && okp && denom > 1e-6f;
    const float frac = clamp01(pm / (ok ? denom : 1.0f));
    if (ok) z = fma_r(2.0f * p.delta, frac, zm);
  }
  out[ray] = z;
}

// Launches one march reading `field` on `stream` (a cudaStream_t) and
// returns cudaGetLastError() as an int: 0 when the launch was accepted.
// Returns cudaErrorInvalidValue, launching nothing, for V outside 2..1290, an
// empty frame or negative step counts.
template <class Source>
int launch(const Source field, const float* pose_world_from_cam, const float* z_start, float z0, const bool* gate,
           float* out, int h, int w, float cx, float cy, float rfx, float rfy, int v, float ox, float oy, float oz,
           float inv_vs, float step, int n_steps, int subvoxel_iters, float delta, void* stream) {
  if (v < 2 || v > 1290 || h < 1 || w < 1 || n_steps < 0 || subvoxel_iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{h, w, cx, cy, rfx, rfy, v, ox, oy, oz, inv_vs, step, n_steps, subvoxel_iters, delta};
  const int n = h * w;
  raycast_kernel<Source><<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      field, pose_world_from_cam, z_start, z0, gate, out, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One march of the flat (V^3,) march field; z_start and gate may be null.
extern "C" int rst_tsdf_raycast(const float* field, const float* pose_world_from_cam, const float* z_start, float z0,
                                const bool* gate, float* out, int h, int w, float cx, float cy, float rfx, float rfy,
                                int v, float ox, float oy, float oz, float inv_vs, float step, int n_steps,
                                int subvoxel_iters, float delta, void* stream) {
  return launch(FieldSource{field}, pose_world_from_cam, z_start, z0, gate, out, h, w, cx, cy, rfx, rfy, v, ox, oy,
                oz, inv_vs, step, n_steps, subvoxel_iters, delta, stream);
}

// The same march reading the volume's (V, V, V) tsdf and weight planes.
extern "C" int rst_tsdf_raycast_planes(const float* tsdf, const float* weight, const float* pose_world_from_cam,
                                       const float* z_start, float z0, const bool* gate, float* out, int h, int w,
                                       float cx, float cy, float rfx, float rfy, int v, float ox, float oy, float oz,
                                       float inv_vs, float step, int n_steps, int subvoxel_iters, float delta,
                                       void* stream) {
  return launch(PlanesSource{tsdf, weight}, pose_world_from_cam, z_start, z0, gate, out, h, w, cx, cy, rfx, rfy, v,
                ox, oy, oz, inv_vs, step, n_steps, subvoxel_iters, delta, stream);
}

extern "C" const char* rst_tsdf_raycast_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
