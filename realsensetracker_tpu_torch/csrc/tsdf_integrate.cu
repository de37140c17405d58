// TSDF integration (KinectFusion's running average), hand-written for Hopper (sm_90a).
//
// The JAX package has no Pallas kernel here: integrate
// (realsensetracker_tpu/mapping/tsdf.py:236-411, _fuse_block :277-324) is
// plain XLA. These kernels are the port's own: rst_tsdf_fuse fuses the
// frames of S slots with three launches, whatever S.
//
// The update, per slot, of S (nx, V, V) volumes [slot][x, y, z] (z fastest)
// in place from the slot's (H, W) depth frame seen from its
// pose_cam_from_world, and on colored volumes its (.., 3) color and color
// weight from its (H, W, 3) color frame:
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
// Gates, read from device memory so that no frame waits on the host: the
// slot's `gate` (the tracker's failure hold and integrate_every cadence),
// and its slab window `start` (3 ints) with its `fits` flag (TsdfConfig.
// integrate_slab = S). Outside the window no voxel can meet the update
// predicate (mapping/tsdf.py, slab_bound_ok), so the slab and the full pass
// give the same volume; a closed gate leaves the slot bit-identical.
//
// Design. Bound: bytes, the updated voxels' 16 B (plus 32 B colored) read
// and written and the frame read once. The previous design (kept in
// csrc/alternatives/tsdf_integrate_flat.cu) ran one thread per voxel of the
// whole grid, each projecting and gathering a depth before it could exit:
// at 512^3 134 M threads for ~12.5% of voxels updated. Here the grid is
// tiled into bricks of kBx x kBy x kBz voxels, and only the bricks that can
// hold an updated voxel are visited:
//  1. depth_tiles_kernel writes per slot the largest valid depth of every
//     kTile x kTile pixels (-inf where none), one CTA per tile, and zeroes
//     the count of the brick list.
//  2. cull_kernel tests every brick, 8 lanes a brick (lane c on corner c of
//     its box), 32 bricks a CTA: the gate; the slab window against the
//     brick's range; then, on the brick's box (the voxel cells' outer
//     faces, half a voxel beyond the centres, widened by eps), all 8
//     corners outside one frustum half-space in camera coordinates
//     (z <= min_depth, z > max_depth + trunc, fx x + (cx + 1.5) z < 0 and
//     the other three sides with a pixel of slack: no projection, so it
//     holds for boxes that cross the camera plane); where the whole box
//     lies beyond zpos, its projected corners' pixel rectangle widened by
//     a pixel (rintf and the clamp) misses the frame; or every depth tile
//     of that rectangle (of the whole frame for a box that reaches zpos: a
//     frame without valid depth culls every brick) holds less than
//     (z_min - trunc) - eps. A kept brick is appended to a device list
//     (one atomic per brick; the order does not change any voxel).
//  3. visit_kernel walks the list on as many CTAs as the card holds at
//     once, one brick per CTA at a time, with the per-voxel arithmetic of
//     the previous design: warp rows of 32 consecutive z (128-byte lines),
//     two z per lane sharing the row's f64 coordinates, several rows in
//     flight with all their loads issued before their stores.
// Margins: the per-voxel coordinates are f32 with errors of a few ulps of
// the largest coordinate; the cull runs in f64 on a box half a voxel wider
// than the centres plus eps = 2^-16 (|o| + 3 V vs + |t|) and a pixel of
// slack in every pixel test, so it can only keep too much, never drop an
// updated voxel. brick_mask_reference (kernels/tsdf.py) is its plain twin
// in the same f64 operations; rst_tsdf_depth_tiles and rst_tsdf_cull launch
// the first two kernels alone, so that its list can be held to the twin.
// Offsets: a slot's base in 64 bits (S V^3 passes 2^31), indices inside a
// slot in 32 (V <= 1290, kernels/tsdf.py checks it).
//
// Rounding: the operations and their order are the plain torch version's
// (mapping/tsdf.py _fuse_block, _grid_cam_coords): where compiled JAX fuses
// a multiply-add, both compute the f32 product exactly in f64 and round the
// f64 sum to f32 (fma_r below); round() is rintf (half to even, as
// torch.round and jnp.round); built with -fmad=false (kernels/build.py).
// The kernel and its plain version agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBx = 8, kBy = 8, kBz = 32;  // brick: voxels along x, y, z (kernels/tsdf.py BRICK)
constexpr int kCx = 4, kCy = 4, kCz = 2;    // a cull CTA's region of bricks, 8 lanes each
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kBx * kBy;            // (x, y) rows of kBz voxels per brick
constexpr int kRowsPerHalf = kRows / (2 * kWarps);  // rows per half-warp of a visited brick
constexpr int kRowBatch = 4;                // of which in flight at once (2 voxels each)
constexpr int kVisitBlocks = 3;             // visit CTAs per SM (80 registers a thread)
static_assert(kCx * kCy * kCz == 4 * kWarps && kBz == 32 && kRowsPerHalf % kRowBatch == 0, "region, rows, batch");
constexpr int kTile = 16;                   // depth-tile edge in pixels (kernels/tsdf.py TILE)
constexpr double kEpsScale = 1.0 / 65536.0; // kernels/tsdf.py EPS_SCALE
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  int s, v, h, w, slab;
  int x0, nx;
  int nbx, nby, nbz, nrx, nry, nrz, ntx, nty;
  float fx, fy, cx, cy;
  float ox, oy, oz, vs;
  float trunc, inv_trunc, min_depth, max_depth, max_weight;
  double kl, kr, kt, kb, far, zpos, base;  // the cull's constants (kernels/tsdf.py _Cull)
  int sides;
};

// a * b + c with the f32 product exact in f64 and the f64 sum rounded to
// f32 (one f64 fma: the same value as the product and the sum apart).
__device__ __forceinline__ float fma_r(float a, float b, float c) {
  return static_cast<float>(fma(static_cast<double>(a), static_cast<double>(b), static_cast<double>(c)));
}

__global__ void __launch_bounds__(kTile * kTile)
depth_tiles_kernel(const float* __restrict__ depth, float* __restrict__ tiles, unsigned* count, int h, int w,
                   int ntx, int nty, float min_depth, float max_depth) {
  const int slot = blockIdx.z;
  if (count != nullptr && blockIdx.x == 0 && blockIdx.y == 0 && slot == 0 && threadIdx.x == 0 && threadIdx.y == 0) {
    *count = 0;  // the cull's list of visited bricks starts empty
  }
  const int px = blockIdx.x * kTile + threadIdx.x, py = blockIdx.y * kTile + threadIdx.y;
  float m = -INFINITY;
  if (px < w && py < h) {
    const float d = depth[static_cast<size_t>(slot) * h * w + static_cast<size_t>(py) * w + px];
    if (isfinite(d) && d > min_depth && d < max_depth) m = d;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  __shared__ float part[kTile * kTile / 32];
  const int tid = threadIdx.y * kTile + threadIdx.x;
  if ((tid & 31) == 0) part[tid >> 5] = m;
  __syncthreads();
  if (tid == 0) {
    float r = part[0];
#pragma unroll
    for (int k = 1; k < kTile * kTile / 32; ++k) r = fmaxf(r, part[k]);
    tiles[(static_cast<size_t>(slot) * nty + blockIdx.y) * ntx + blockIdx.x] = r;
  }
}

// Whether brick [lo, hi] (global voxel indices per axis) can hold a voxel
// that this slot's frame updates; called by the 8 lanes of `group` (a lane
// mask) together, returns the same value on each. Lane c takes corner c:
// bit 0 x, bit 1 y, bit 2 z.
__device__ bool brick_visible(const float* pr, const float* __restrict__ tiles, const int lo[3], const int hi[3],
                              const Params& p, int c, unsigned group) {
  bool finite = true;
#pragma unroll
  for (int k = 0; k < 12; ++k) finite = finite && isfinite(pr[k]);
  if (!finite) return false;  // no voxel updates under a non-finite pose
  double R[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) R[k] = pr[k];
  const double eps = (((p.base + fabs(R[3])) + fabs(R[7])) + fabs(R[11])) * kEpsScale;
  const double vs = p.vs;
  const double o[3] = {p.ox, p.oy, p.oz};
  double q[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    q[a] = ((c >> a) & 1) ? (o[a] + static_cast<double>(hi[a] + 1) * vs) + eps
                          : (o[a] + static_cast<double>(lo[a]) * vs) - eps;
  }
  double cam[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) cam[a] = ((R[4 * a] * q[0] + R[4 * a + 1] * q[1]) + R[4 * a + 2] * q[2]) + R[4 * a + 3];
  const double X = cam[0], Y = cam[1], Z = cam[2];
  const double fx = p.fx, fy = p.fy;
  unsigned fail = 0;
  if (Z <= static_cast<double>(p.min_depth)) fail |= 1u;
  if (Z > p.far) fail |= 2u;
  if (p.sides) {
    if (fx * X + p.kl * Z < 0.0) fail |= 4u;
    if (p.kr * Z - fx * X < 0.0) fail |= 8u;
    if (fy * Y + p.kt * Z < 0.0) fail |= 16u;
    if (p.kb * Z - fy * Y < 0.0) fail |= 32u;
  }
  int front = Z > p.zpos;
#pragma unroll
  for (int m = 1; m < 8; m <<= 1) {
    fail &= __shfl_xor_sync(group, fail, m);
    front &= __shfl_xor_sync(group, front, m);
  }
  if (fail != 0u) return false;  // all 8 corners outside one half-space
  // The pixel rectangle of the box's projection, widened by a pixel; the
  // whole frame where the box reaches the camera plane (no projection).
  int ulo = 0, uhi = p.w - 1, vlo = 0, vhi = p.h - 1;
  if (front) {
    const double u = (fx * X) / Z + static_cast<double>(p.cx);
    const double v = (fy * Y) / Z + static_cast<double>(p.cy);
    const double wd = p.w, hd = p.h;
    ulo = static_cast<int>(floor(fmin(fmax(u - 1.0, -1.0), wd)));
    uhi = static_cast<int>(ceil(fmin(fmax(u + 1.0, -1.0), wd)));
    vlo = static_cast<int>(floor(fmin(fmax(v - 1.0, -1.0), hd)));
    vhi = static_cast<int>(ceil(fmin(fmax(v + 1.0, -1.0), hd)));
#pragma unroll
    for (int m = 1; m < 8; m <<= 1) {
      ulo = min(ulo, __shfl_xor_sync(group, ulo, m));
      uhi = max(uhi, __shfl_xor_sync(group, uhi, m));
      vlo = min(vlo, __shfl_xor_sync(group, vlo, m));
      vhi = max(vhi, __shfl_xor_sync(group, vhi, m));
    }
    ulo = max(ulo, 0);
    uhi = min(uhi, p.w - 1);
    vlo = max(vlo, 0);
    vhi = min(vhi, p.h - 1);
    if (ulo > uhi || vlo > vhi) return false;  // the rectangle misses the frame
  }
  double zmin = Z;
#pragma unroll
  for (int m = 1; m < 8; m <<= 1) zmin = fmin(zmin, __shfl_xor_sync(group, zmin, m));
  const double thr = (zmin - static_cast<double>(p.trunc)) - eps;
  const int tx0 = ulo / kTile, ty0 = vlo / kTile;
  const int ntw = uhi / kTile - tx0 + 1, n = ntw * (vhi / kTile - ty0 + 1);
  int hit = 0;
  for (int k = c; k < n && !hit; k += 8) {
    hit = static_cast<double>(tiles[(ty0 + k / ntw) * p.ntx + tx0 + k % ntw]) >= thr;
  }
#pragma unroll
  for (int m = 1; m < 8; m <<= 1) hit |= __shfl_xor_sync(group, hit, m);
  return hit != 0;
}

__global__ void __launch_bounds__(kThreads)
cull_kernel(const float* __restrict__ pose, const float* __restrict__ tiles, const bool* gate, const int* start,
            const bool* fits, unsigned long long* __restrict__ list, unsigned* __restrict__ count, Params p) {
  const int slot = blockIdx.y;
  const int g = threadIdx.x >> 3, c = threadIdx.x & 7;  // 8 lanes per brick, lane c on corner c
  const unsigned group = 0xffu << (8 * ((threadIdx.x & 31) >> 3));
  int r = blockIdx.x;
  const int rz = r % p.nrz;
  r /= p.nrz;
  const int ry = r % p.nry, rx = r / p.nry;
  const int b[3] = {kCx * rx + g % kCx, kCy * ry + (g / kCx) % kCy, kCz * rz + g / (kCx * kCy)};
  if (b[0] >= p.nbx || b[1] >= p.nby || b[2] >= p.nbz) return;
  const int lo[3] = {p.x0 + b[0] * kBx, b[1] * kBy, b[2] * kBz};
  const int hi[3] = {min(lo[0] + kBx - 1, p.x0 + p.nx - 1), min(lo[1] + kBy - 1, p.v - 1),
                     min(lo[2] + kBz - 1, p.v - 1)};
  bool visit = gate == nullptr || gate[slot];
  if (visit && start != nullptr && fits[slot]) {
#pragma unroll
    for (int a = 0; a < 3; ++a) visit = visit && hi[a] >= start[3 * slot + a] && lo[a] <= start[3 * slot + a] + p.slab - 1;
  }
  if (visit) {
    float pr[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) pr[k] = pose[16 * slot + k];
    visit = brick_visible(pr, tiles + static_cast<size_t>(slot) * p.nty * p.ntx, lo, hi, p, c, group);
  }
  if (c != 0 || !visit) return;
  const unsigned brick = (static_cast<unsigned>(b[0]) * p.nby + b[1]) * p.nbz + b[2];
  const unsigned at = atomicAdd(count, 1u);
  if (at < static_cast<unsigned>(p.s) * p.nbx * p.nby * p.nbz) {  // a count left unzeroed cannot overrun
    list[at] = (static_cast<unsigned long long>(slot) << 32) | brick;
  }
}

// Visits the bricks cull_kernel listed: a persistent grid, one brick per CTA
// at a time. Half-warp h of warp w takes rows w + 8 (2 j + h), j = 0..3, of
// the brick's 64 (x, y) rows, and each of its lanes z and z + 16 of each
// row: the row's coordinates (wx, wy and the x, y part of cam, f64 inside)
// serve two voxels. kRowBatch rows (2 kRowBatch voxels) are in flight at
// once, all their loads issued before their stores.
__global__ void __launch_bounds__(kThreads, kVisitBlocks)
visit_kernel(float* __restrict__ tsdf, float* __restrict__ weight, float* __restrict__ color,
             float* __restrict__ color_weight, const float* __restrict__ depth, const float* __restrict__ rgb,
             const float* __restrict__ pose, const int* start, const bool* fits,
             const unsigned long long* __restrict__ list, const unsigned* __restrict__ count, Params p) {
  constexpr int kB = 2 * kRowBatch;  // voxels in flight per thread
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, half = lane >> 4;
  const unsigned n = min(*count, static_cast<unsigned>(p.s) * p.nbx * p.nby * p.nbz);
  const size_t plane = static_cast<size_t>(p.nx) * p.v * p.v;
  const double vs = p.vs, ox = p.ox, oy = p.oy;
  unsigned long long next = blockIdx.x < n ? list[blockIdx.x] : 0ull;
  int loaded = -1;  // the slot whose pose pr holds
  float pr[12];
  double r1[3];
  for (unsigned i = blockIdx.x; i < n; i += gridDim.x) {
    const unsigned long long e = next;
    if (i + gridDim.x < n) next = list[i + gridDim.x];
    const int slot = static_cast<int>(e >> 32);
    const unsigned brick = static_cast<unsigned>(e);
    const int bz = brick % p.nbz, by = (brick / p.nbz) % p.nby, bx = brick / (p.nbz * p.nby);
    const bool windowed = start != nullptr && fits[slot];
    int win[3] = {0, 0, 0};
    if (windowed) {
#pragma unroll
      for (int a = 0; a < 3; ++a) win[a] = start[3 * slot + a];
    }
    if (slot != loaded) {
#pragma unroll
      for (int k = 0; k < 12; ++k) pr[k] = pose[16 * slot + k];
#pragma unroll
      for (int a = 0; a < 3; ++a) r1[a] = pr[4 * a + 1];
      loaded = slot;
    }
    int iz[2];
    bool zok[2];
    float zr[2][3];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      iz[q] = bz * kBz + (lane & 15) + 16 * q;
      zok[q] = iz[q] < p.v && !(windowed && (iz[q] < win[2] || iz[q] >= win[2] + p.slab));
      const float wz = p.oz + (static_cast<float>(iz[q]) + 0.5f) * p.vs;
#pragma unroll
      for (int a = 0; a < 3; ++a) zr[q][a] = pr[4 * a + 2] * wz;
    }
    if (!zok[0] && !zok[1]) continue;
    float* tsdf_s = tsdf + slot * plane;
    float* weight_s = weight + slot * plane;
    const float* depth_s = depth + static_cast<size_t>(slot) * p.h * p.w;
    for (int j0 = 0; j0 < kRowsPerHalf; j0 += kRowBatch) {
      int idx[kB], pix[kB];
      float cz[kB], d[kB];
      bool upd[kB];
#pragma unroll
      for (int jj = 0; jj < kRowBatch; ++jj) {
        const int row = warp + kWarps * (2 * (j0 + jj) + half);
        const int lx = bx * kBx + row / kBy, iy = by * kBy + row % kBy;
        const int ix = p.x0 + lx;  // global x of the slab's plane
        const bool row_ok = lx < p.nx && iy < p.v &&
                            !(windowed && (ix < win[0] || ix >= win[0] + p.slab || iy < win[1] || iy >= win[1] + p.slab));
        // fma_r(ix + 0.5f, vs, ox) and fma_r(r1, wy, r0 wx): the products are exact in f64.
        const float wx = static_cast<float>(fma(static_cast<double>(ix) + 0.5, vs, ox));
        const float wy = static_cast<float>(fma(static_cast<double>(iy) + 0.5, vs, oy));
        float xy[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          xy[a] = static_cast<float>(fma(r1[a], static_cast<double>(wy), static_cast<double>(pr[4 * a] * wx)));
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int k = 2 * jj + q;
          float cam[3];
#pragma unroll
          for (int a = 0; a < 3; ++a) cam[a] = (xy[a] + zr[q][a]) + pr[4 * a + 3];
          cz[k] = cam[2];
          const float zs = cam[2] > 1e-6f ? cam[2] : 1e-6f;
          const float u = p.fx * cam[0] / zs + p.cx;
          const float v = p.fy * cam[1] / zs + p.cy;
          upd[k] = row_ok && zok[q] && (cam[2] > p.min_depth) && (u >= -0.5f) &&
                   (u < static_cast<float>(p.w) - 0.5f) && (v >= -0.5f) && (v < static_cast<float>(p.h) - 0.5f);
          const int ui = min(max(static_cast<int>(rintf(u)), 0), p.w - 1);
          const int vi = min(max(static_cast<int>(rintf(v)), 0), p.h - 1);
          pix[k] = vi * p.w + ui;
          idx[k] = (lx * p.v + iy) * p.v + iz[q];
        }
      }
#pragma unroll
      for (int k = 0; k < kB; ++k) d[k] = upd[k] ? depth_s[pix[k]] : 0.0f;
      float sdf[kB], wb[kB], tb[kB];
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        sdf[k] = d[k] - cz[k];
        upd[k] = upd[k] && isfinite(d[k]) && d[k] > p.min_depth && d[k] < p.max_depth && sdf[k] >= -p.trunc;
        wb[k] = upd[k] ? weight_s[idx[k]] : 0.0f;
        tb[k] = upd[k] ? tsdf_s[idx[k]] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        if (!upd[k]) continue;
        const float obs = fminf(sdf[k] * p.inv_trunc, 1.0f);
        const float w_new = wb[k] + 1.0f;
        tsdf_s[idx[k]] = fma_r(tb[k], wb[k], obs) / fmaxf(w_new, 1.0f);
        weight_s[idx[k]] = fminf(w_new, p.max_weight);
      }
      if (color == nullptr) continue;
      float* color_s = color + 3 * slot * plane;
      float* cw_s = color_weight + slot * plane;
      const float* rgb_s = rgb + 3 * static_cast<size_t>(slot) * p.h * p.w;
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        if (!upd[k] || !(sdf[k] <= p.trunc)) continue;
        const float cwb = cw_s[idx[k]];
        const float cw_new = cwb + 1.0f;
        const float den = fmaxf(cw_new, 1.0f);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const size_t el = 3 * static_cast<size_t>(idx[k]) + ch;
          color_s[el] = fma_r(color_s[el], cwb, rgb_s[3 * static_cast<size_t>(pix[k]) + ch]) / den;
        }
        cw_s[idx[k]] = fminf(cw_new, p.max_weight);
      }
    }
  }
}

}  // namespace

// The sizes and constants of one launch, built once per configuration by
// the caller (kernels/tsdf.py _Config mirrors this layout).
struct Config {
  int s, v, x0, nx, h, w, slab;
  float fx, fy, cx, cy, ox, oy, oz, vs, trunc, inv_trunc, min_depth, max_depth, max_weight;
  double kl, kr, kt, kb, far, zpos, base;  // the cull's constants (kernels/tsdf.py _Cull)
  int sides;
};

namespace {

// The launch parameters of S slots of planes x0 .. x0 + nx - 1 of a V^3
// grid; false for V outside 1..1290, S outside 1..65535, a slab outside the
// grid or an empty frame.
bool make_params(Params& p, const Config* c) {
  if (c == nullptr || c->v < 1 || c->v > 1290 || c->s < 1 || c->s > 65535 || c->x0 < 0 || c->nx < 1 ||
      c->x0 + c->nx > c->v || c->h < 1 || c->w < 1) {
    return false;
  }
  const int nbx = (c->nx + kBx - 1) / kBx, nby = (c->v + kBy - 1) / kBy, nbz = (c->v + kBz - 1) / kBz;
  p = Params{c->s, c->v, c->h, c->w, c->slab, c->x0, c->nx, nbx, nby, nbz, (nbx + kCx - 1) / kCx,
             (nby + kCy - 1) / kCy, (nbz + kCz - 1) / kCz, (c->w + kTile - 1) / kTile, (c->h + kTile - 1) / kTile,
             c->fx, c->fy, c->cx, c->cy, c->ox, c->oy, c->oz, c->vs, c->trunc, c->inv_trunc, c->min_depth,
             c->max_depth, c->max_weight, c->kl, c->kr, c->kt, c->kb, c->far, c->zpos, c->base, c->sides};
  return true;
}

size_t list_bytes(const Params& p) { return 8 * static_cast<size_t>(p.s) * p.nbx * p.nby * p.nbz; }
size_t tiles_bytes(const Params& p) { return 4 * static_cast<size_t>(p.s) * p.nty * p.ntx; }

void launch_tiles(const float* depth, float* tiles, unsigned* count, const Params& p, cudaStream_t stream) {
  depth_tiles_kernel<<<dim3(p.ntx, p.nty, p.s), dim3(kTile, kTile), 0, stream>>>(
      depth, tiles, count, p.h, p.w, p.ntx, p.nty, p.min_depth, p.max_depth);
}

void launch_cull(const float* pose, const float* tiles, const bool* gate, const int* start, const bool* fits,
                 unsigned long long* list, unsigned* count, const Params& p, cudaStream_t stream) {
  cull_kernel<<<dim3(p.nrx * p.nry * p.nrz, p.s), kThreads, 0, stream>>>(pose, tiles, gate, start, fits, list,
                                                                           count, p);
}

}  // namespace

// The bytes of rst_tsdf_fuse's device workspace for `config`: the brick
// list (8 B a brick of every slot), the tile map and the list's count; 0
// for a configuration make_params refuses.
extern "C" long long rst_tsdf_work_bytes(const Config* config) {
  Params p;
  if (!make_params(p, config)) return 0;
  return static_cast<long long>(list_bytes(p) + tiles_bytes(p) + 4);
}

// Fuses S slots' frames in place with three launches on `stream`, no sync:
// the tile map (which zeroes the list's count), the cull (the kept bricks
// into the list) and the update of the listed bricks, on a grid of as many
// CTAs as the card holds at once. S slots' (nx, V, V) tsdf and weight (and
// color (.., 3), color_weight) from their (H, W) depth (and (H, W, 3) rgb)
// frames at pose_cam_from_world (S, 4, 4). color, color_weight and rgb are
// all null (depth-only volumes) or all set; gate may be null (open); start
// and fits are both null or both set. `work` holds rst_tsdf_work_bytes
// (8-byte aligned); `config` is a host pointer. Returns
// cudaGetLastError() as an int, or cudaErrorInvalidValue launching
// nothing.
extern "C" int rst_tsdf_fuse(float* tsdf, float* weight, float* color, float* color_weight, const float* depth,
                             const float* rgb, const float* pose_cam_from_world, const bool* gate, const int* start,
                             const bool* fits, void* work, const Config* config, void* stream) {
  Params p;
  if (!make_params(p, config) || work == nullptr || ((color == nullptr) != (rgb == nullptr)) ||
      ((color == nullptr) != (color_weight == nullptr)) || ((start == nullptr) != (fits == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* list = static_cast<unsigned long long*>(work);
  auto* tiles = reinterpret_cast<float*>(static_cast<char*>(work) + list_bytes(p));
  auto* count = reinterpret_cast<unsigned*>(static_cast<char*>(work) + list_bytes(p) + tiles_bytes(p));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  launch_tiles(depth, tiles, count, p, st);
  launch_cull(pose_cam_from_world, tiles, gate, start, fits, list, count, p, st);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long bricks = static_cast<long long>(p.s) * p.nbx * p.nby * p.nbz;
  const int grid = static_cast<int>(bricks < 1LL * sms * kVisitBlocks ? bricks : 1LL * sms * kVisitBlocks);
  visit_kernel<<<grid, kThreads, 0, st>>>(tsdf, weight, color, color_weight, depth, rgb, pose_cam_from_world, start,
                                          fits, list, count, p);
  return static_cast<int>(cudaGetLastError());
}

// The first two launches alone, to hold the cull against its plain twin
// and to time them: the tile map of S (H, W) frames into `tiles` (S,
// ceil(H/16), ceil(W/16)), zeroing `count` when it is set.
extern "C" int rst_tsdf_depth_tiles(const float* depth, float* tiles, unsigned* count, int s, int h, int w,
                                    float min_depth, float max_depth, void* stream) {
  if (s < 1 || s > 65535 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int ntx = (w + kTile - 1) / kTile, nty = (h + kTile - 1) / kTile;
  depth_tiles_kernel<<<dim3(ntx, nty, s), dim3(kTile, kTile), 0, static_cast<cudaStream_t>(stream)>>>(
      depth, tiles, count, h, w, ntx, nty, min_depth, max_depth);
  return static_cast<int>(cudaGetLastError());
}

// ... and the cull of every brick of S slots (one CTA per 4 x 4 x 2 bricks
// and slot) against the slots' poses, gates, windows and the tile map: the
// kept bricks go to `list` ((slot << 32) | brick, S * nbx * nby * nbz
// entries of room) and its `count` (zeroed by rst_tsdf_depth_tiles).
extern "C" int rst_tsdf_cull(const float* pose_cam_from_world, const float* tiles, const bool* gate, const int* start,
                             const bool* fits, unsigned long long* list, unsigned* count, const Config* config,
                             void* stream) {
  Params p;
  if (!make_params(p, config) || tiles == nullptr || list == nullptr || count == nullptr ||
      ((start == nullptr) != (fits == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  launch_cull(pose_cam_from_world, tiles, gate, start, fits, list, count, p, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rst_tsdf_integrate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
