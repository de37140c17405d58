// One Gauss-Newton association round of projective point-to-plane ICP,
// hand-written for Hopper (sm_90a): gn_round.
//
// The TPU never had this kernel: its Pallas version stopped at Mosaic
// lowering blockers, kept as minimal reproducers in
// tools/tpu/mosaic_probe5.py -- the dynamic gathers lane_gather_w256 (:53),
// lane_gather_w640 (:66) and sublane_gather (:79) (the plane-table load)
// and reshape_cross_lane (:91) (the layout of the reduction). JAX runs the
// round as plain XLA (realsensetracker_tpu/align/projective.py:_step:
// associate_planes_t, then inner_iters x (normal_equations_fixed_t ->
// solve_update)). Here the gather is an ordinary load and the reduction a
// fixed-order tree across a thread-block cluster.
//
// What one launch does, for each of B pairs:
//   1. associate at the pose T: transform each point, project, test bounds
//      and depth, round to the nearest pixel (half to even, as
//      torch.round), load the 4-float plane-table row [n | d], test
//      |n|^2 > 0.5;
//   2. inner_iters times, against those fixed planes: reduce the gated,
//      GNC-weighted system (w = (mu / (r^2 + mu))^2, J = [n, p x n]) into
//      30 floats -- the 21 upper-triangle terms of J^T W J (row-major), the
//      6 of J^T W r, then wsse, wsum and the matched count; solve the damped
//      system (H + lam I) x = b, lam = damping * trace(H) + 1e-12, by LU with
//      partial pivoting (the first maximum is the pivot, as LAPACK's getrf);
//      delta = -x, or 0 when a pivot is exactly 0 or delta is not finite;
//      T <- se3.exp(delta) T, with the small-angle branches of
//      geometry/se3.py.
// It writes the new poses (B,4,4) and the last step's rmse =
// sqrt(wsse / (wsum + 1e-12)), inlier fraction = count / P and count.
//
// Bound: latency and launches, not the card. A pair reads 13 bytes per
// point, 16 more per valid point's plane row, and 64 bytes of pose, and
// does ~100 f32 operations per matched point per inner iteration: a
// 512-pair round at 2048 points must move ~30 MB, ~9 us at 3.35 TB/s
// (the planar table makes each row four 32-byte sectors, ~4x that in
// sector traffic). What the round costs instead is the chain of dependent
// loads (point -> pixel -> plane row), the barriers and the serial 6x6
// solve, and on the host the launches: the two kernels this one replaces
// stopped at the 30-float system, and torch's solve and SE(3) update
// added ~100 launches per inner iteration. Now a round is one launch.
//
// Design:
// - A cluster of C = min(8, ceil(P / 256)) CTAs of 256 threads per pair
//   (grid B * C, cluster size set at launch because it depends on P), so
//   a pair's points spread over up to 8 SMs; with P <= 2048 each thread
//   owns one point, up to 4 for P <= 8192 (kMaxPoints; the wrapper refuses
//   more).
// - The association stays on chip for the whole round: each thread keeps
//   its points, plane rows and flags in registers across the inner
//   iterations; nothing of it is written to device memory. The four plane
//   loads of a point are issued together through the read-only path, and
//   only for a point that has depth and projects inside the image. The
//   plane table keeps the pyramid's planar (B,4,H,W) layout.
// - No TMA: a pair's data is a few KB of 4-byte rows and scattered 4-byte
//   gathers, so a bulk tile copy has nothing to copy in bulk.
// - A fixed-order reduction with no atomics: in each warp a reduce-scatter
//   of the 32 (30 used) partials by xor shuffles (31 shuffles; lane k ends
//   with sum k), then the 8 warp sums in warp order, then after
//   cluster.sync() CTA rank 0 sums the C CTA sums in rank order through
//   distributed shared memory. A launch is bit-identical to the next, and
//   a pair's result depends neither on B nor on its place in the batch.
// - The solve and the update run on one thread of rank 0, which writes
//   the new pose into its shared memory; after the next cluster.sync()
//   every CTA copies it.
//
// Rounding: built with -fmad=false, the arithmetic follows the plain torch
// version operation by operation (gnc_mu / x as reciprocal(x) * gnc_mu, as
// torch's __rtruediv__), except the matrix products: torch runs the 3x3
// point transform and the 3x3 / 4x4 products of se3.exp and compose as
// GEMMs with fused multiply-adds, so the kernel chains explicit fmaf in
// the order of a GEMM's inner loop. The systems stay in true f32 (no
// tensor cores: TF32 would bias them by ~5e-4). A point that projects
// within an ulp of a pixel's half-way line can still land on the
// neighbouring pixel, and the LU's rounding differs from LAPACK's by ulps.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kMaxPerThread = 4;
constexpr int kMaxPoints = kMaxCluster * kThreads * kMaxPerThread;  // 8192
constexpr int kSystem = 30;
constexpr int kUpper = 21;

struct Params {
  const float* T;
  const float* pts;
  const uint8_t* src_ok;
  const float* packed;
  int p, h, w, clusters, inner_iters;
  float fx, fy, cx, cy, min_depth, dist_threshold, gnc_mu, damping;
  float* T_out;
  float* rmse;
  float* frac;
  int32_t* count;
};

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
__device__ __forceinline__ void accumulate(float (&acc)[32], float px, float py, float pz,
                                           float nx, float ny, float nz, float d,
                                           float dist_threshold, float gnc_mu) {
  const float r = (nx * px + ny * py) + nz * pz - d;
  if (!(fabsf(r) < dist_threshold)) return;
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

// One step of a warp reduce-scatter by recursive halving: a lane keeps the
// half of its 2S values that its lane bit S selects and adds the partner's
// copy of that half. S is a template argument so that every index is a
// constant and v stays in registers (a loop over S >>= 1 is not unrolled,
// which puts v in local memory).
template <int S>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
  const bool upper = (lane & S) != 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float send = upper ? v[j] : v[j + S];
    const float keep = upper ? v[j + S] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
}

// 16 + 8 + 4 + 2 + 1 = 31 shuffles; lane k returns the warp's sum of
// value k, in a fixed order.
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0];
}

// c = a b for 3x3 row-major, each entry a GEMM's fma chain over k.
__device__ __forceinline__ void matmul3(const float (&a)[9], const float (&b)[9], float (&c)[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      c[3 * i + j] = fmaf(a[3 * i + 2], b[6 + j], fmaf(a[3 * i + 1], b[3 + j], a[3 * i] * b[j]));
    }
  }
}

// The damped solve and the SE(3) update of projective.solve_update for one
// pair, from its 30 sums; pose (4x4, row-major) is updated in place.
// Returns nothing: a failed solve leaves delta = 0, so T is kept.
__device__ void solve_update(const float* sys, float* pose, float damping) {
  float A[6][6];
  float x[6];
  int q = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      A[i][j] = sys[q];
      A[j][i] = sys[q];
      ++q;
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) x[i] = sys[kUpper + i];
  float trace = A[0][0];
#pragma unroll
  for (int i = 1; i < 6; ++i) trace += A[i][i];
  const float lam = damping * trace + 1e-12f;
#pragma unroll
  for (int i = 0; i < 6; ++i) A[i][i] = A[i][i] + lam;

  // LU with partial pivoting, the right-hand side carried along; the row
  // swap is predicated over the candidate rows so A stays in registers.
  bool good = true;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int piv = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (fabsf(A[i][k]) > best) {
        best = fabsf(A[i][k]);
        piv = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (piv == i) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float t = A[k][j];
          A[k][j] = A[i][j];
          A[i][j] = t;
        }
        const float t = x[k];
        x[k] = x[i];
        x[i] = t;
      }
    }
    good = good && A[k][k] != 0.f;
    const float inv = 1.f / A[k][k];
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[i][k] * inv;
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] = A[i][j] - l * A[k][j];
      x[i] = x[i] - l * x[k];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = x[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s = s - A[i][j] * x[j];
    x[i] = s / A[i][i];
  }
  float delta[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    delta[i] = -x[i];
    good = good && isfinite(delta[i]);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) delta[i] = good ? delta[i] : 0.f;

  // se3.exp(delta), twist [v, w].
  const float w0 = delta[3], w1 = delta[4], w2 = delta[5];
  const float theta2 = (w0 * w0 + w1 * w1) + w2 * w2;
  const float W[9] = {0.f, -w2, w1, w2, 0.f, -w0, -w1, w0, 0.f};
  float W2[9];
  matmul3(W, W, W2);
  const bool small = theta2 < 1e-4f;
  const float t2s = small ? 1.f : theta2;
  const float ts = sqrtf(t2s);
  const float sn = sinf(ts);
  const float cs = cosf(ts);
  const float a = small ? 1.f - theta2 / 6.f : sn / ts;
  const float b = small ? 0.5f - theta2 / 24.f : (1.f - cs) / t2s;
  const float c = small ? 1.f / 6.f - theta2 / 120.f : (ts - sn) / (t2s * ts);
  float E[16];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float V[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.f : 0.f;
      V[j] = (eye + b * W[3 * i + j]) + c * W2[3 * i + j];
      E[4 * i + j] = (eye + a * W[3 * i + j]) + b * W2[3 * i + j];
    }
    E[4 * i + 3] = fmaf(V[2], delta[2], fmaf(V[1], delta[1], V[0] * delta[0]));
  }
  E[12] = 0.f;
  E[13] = 0.f;
  E[14] = 0.f;
  E[15] = 1.f;

  // compose(E, T) = E @ T.
  float Tn[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      Tn[4 * i + j] = fmaf(E[4 * i + 3], pose[12 + j],
                           fmaf(E[4 * i + 2], pose[8 + j],
                                fmaf(E[4 * i + 1], pose[4 + j], E[4 * i] * pose[j])));
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) pose[i] = Tn[i];
}

template <int K>
__global__ void __launch_bounds__(kThreads) gn_round_kernel(const Params prm) {
  __shared__ float pose[16];  // the pair's current pose; rank 0's copy leads
  __shared__ float warp_sums[kWarps][32];
  __shared__ float cta_sums[32];
  __shared__ float pair_sums[32];

  cg::cluster_group cluster = cg::this_cluster();
  const int c = prm.clusters;
  const unsigned rank = cluster.block_rank();
  const int64_t pair = blockIdx.x / c;
  const int tid = threadIdx.x;
  const int p = prm.p;

  if (tid < 16) pose[tid] = prm.T[pair * 16 + tid];
  __syncthreads();

  // 1. The association at the round's pose, kept in registers.
  float X[K], Y[K], Z[K], NX[K], NY[K], NZ[K], D[K];
  bool ok[K];
  {
    const Pose T = load_pose(pose);
    const float* pts = prm.pts + pair * 3 * p;
    const uint8_t* sok = prm.src_ok + pair * p;
    const int64_t plane = static_cast<int64_t>(prm.h) * prm.w;
    const float* __restrict__ table = prm.packed + pair * 4 * plane;
    const float u_max = static_cast<float>(prm.w - 1);
    const float v_max = static_cast<float>(prm.h - 1);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = (k * c + static_cast<int>(rank)) * kThreads + tid;
      X[k] = Y[k] = Z[k] = NX[k] = NY[k] = NZ[k] = D[k] = 0.f;
      ok[k] = false;
      if (i < p) {
        X[k] = pts[i];
        Y[k] = pts[p + i];
        Z[k] = pts[2 * p + i];
        float px, py, pz;
        transform(T, X[k], Y[k], Z[k], px, py, pz);
        const float zs = fabsf(pz) > 1e-12f ? pz : 1e-12f;
        const float u = prm.fx * px / zs + prm.cx;
        const float v = prm.fy * py / zs + prm.cy;
        const bool inb = u >= 0.f && u <= u_max && v >= 0.f && v <= v_max && pz > prm.min_depth;
        if (sok[i] != 0 && inb) {
          const int64_t pix = static_cast<int64_t>(pixel_index(v, prm.h)) * prm.w + pixel_index(u, prm.w);
          NX[k] = __ldg(table + pix);
          NY[k] = __ldg(table + plane + pix);
          NZ[k] = __ldg(table + 2 * plane + pix);
          D[k] = __ldg(table + 3 * plane + pix);
          ok[k] = (NX[k] * NX[k] + NY[k] * NY[k]) + NZ[k] * NZ[k] > 0.5f;
        }
      }
    }
  }

  // 2. The inner iterations against the fixed planes.
  for (int it = 0; it < prm.inner_iters; ++it) {
    const bool last = it + 1 == prm.inner_iters;
    float acc[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) acc[q] = 0.f;
    {
      const Pose T = load_pose(pose);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (ok[k]) {
          float px, py, pz;
          transform(T, X[k], Y[k], Z[k], px, py, pz);
          accumulate(acc, px, py, pz, NX[k], NY[k], NZ[k], D[k], prm.dist_threshold, prm.gnc_mu);
        }
      }
    }
    warp_sums[tid >> 5][tid & 31] = warp_reduce_scatter(acc);
    __syncthreads();
    if (tid < kSystem) {
      float s = warp_sums[0][tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s += warp_sums[w][tid];
      cta_sums[tid] = s;
    }
    cluster.sync();  // every CTA's sums are visible to rank 0
    if (rank == 0 && tid < 32) {
      if (tid < kSystem) {
        float part[kMaxCluster];  // all remote loads in flight at once
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r) part[r] = r < c ? *cluster.map_shared_rank(&cta_sums[tid], r) : 0.f;
        float s = part[0];
#pragma unroll
        for (int r = 1; r < kMaxCluster; ++r) {
          if (r < c) s += part[r];
        }
        pair_sums[tid] = s;
      }
      __syncwarp();
      if (tid == 0) {
        if (last) {
          const float wsse = pair_sums[27], wsum = pair_sums[28];
          const int count = static_cast<int>(pair_sums[29]);
          prm.rmse[pair] = sqrtf(wsse / (wsum + 1e-12f));
          prm.frac[pair] = static_cast<float>(count) / static_cast<float>(p);
          prm.count[pair] = count;
        }
        solve_update(pair_sums, pose, prm.damping);
        if (last) {
          for (int i = 0; i < 16; ++i) prm.T_out[pair * 16 + i] = pose[i];
        }
      }
    }
    // Rank 0's new pose is visible to the cluster; on the last iteration
    // this also keeps every CTA's shared memory alive until rank 0 has read it.
    cluster.sync();
    if (!last) {
      if (rank != 0 && tid < 16) pose[tid] = *cluster.map_shared_rank(&pose[tid], 0);
      __syncthreads();
    }
  }
}

template <int K>
cudaError_t launch(const Params& prm, int b, cudaStream_t stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(b) * static_cast<unsigned>(prm.clusters));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(prm.clusters);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, gn_round_kernel<K>, prm);
}

}  // namespace

// One association round for b pairs, launched on `stream` (a cudaStream_t).
// Returns cudaGetLastError() as an int: 0 when the launch was accepted;
// cudaErrorInvalidValue for p outside [0, 8192] or inner_iters < 1.
extern "C" int rst_gn_round(const float* T, const float* pts, const uint8_t* src_ok,
                            const float* packed, int b, int p, int h, int w, float fx, float fy,
                            float cx, float cy, float min_depth, float dist_threshold,
                            float gnc_mu, float damping, int inner_iters, float* T_out,
                            float* rmse, float* frac, int32_t* count, void* stream) {
  if (p < 0 || p > kMaxPoints || inner_iters < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (b > 0) {
    int clusters = (p + kThreads - 1) / kThreads;
    clusters = clusters < 1 ? 1 : (clusters > kMaxCluster ? kMaxCluster : clusters);
    const int per_thread = (p + clusters * kThreads - 1) / (clusters * kThreads);
    const Params prm{T,  pts, src_ok, packed, p,         h,       w,       clusters, inner_iters,
                     fx, fy,  cx,     cy,     min_depth, dist_threshold,   gnc_mu,   damping,
                     T_out, rmse, frac, count};
    const auto s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = per_thread <= 1   ? launch<1>(prm, b, s)
                            : per_thread == 2 ? launch<2>(prm, b, s)
                                              : launch<kMaxPerThread>(prm, b, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rst_gn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
