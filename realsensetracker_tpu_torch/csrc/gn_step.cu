// Projective point-to-plane Gauss-Newton on Hopper (sm_90a), two entries
// that share their device code:
//   gn_round  -- one association round: associate, then inner_iters x
//                (reduce, damped 6x6 solve, SE(3) update); writes poses;
//   gn_system -- one association and one reduction at the pose T; writes
//                the 6x6 system itself (H, b, wsse, wsum, count), for
//                callers that add their own terms before the solve (the
//                joint RGB-D step of align/rgbd.py adds the photometric
//                block, the point-sharded registration of
//                parallel/sharded.py an all-reduce over its point ranks).
//                With T_assoc it associates at T_assoc and reduces at T:
//                the inner step of a round whose planes were fixed at the
//                round's pose (realsensetracker_tpu/parallel/sharded.py:154-168).
//
// The TPU never had this kernel: its Pallas version stopped at Mosaic
// lowering blockers, kept as minimal reproducers in
// tools/tpu/mosaic_probe5.py -- the dynamic gathers lane_gather_w256 (:53),
// lane_gather_w640 (:66) and sublane_gather (:79) (the plane-table load)
// and reshape_cross_lane (:91) (the layout of the reduction). JAX runs both
// as plain XLA (realsensetracker_tpu/align/projective.py: _step =
// associate_planes_t, then inner_iters x (normal_equations_fixed_t ->
// solve_update); build_normal_equations = associate_planes_t ->
// normal_equations_fixed_t). Here the gather is an ordinary load and the
// reduction a fixed-order tree across a thread-block cluster.
//
// What one gn_round launch does, for each of B pairs:
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
// gn_system stops after the first reduction of step 2 (at T itself, the
// association at T_assoc where given) and writes the 30 sums as H (B,6,6,
// the upper triangle mirrored), b (B,6), wsse, wsum (B,) and count (B,)
// int32.
//
// Bound: latency and launches, not the card. A pair reads 13 bytes per
// point, 16 more per valid point's plane row, and 64 bytes of pose, and
// does ~100 f32 operations per matched point per inner iteration: a
// 512-pair round at 2048 points must move ~30 MB, ~9 us at 3.35 TB/s
// (the planar table makes each row four 32-byte sectors, ~4x that in
// sector traffic). What the round costs instead is the chain of dependent
// loads (point -> pixel -> plane row), the barriers and the serial 6x6
// solve, and on the host the launches: torch's association, reduction,
// solve and SE(3) update take ~100 launches per inner iteration, a round
// here one.
//
// Design:
// - A cluster of C = min(8, ceil(P / 256)) CTAs of 256 threads per pair
//   (grid B * C, cluster size set at launch because it depends on P), so
//   a pair's points spread over up to 8 SMs; thread t of CTA rank r owns
//   points (k C + r) 256 + t, k = 0, 1, ...
// - gn_round with P <= 8192 (kRegisterPoints: up to 4 points a thread)
//   keeps the association on chip for the whole round: each thread holds
//   its points, plane rows and flags in registers across the inner
//   iterations. Above 8192 points it streams: the association writes each
//   point's row [n | d] (zero where the point has no depth or projects
//   outside) to a scratch buffer of P float4 per pair that the wrapper
//   allocates, and each inner iteration re-reads the points and their rows
//   (the flag is |n|^2 > 0.5 of the stored row, as it was at the
//   association). A thread reads only rows it wrote itself, in the same
//   order as the register path, so no barrier guards the buffer.
//   gn_system needs the association once, so it streams every point
//   through registers, with no buffer, for any P.
// - The four plane loads of a point are issued together through the
//   read-only path, and only for a point that has depth and projects
//   inside the image. The plane table keeps the pyramid's planar
//   (B,4,H,W) layout.
// - No TMA: a pair's data is a few KB of 4-byte rows and scattered 4-byte
//   gathers, so a bulk tile copy has nothing to copy in bulk.
// - A fixed-order reduction with no atomics (reduce_pair): in each warp a
//   reduce-scatter of the 32 (30 used) partials by xor shuffles (31
//   shuffles; lane k ends with sum k), then the 8 warp sums in warp order,
//   then after cluster.sync() CTA rank 0 sums the C CTA sums in rank order
//   through distributed shared memory. A launch is bit-identical to the
//   next, and a pair's result depends neither on B nor on its place in the
//   batch.
// - gn_round's solve and update run on one thread of rank 0, which writes
//   the new pose into its shared memory; after the next cluster.sync()
//   every CTA copies it. gn_system's rank 0 writes the system out.
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
constexpr int kRegisterPoints = kMaxCluster * kThreads * kMaxPerThread;  // 8192
constexpr int kSystem = 30;
constexpr int kUpper = 21;

struct Params {
  const float* T;
  const float* T_assoc;  // gn_system: the association pose (null: T)
  const float* pts;
  const uint8_t* src_ok;
  const float* packed;
  int p, h, w, clusters, inner_iters;
  float fx, fy, cx, cy, min_depth, dist_threshold, gnc_mu, damping;
  float4* scratch;  // gn_round above kRegisterPoints: P rows per pair
  float* T_out;     // gn_round
  float* rmse;
  float* frac;
  float* H;         // gn_system
  float* bvec;
  float* wsse;
  float* wsum;
  int32_t* count;   // both
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

// Point i of a pair at the pose T: its coordinates x, y, z and the plane
// row [n | d] it projects onto (zero unless it is flagged and lands inside
// the image in front of min_depth). Returns whether it is associated:
// flagged, in bounds and |n|^2 > 0.5.
__device__ __forceinline__ bool associate(const Params& prm, int64_t pair, const Pose& T, int i,
                                          float& x, float& y, float& z, float& nx, float& ny,
                                          float& nz, float& d) {
  const int p = prm.p;
  const float* pts = prm.pts + pair * 3 * p;
  x = pts[i];
  y = pts[p + i];
  z = pts[2 * p + i];
  nx = ny = nz = d = 0.f;
  float px, py, pz;
  transform(T, x, y, z, px, py, pz);
  const float zs = fabsf(pz) > 1e-12f ? pz : 1e-12f;
  const float u = prm.fx * px / zs + prm.cx;
  const float v = prm.fy * py / zs + prm.cy;
  const bool inb = u >= 0.f && u <= static_cast<float>(prm.w - 1) && v >= 0.f &&
                   v <= static_cast<float>(prm.h - 1) && pz > prm.min_depth;
  if (prm.src_ok[pair * p + i] == 0 || !inb) return false;
  const int64_t plane = static_cast<int64_t>(prm.h) * prm.w;
  const float* __restrict__ table = prm.packed + pair * 4 * plane;
  const int64_t pix = static_cast<int64_t>(pixel_index(v, prm.h)) * prm.w + pixel_index(u, prm.w);
  nx = __ldg(table + pix);
  ny = __ldg(table + plane + pix);
  nz = __ldg(table + 2 * plane + pix);
  d = __ldg(table + 3 * plane + pix);
  return (nx * nx + ny * ny) + nz * nz > 0.5f;
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

// The pair's sums of acc over its cluster of c CTAs, in a fixed order: each
// warp by a reduce-scatter, the 8 warp sums in warp order, then on CTA
// rank 0 the c CTA sums in rank order through distributed shared memory.
// On return pair_sums[0..29] of rank 0 hold them, visible to its warp 0.
// Rank 0 reads the other CTAs' cta_sums: the caller must cluster.sync()
// again before any CTA exits or writes cta_sums anew.
__device__ __forceinline__ void reduce_pair(float (&acc)[32], float (&warp_sums)[kWarps][32],
                                            float (&cta_sums)[32], float (&pair_sums)[32],
                                            cg::cluster_group& cluster, int c, unsigned rank) {
  const int tid = threadIdx.x;
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
  }
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

// K points a thread held in registers, or K = 0: any number, streamed
// through prm.scratch.
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
  const int first = static_cast<int>(rank) * kThreads + tid;
  const int stride = c * kThreads;
  float4* rows = K > 0 ? nullptr : prm.scratch + pair * p;

  if (tid < 16) pose[tid] = prm.T[pair * 16 + tid];
  __syncthreads();

  // 1. The association at the round's pose: in registers (K > 0) or in
  // this thread's rows of the scratch buffer (K = 0).
  constexpr int R = K > 0 ? K : 1;
  float X[R], Y[R], Z[R], NX[R], NY[R], NZ[R], D[R];
  bool ok[R];
  {
    const Pose T = load_pose(pose);
    if constexpr (K > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = first + k * stride;
        X[k] = Y[k] = Z[k] = NX[k] = NY[k] = NZ[k] = D[k] = 0.f;
        ok[k] = i < p && associate(prm, pair, T, i, X[k], Y[k], Z[k], NX[k], NY[k], NZ[k], D[k]);
      }
    } else {
      for (int i = first; i < p; i += stride) {
        associate(prm, pair, T, i, X[0], Y[0], Z[0], NX[0], NY[0], NZ[0], D[0]);
        rows[i] = make_float4(NX[0], NY[0], NZ[0], D[0]);
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
      float px, py, pz;
      if constexpr (K > 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (ok[k]) {
            transform(T, X[k], Y[k], Z[k], px, py, pz);
            accumulate(acc, px, py, pz, NX[k], NY[k], NZ[k], D[k], prm.dist_threshold, prm.gnc_mu);
          }
        }
      } else {
        const float* pts = prm.pts + pair * 3 * p;
        for (int i = first; i < p; i += stride) {
          const float4 r = rows[i];
          if ((r.x * r.x + r.y * r.y) + r.z * r.z > 0.5f) {
            transform(T, pts[i], pts[p + i], pts[2 * p + i], px, py, pz);
            accumulate(acc, px, py, pz, r.x, r.y, r.z, r.w, prm.dist_threshold, prm.gnc_mu);
          }
        }
      }
    }
    reduce_pair(acc, warp_sums, cta_sums, pair_sums, cluster, c, rank);
    if (rank == 0 && tid == 0) {
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
    // Rank 0's new pose is visible to the cluster; on the last iteration
    // this also keeps every CTA's shared memory alive until rank 0 has read it.
    cluster.sync();
    if (!last) {
      if (rank != 0 && tid < 16) pose[tid] = *cluster.map_shared_rank(&pose[tid], 0);
      __syncthreads();
    }
  }
}

// Index of H[i][j], i <= j, among the 21 upper-triangle sums (row-major).
__device__ __forceinline__ int upper_index(int i, int j) { return i * 6 - i * (i - 1) / 2 + (j - i); }

// One association and one reduction at T per pair: the 6x6 system out.
__global__ void __launch_bounds__(kThreads) gn_system_kernel(const Params prm) {
  __shared__ float warp_sums[kWarps][32];
  __shared__ float cta_sums[32];
  __shared__ float pair_sums[32];

  cg::cluster_group cluster = cg::this_cluster();
  const int c = prm.clusters;
  const unsigned rank = cluster.block_rank();
  const int64_t pair = blockIdx.x / c;
  const int tid = threadIdx.x;

  float acc[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) acc[q] = 0.f;
  {
    const Pose T = load_pose(prm.T + pair * 16);
    const Pose A = prm.T_assoc == nullptr ? T : load_pose(prm.T_assoc + pair * 16);
    for (int i = static_cast<int>(rank) * kThreads + tid; i < prm.p; i += c * kThreads) {
      float x, y, z, nx, ny, nz, d, px, py, pz;
      if (associate(prm, pair, A, i, x, y, z, nx, ny, nz, d)) {
        transform(T, x, y, z, px, py, pz);
        accumulate(acc, px, py, pz, nx, ny, nz, d, prm.dist_threshold, prm.gnc_mu);
      }
    }
  }
  reduce_pair(acc, warp_sums, cta_sums, pair_sums, cluster, c, rank);
  if (rank == 0 && tid < 32) {
    for (int e = tid; e < 36; e += 32) {
      const int i = e / 6, j = e % 6;
      prm.H[pair * 36 + e] = pair_sums[i <= j ? upper_index(i, j) : upper_index(j, i)];
    }
    if (tid < 6) prm.bvec[pair * 6 + tid] = pair_sums[kUpper + tid];
    if (tid == 0) {
      prm.wsse[pair] = pair_sums[27];
      prm.wsum[pair] = pair_sums[28];
      prm.count[pair] = static_cast<int>(pair_sums[29]);
    }
  }
  cluster.sync();  // keep every CTA's cta_sums alive until rank 0 has read them
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& prm, int b, cudaStream_t stream) {
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
  return cudaLaunchKernelEx(&config, kernel, prm);
}

// CTAs per pair: one per 256 points, 1 to 8.
int cluster_size(int p) {
  const int c = (p + kThreads - 1) / kThreads;
  return c < 1 ? 1 : (c > kMaxCluster ? kMaxCluster : c);
}

}  // namespace

// One association round for b pairs, launched on `stream` (a cudaStream_t).
// scratch: b * p float4 (16-byte aligned) when p > 8192, else unused (may be
// null). Returns cudaGetLastError() as an int: 0 when the launch was
// accepted; cudaErrorInvalidValue for p < 0, inner_iters < 1, or p > 8192
// without scratch.
extern "C" int rst_gn_round(const float* T, const float* pts, const uint8_t* src_ok,
                            const float* packed, int b, int p, int h, int w, float fx, float fy,
                            float cx, float cy, float min_depth, float dist_threshold,
                            float gnc_mu, float damping, int inner_iters, float* T_out,
                            float* rmse, float* frac, int32_t* count, float* scratch,
                            void* stream) {
  const bool streamed = p > kRegisterPoints;
  if (p < 0 || inner_iters < 1 || (streamed && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b > 0) {
    Params prm = {};
    prm.T = T, prm.pts = pts, prm.src_ok = src_ok, prm.packed = packed;
    prm.p = p, prm.h = h, prm.w = w, prm.clusters = cluster_size(p), prm.inner_iters = inner_iters;
    prm.fx = fx, prm.fy = fy, prm.cx = cx, prm.cy = cy, prm.min_depth = min_depth;
    prm.dist_threshold = dist_threshold, prm.gnc_mu = gnc_mu, prm.damping = damping;
    prm.scratch = reinterpret_cast<float4*>(scratch);
    prm.T_out = T_out, prm.rmse = rmse, prm.frac = frac, prm.count = count;
    const int per_thread = (p + prm.clusters * kThreads - 1) / (prm.clusters * kThreads);
    const auto s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = streamed          ? launch(gn_round_kernel<0>, prm, b, s)
                            : per_thread <= 1 ? launch(gn_round_kernel<1>, prm, b, s)
                            : per_thread == 2 ? launch(gn_round_kernel<2>, prm, b, s)
                                              : launch(gn_round_kernel<kMaxPerThread>, prm, b, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The 6x6 Gauss-Newton systems of b pairs at the poses T (one association
// at T_assoc, or at T where T_assoc is null; one reduction at T), launched
// on `stream`: H (b,6,6), bvec (b,6), wsse, wsum (b,) f32 and count (b,)
// int32. Returns cudaGetLastError() as an int; cudaErrorInvalidValue for
// p < 0.
extern "C" int rst_gn_system(const float* T, const float* T_assoc, const float* pts, const uint8_t* src_ok,
                             const float* packed, int b, int p, int h, int w, float fx, float fy,
                             float cx, float cy, float min_depth, float dist_threshold,
                             float gnc_mu, float* H, float* bvec, float* wsse, float* wsum,
                             int32_t* count, void* stream) {
  if (p < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (b > 0) {
    Params prm = {};
    prm.T = T, prm.T_assoc = T_assoc, prm.pts = pts, prm.src_ok = src_ok, prm.packed = packed;
    prm.p = p, prm.h = h, prm.w = w, prm.clusters = cluster_size(p), prm.inner_iters = 1;
    prm.fx = fx, prm.fy = fy, prm.cx = cx, prm.cy = cy, prm.min_depth = min_depth;
    prm.dist_threshold = dist_threshold, prm.gnc_mu = gnc_mu;
    prm.H = H, prm.bvec = bvec, prm.wsse = wsse, prm.wsum = wsum, prm.count = count;
    const cudaError_t err = launch(gn_system_kernel, prm, b, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rst_gn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
