// Backbone preconditioner of pose-graph CG, hand-written for Hopper (sm_90a).
//
// The JAX package has no Pallas kernel here: optimize_pose_graph
// (realsensetracker_tpu/optimize/pose_graph.py:261-371) is one compiled XLA
// program, and its preconditioner is an exact block-LDL^T factorization of
// the odometry backbone -- a lax.scan over the nodes (factor_step,
// :222-229) -- applied in every CG iteration by two more scans (precond,
// :232-258). This kernel solves the same block-tridiagonal system
// M z = r by block cyclic (odd-even) reduction, which is parallel in the
// nodes (kernels/backbone.py's docstring has the recurrences):
//
// rst_backbone_factor(D (n,6,6) f32, O (n-1,6,6) f32, S_inv (n,6,6),
//   U (n,2,6,6), level scratch (n,2,6,6)): for each level s = 1, 2, 4, ...,
//   the eliminated nodes p invert their block A[p] and form UL[p] =
//   S_inv[p] B[p-s]^T and UR[p] = S_inv[p] B[p] (phase 1), then the kept
//   nodes j form the next level's A[j] and B[j] (phase 2). All f64.
// rst_backbone_apply(S_inv, U, r (6n) f32, scratch (12n) f64, z (6n) f32):
//   the levels up (kept nodes) and down (eliminated nodes), then CG's
//   guard: if any entry of z is non-finite, z = r (pose_graph.py:120-122,
//   safe_precond).
//
// The 6x6 inverse is Gauss-Jordan elimination with partial pivoting (the
// first largest pivot in the column, LU's pivot row) on M / s with
// s = tr(M) / 6 (1 when |s| <= 1e-30), the result divided by s (both
// divisions as products with 1 / s): a zero pivot gives non-finite
// entries, so a singular block still reaches the guard. M is SPD in
// optimize_pose_graph (damping >= 1e-6, node 0 an identity block), and
// then so is every block the reduction inverts.
//
// Bound: latency. At n = 1000 the factor moves ~1.2 MB and does ~3 MFLOP
// of f64, the apply ~0.9 MB and ~0.4 MFLOP: a microsecond of HBM or of f64
// issue. What is left is the dependency chain: log2(n) + 1 levels, each
// two phases behind barriers; a factor phase waits on L2 and, in phase 1,
// on an inversion's six dependent pivot steps (a shuffle and an f64
// divide each), an apply phase on a 6-term sum.
//
// Design. The factor runs on one thread-block cluster of 8 blocks (8 SMs):
// 512 teams of 8 lanes, a team holding one 6x6 block, lane c its column c
// in registers (lanes 6 and 7 shadow column 5 and store nothing). The
// pivot search of column k runs in lane k, and the pivot row and the
// multipliers reach the other lanes by shuffles: no barrier inside an
// inversion, two cluster barriers (release / acquire) per level; the level
// blocks live in device memory (L2: 1.7 MB at n = 1000), read through L2
// (ld.global.cg) since other SMs write them. One block of the old design
// took 8 rounds per phase at n = 1000's first level; the cluster takes 1.
// The apply is one block of 170 teams of 6 lanes, lane c computing entry c
// of its node's 6-vector, with x and the solution in shared memory (in the
// scratch above 2048 nodes) and one barrier per phase; each thread loads
// its next task's blocks as soon as it has computed the current one, so a
// phase's loads are in flight across the barrier before it, and reads the
// down phase's rows as 16-byte words. A cluster does not pay for the apply:
// its barrier costs more than the apply's few rounds per phase save.
//
// Rounding: every product sums k = 0..5 in order from 0 and every update
// is the plain version's expression in its order; built with -fmad=false,
// so the kernel and kernels/backbone.py's plain version agree bit for bit.
// The solve runs in f64 (D, O, r in and z out are f32): in f32, as the JAX
// package computes it, the LDL^T of a 1000-node backbone at the LM
// damping's floor (1e-6) lands 5-13% from the exact solve (the chain's
// condition grows with its length squared), and PCG's result then follows
// those rounding errors.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTeam = 8;  // the factor's lanes per block; lanes 6 and 7 idle
constexpr int kFactorThreads = 512;
constexpr int kClusterBlocks = 8;  // the factor's blocks: one thread-block cluster (the portable maximum)
constexpr int kApplyThreads = 1024;
constexpr int kApplyTeams = kApplyThreads / 6;  // the apply's teams of 6 lanes (threads 1020-1023 idle)
constexpr int kSharedNodes = 2048;  // x and xo in shared memory up to here (2 x 96 KB)
constexpr double kDiag = static_cast<double>(1e-10f);  // JAX's f32 1e-10 * eye6
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double bcast(double v, int src) { return __shfl_sync(kFull, v, src, kTeam); }

// Column c of the level block (f32 input at level 0, f64 scratch after).
struct Blocks {
  const float* D;
  const float* O;
  double* lev;  // (n, 2, 36): A then B of each node at its current level
  int n;

  __device__ __forceinline__ double a(bool level0, int i, int r, int c) const {
    if (!level0) return __ldcg(lev + i * 72 + r * 6 + c);
    double v = static_cast<double>(D[i * 36 + r * 6 + c]);
    if (r == c && i > 0) v = v + kDiag;
    return v;
  }
  // B[i] (the coupling of i to i + s); callers check that it exists.
  __device__ __forceinline__ double b(bool level0, int i, int r, int c) const {
    return level0 ? static_cast<double>(O[i * 36 + r * 6 + c]) : __ldcg(lev + i * 72 + 36 + r * 6 + c);
  }
};

// Gauss-Jordan inverse of the team's block: lane c holds column c of A in
// a and gets column c of inv(A) in x. Every lane of the warp calls it.
__device__ __forceinline__ void inv6(double (&a)[6], double (&x)[6], int c) {
  double d[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) d[k] = bcast(a[k], k);
  double s = (((((d[0] + d[1]) + d[2]) + d[3]) + d[4]) + d[5]) * (1.0 / 6.0);
  s = fabs(s) > 1e-30 ? s : 1.0;
  const double rs = 1.0 / s;
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    a[r] = a[r] * rs;
    x[r] = r == c ? 1.0 : 0.0;
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int piv = k;  // column k's first largest |entry| at or below row k (lane k's search)
    double best = fabs(a[k]);
#pragma unroll
    for (int r = k + 1; r < 6; ++r) {
      const double v = fabs(a[r]);
      if (v > best) {
        best = v;
        piv = r;
      }
    }
    piv = __shfl_sync(kFull, piv, k, kTeam);
#pragma unroll
    for (int r = k + 1; r < 6; ++r) {
      if (r == piv) {
        double t = a[k];
        a[k] = a[r];
        a[r] = t;
        t = x[k];
        x[k] = x[r];
        x[r] = t;
      }
    }
    double col[6];  // column k after the swap: the pivot and the multipliers
#pragma unroll
    for (int r = 0; r < 6; ++r) col[r] = bcast(a[r], k);
    const double inv = 1.0 / col[k];
    a[k] = a[k] * inv;
    x[k] = x[k] * inv;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      if (r != k) {
        a[r] = a[r] - col[r] * a[k];
        x[r] = x[r] - col[r] * x[k];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) x[r] = x[r] * rs;
}

__global__ void __launch_bounds__(kFactorThreads, 1)
backbone_factor_kernel(Blocks bl, double* __restrict__ s_inv, double* U) {
  const int n = bl.n;
  const int lane = threadIdx.x % kTeam;
  const int team = blockIdx.x * (kFactorThreads / kTeam) + threadIdx.x / kTeam;
  constexpr int teams = kClusterBlocks * kFactorThreads / kTeam;
  const cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int c = lane < 6 ? lane : 5;
  const bool owner = lane < 6;

  for (int s = 1; s <= n; s *= 2) {
    const bool level0 = s == 1;
    // Phase 1: the eliminated nodes p = s - 1 + 2 s e.
    const int ne = (n + s) / (2 * s);
    for (int base = 0; base < ne; base += teams) {  // uniform trip count: teams stay converged
      const int e = base + team;
      const bool active = e < ne;
      const int p = active ? s - 1 + 2 * s * e : s - 1;
      const bool left = p - s >= 0, right = p + s < n;
      double a[6], x[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) a[r] = bl.a(level0, p, r, c);
      inv6(a, x, c);
      double bl_row[6], br_col[6];  // B[p-s][c][k] and B[p][k][c]
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        bl_row[k] = left ? bl.b(level0, p - s, c, k) : 0.0;
        br_col[k] = right ? bl.b(level0, p, k, c) : 0.0;
      }
      double ul[6], ur[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) ul[r] = ur[r] = 0.0;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          const double xk = bcast(x[r], k);  // inv[r][k]
          ul[r] = ul[r] + xk * bl_row[k];
          ur[r] = ur[r] + xk * br_col[k];
        }
      }
      if (active && owner) {
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          s_inv[p * 36 + r * 6 + c] = x[r];
          U[p * 72 + r * 6 + c] = left ? ul[r] : 0.0;
          U[p * 72 + 36 + r * 6 + c] = right ? ur[r] : 0.0;
        }
      }
    }
    cluster.sync();  // release and acquire: the other blocks' writes are seen
    // Phase 2: the kept nodes j = 2 s - 1 + 2 s k take the next level's A, B.
    const int nk = n / (2 * s);
    for (int base = 0; base < nk; base += teams) {  // uniform trip count for the warp barrier
      const int q = base + team;
      const bool active = q < nk && owner;
      const int j = 2 * s - 1 + 2 * s * (active ? q : 0);
      const bool right = j + s < n;
      double na[6], nb[6];
      if (active) {
        double t1[6], t2[6];
#pragma unroll
        for (int r = 0; r < 6; ++r) t1[r] = t2[r] = nb[r] = 0.0;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const double urk = __ldcg(U + (j - s) * 72 + 36 + k * 6 + c);  // UR[j-s][k][c]
#pragma unroll
          for (int r = 0; r < 6; ++r) t1[r] = t1[r] + bl.b(level0, j - s, k, r) * urk;
        }
        if (right) {
#pragma unroll
          for (int k = 0; k < 6; ++k) {
            const double ulk = __ldcg(U + (j + s) * 72 + k * 6 + c);       // UL[j+s][k][c]
            const double urk = __ldcg(U + (j + s) * 72 + 36 + k * 6 + c);  // UR[j+s][k][c]
#pragma unroll
            for (int r = 0; r < 6; ++r) {
              const double bjrk = bl.b(level0, j, r, k);
              t2[r] = t2[r] + bjrk * ulk;
              nb[r] = nb[r] + bjrk * urk;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 6; ++r) na[r] = (bl.a(level0, j, r, c) - t1[r]) - (right ? t2[r] : 0.0);
      }
      __syncwarp();  // the team's reads of B[j] before any lane overwrites it
      if (active) {
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          bl.lev[j * 72 + r * 6 + c] = na[r];
          bl.lev[j * 72 + 36 + r * 6 + c] = right ? -nb[r] : 0.0;
        }
      }
    }
    cluster.sync();  // release and acquire: the other blocks' writes are seen
  }
}

// The apply's phases: up, s = 1, 2, ..., top / 2 over the kept nodes; then
// down, s = top, ..., 1 over the eliminated nodes (top: the largest power
// of two <= n).
struct Phases {
  int n, top, up;  // up: the number of up phases, log2(top)

  // log2(s): ph on the way up, 2 up - ph on the way down (shifts, no divides)
  __device__ __forceinline__ int lg(int ph) const { return ph < up ? ph : 2 * up - ph; }
  __device__ __forceinline__ int s(int ph) const { return 1 << lg(ph); }
  __device__ __forceinline__ int count(int ph) const {
    return (ph < up ? n : n + s(ph)) >> (lg(ph) + 1);
  }
  __device__ __forceinline__ int node(int ph, int i) const {
    return (ph < up ? 2 * s(ph) : s(ph)) - 1 + (i << (lg(ph) + 1));
  }
  // The team's next task after (ph, i): the next of its nodes, in this
  // phase or a later one; false past the last phase.
  __device__ __forceinline__ bool next(int team, int& ph, int& i) const {
    i += kApplyTeams;
    while (ph < 2 * up + 1 && i >= count(ph)) {
      ++ph;
      i = team;
    }
    return ph < 2 * up + 1;
  }
};

// Lane c's 18 entries of a task's blocks: up, columns c of UR[j-s] and
// UL[j+s]; down, rows c of S_inv[p], UL[p] and UR[p] (0 where the
// neighbour does not exist).
__device__ __forceinline__ void load_task(const Phases& P, int ph, int i, int c, const double* __restrict__ s_inv,
                                          const double* __restrict__ U, double (&m)[18]) {
  const int s = P.s(ph), v = P.node(ph, i);
  const bool left = v - s >= 0, right = v + s < P.n;
  if (ph < P.up) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      m[k] = U[(v - s) * 72 + 36 + k * 6 + c];
      m[6 + k] = right ? U[(v + s) * 72 + k * 6 + c] : 0.0;
      m[12 + k] = 0.0;
    }
    return;
  }
  // A row is 48 contiguous, 16-byte aligned bytes: three 16-byte loads.
  const double2* rows[3] = {reinterpret_cast<const double2*>(s_inv + v * 36 + c * 6),
                            reinterpret_cast<const double2*>(U + v * 72 + c * 6),
                            reinterpret_cast<const double2*>(U + v * 72 + 36 + c * 6)};
  const bool have[3] = {true, left, right};
#pragma unroll
  for (int b = 0; b < 3; ++b) {
#pragma unroll
    for (int h = 0; h < 3; ++h) {
      const double2 d = have[b] ? rows[b][h] : make_double2(0.0, 0.0);
      m[6 * b + 2 * h] = d.x;
      m[6 * b + 2 * h + 1] = d.y;
    }
  }
}

// x holds the right-hand side as the up phases reduce it; xo each node's
// solution, written by the down phase that eliminates it. Each thread
// loads its next task's blocks as soon as it has computed the current one,
// so the loads of a phase's first task are in flight across the barrier
// before it.
__global__ void __launch_bounds__(kApplyThreads, 1)
backbone_apply_kernel(const double* __restrict__ s_inv, const double* __restrict__ U,
                      const float* __restrict__ rhs, double* scratch, float* __restrict__ z, int n, bool shared) {
  extern __shared__ double smem[];
  double* const x = shared ? smem : scratch;
  double* const xo = x + 6 * n;
  const int team = threadIdx.x / 6;
  const int c = threadIdx.x % 6;
  int top = 1, up = 0;
  while (2 * top <= n) {
    top *= 2;
    ++up;
  }
  const Phases P{n, top, up};

  int ph = 0, i = team - kApplyTeams;
  bool have = team < kApplyTeams && P.next(team, ph, i);
  double m[18];
  if (have) load_task(P, ph, i, c, s_inv, U, m);
  for (int e = threadIdx.x; e < 6 * n; e += blockDim.x) x[e] = static_cast<double>(rhs[e]);
  __syncthreads();
  for (int cur_ph = 0; cur_ph < 2 * up + 1; ++cur_ph) {
    while (have && ph == cur_ph) {
      const int v = P.node(ph, i), s = P.s(ph);
      const bool right = v + s < n;
      double t1 = 0.0, t2 = 0.0;
      if (cur_ph < up) {  // x[j] <- (x[j] - UR[j-s]^T x[j-s]) - UL[j+s]^T x[j+s]
#pragma unroll
        for (int k = 0; k < 6; ++k) t1 = t1 + m[k] * x[(v - s) * 6 + k];
        if (right) {
#pragma unroll
          for (int k = 0; k < 6; ++k) t2 = t2 + m[6 + k] * x[(v + s) * 6 + k];
        }
        x[v * 6 + c] = (x[v * 6 + c] - t1) - t2;
      } else {  // xo[p] <- (S_inv[p] x[p] - UL[p] xo[p-s]) - UR[p] xo[p+s]
        double w = 0.0;
#pragma unroll
        for (int k = 0; k < 6; ++k) w = w + m[k] * x[v * 6 + k];
        if (v - s >= 0) {
#pragma unroll
          for (int k = 0; k < 6; ++k) t1 = t1 + m[6 + k] * xo[(v - s) * 6 + k];
        }
        if (right) {
#pragma unroll
          for (int k = 0; k < 6; ++k) t2 = t2 + m[12 + k] * xo[(v + s) * 6 + k];
        }
        xo[v * 6 + c] = (w - t1) - t2;
      }
      have = P.next(team, ph, i);
      if (have) load_task(P, ph, i, c, s_inv, U, m);  // across the barrier when it is the next phase's
    }
    __syncthreads();
  }
  int bad = 0;  // the CG guard: any non-finite entry sends r through unchanged
  for (int e = threadIdx.x; e < 6 * n; e += blockDim.x) bad |= !isfinite(static_cast<float>(xo[e]));
  const bool send_r = __syncthreads_or(bad);
  for (int e = threadIdx.x; e < 6 * n; e += blockDim.x) z[e] = send_r ? rhs[e] : static_cast<float>(xo[e]);
}

}  // namespace

extern "C" int rst_backbone_factor(const float* D, const float* O, double* s_inv, double* U, double* level, int n,
                                   void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Blocks bl{D, O, level, n};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClusterBlocks);
  cfg.blockDim = dim3(kFactorThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterBlocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, backbone_factor_kernel, bl, s_inv, U);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int rst_backbone_apply(const double* s_inv, const double* U, const float* rhs, double* scratch, float* z,
                                  int n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  static bool sized = false;  // the attribute is per function and process; setting it twice is harmless
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(backbone_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(12 * kSharedNodes * sizeof(double)));
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const bool shared = n <= kSharedNodes;
  const size_t smem = shared ? static_cast<size_t>(12 * n) * sizeof(double) : 0;
  backbone_apply_kernel<<<1, kApplyThreads, smem, static_cast<cudaStream_t>(stream)>>>(s_inv, U, rhs, scratch, z, n,
                                                                                       shared);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rst_backbone_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
