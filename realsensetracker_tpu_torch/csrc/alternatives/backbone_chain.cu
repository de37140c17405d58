// THE PREVIOUS DESIGN, kept only so that chip_smoke.py can time it in turns
// with csrc/backbone.cu (block cyclic reduction), which replaced it. No
// path of the port launches it. Its original notes follow.
//
// Backbone preconditioner of pose-graph CG, hand-written for Hopper (sm_90a).
//
// The JAX package has no Pallas kernel here: optimize_pose_graph
// (realsensetracker_tpu/optimize/pose_graph.py:261-371) is one compiled XLA
// program, and its preconditioner is an exact block-LDL^T factorization of
// the odometry backbone -- a lax.scan over the nodes (factor_step,
// :222-229) -- applied in every CG iteration by two more scans (precond,
// :232-258). Eager PyTorch would pay ~6 small launches per node per CG
// iteration for the same chain; here each is one launch of one block.
//
// rst_backbone_factor(D (n,6,6), O (n-1,6,6)) -> S_inv (n,6,6), U (n-1,6,6):
//   S_0^-1 = inv6(D_0); for i >= 1: U_{i-1} = S_{i-1}^-1 O_{i-1},
//   S_i = D_i - O_{i-1}^T U_{i-1} + 1e-10 I (the f32 constant), S_i^-1 = inv6(S_i),
// where inv6(M) = inv(M / s) / s with s = tr(M) / 6 (1 when |s| <= 1e-30),
// the inverse by LU with partial pivoting as LAPACK's getrf + getrs take
// it: the first largest pivot, a column left unscaled behind a zero pivot,
// and column-oriented triangular solves that skip zero entries -- so a
// singular block gives non-finite entries where JAX's (and
// torch.linalg.inv_ex's) do.
//
// rst_backbone_apply(S_inv, U, r (6n)) -> z (6n): L y = r forward
// (y_i = r_i - U_{i-1}^T y_{i-1}), u_i = S_i^-1 y_i, then L^T z = u backward
// (z_i = u_i - U_i z_{i+1}), and last the CG guard: if any entry of z is
// non-finite, z = r (pose_graph.py:120-122, safe_precond).
//
// Bound: latency. The factor reads 288 B and writes 576 B per node and does
// ~1.5k flops; the apply moves ~600 B per node. Both are chains of n
// dependent 6x6 steps (2n for the apply), each a few hundred cycles of
// shared-memory arithmetic and barriers, so neither bytes nor flops bound
// them on this card. Design: one block per graph, sequential over the
// nodes. The factor spreads each 6x6 product over 36 threads and the LU's
// row updates over the trailing entries; the next node's D and O load into
// registers while the current node is factored. The apply runs each chain
// in one warp, lane c holding entry c of the current 6-vector and
// broadcasting it with shuffles (no block barriers inside a chain), with
// the next U block prefetched into registers; the middle products and the
// guard use the whole block. S_inv and U stream from device memory (at
// n = 1000 they are 288 KB, beyond one block's shared memory).
//
// Precision: the chain runs in f64 (S_inv, U and the apply's y stored as
// f64; D, O, r in and z out are f32). In f32, as the JAX package computes
// it, the LDL^T of a 1000-node backbone at the LM damping's floor (1e-6)
// lands 5-13% from the exact solve (the chain's condition grows with its
// length squared), and PCG's result then follows those rounding errors.
// f64 costs the factor 1.2x and the apply 1.8x their f32 time (PERF.md
// section 6), a small share of a CG iteration on the host's clock. Built
// with -fmad=false (kernels/build.py); sums run k = 0..5 in order. Against
// the plain torch loop (kernels/backbone.py, also f64) the results agree
// to f64 rounding, not bit for bit (LAPACK orders its sums its own way).

#include <cuda_runtime.h>

namespace {

constexpr int kFactorThreads = 64;  // 36 matrix entries per step, two warps
constexpr int kApplyThreads = 256;
constexpr double kDiag = static_cast<double>(1e-10f);  // JAX's f32 1e-10 * eye6

// inv6 of the 6x6 row-major block `a` (shared, destroyed) into `out`
// (shared). Every thread of the block calls it; it ends on a barrier.
__device__ void inv6(double* a, double* out, int* perm, double* scale, int tid) {
  if (tid == 0) {
    const double s = (((((a[0] + a[7]) + a[14]) + a[21]) + a[28]) + a[35]) / 6.0;
    *scale = fabs(s) > 1e-30 ? s : 1.0;
  }
  __syncthreads();
  if (tid < 36) a[tid] = a[tid] / *scale;
  if (tid < 6) perm[tid] = tid;
  __syncthreads();
  // getrf: column k's first largest |pivot| at or below the diagonal.
  for (int k = 0; k < 6; ++k) {
    if (tid == 0) {
      int p = k;
      double best = fabs(a[k * 6 + k]);
      for (int r = k + 1; r < 6; ++r) {
        const double v = fabs(a[r * 6 + k]);
        if (v > best) {
          best = v;
          p = r;
        }
      }
      if (p != k) {
        for (int c = 0; c < 6; ++c) {
          const double t = a[k * 6 + c];
          a[k * 6 + c] = a[p * 6 + c];
          a[p * 6 + c] = t;
        }
        const int t = perm[k];
        perm[k] = perm[p];
        perm[p] = t;
      }
    }
    __syncthreads();
    const double pivot = a[k * 6 + k];
    if (pivot != 0.0 && tid > k && tid < 6) {
      a[tid * 6 + k] = a[tid * 6 + k] * (1.0 / pivot);
    }
    __syncthreads();
    if (tid < 36) {
      const int r = tid / 6, c = tid % 6;
      if (r > k && c > k) a[tid] = a[tid] - a[r * 6 + k] * a[k * 6 + c];
    }
    __syncthreads();
  }
  // getrs on the identity: column j of P^T solved through L, then U.
  if (tid < 6) {
    const int j = tid;
    double x[6];
    for (int r = 0; r < 6; ++r) x[r] = perm[r] == j ? 1.0 : 0.0;
    for (int k = 0; k < 6; ++k) {  // unit lower, forward
      if (x[k] != 0.0) {
        for (int r = k + 1; r < 6; ++r) x[r] = x[r] - x[k] * a[r * 6 + k];
      }
    }
    for (int k = 5; k >= 0; --k) {  // upper, backward
      if (x[k] != 0.0) {
        x[k] = x[k] / a[k * 6 + k];
        for (int r = 0; r < k; ++r) x[r] = x[r] - x[k] * a[r * 6 + k];
      }
    }
    for (int r = 0; r < 6; ++r) out[r * 6 + j] = x[r] / *scale;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kFactorThreads)
backbone_factor_kernel(const float* __restrict__ D, const float* __restrict__ O,
                       double* __restrict__ s_inv, double* __restrict__ U, int n) {
  __shared__ double prev[36];  // S_{i-1}^-1
  __shared__ double o[36];     // O_{i-1}
  __shared__ double u[36];     // U_{i-1}
  __shared__ double a[36];     // S_i, then its LU
  __shared__ int perm[6];
  __shared__ double scale;
  const int tid = threadIdx.x;
  const bool entry = tid < 36;
  const int r = tid / 6, c = tid % 6;

  if (entry) a[tid] = D[tid];
  __syncthreads();
  inv6(a, prev, perm, &scale, tid);
  if (entry) s_inv[tid] = prev[tid];
  float d_next = 0.0f, o_next = 0.0f;  // f32 in, f64 from here on
  if (entry && n > 1) {
    d_next = D[36 + tid];
    o_next = O[tid];
  }
  for (int i = 1; i < n; ++i) {
    const double d_cur = d_next;
    if (entry) o[tid] = o_next;
    if (entry && i + 1 < n) {  // the next node's blocks, in flight during this one
      d_next = D[(i + 1) * 36 + tid];
      o_next = O[i * 36 + tid];
    }
    __syncthreads();
    if (entry) {  // U_{i-1} = S_{i-1}^-1 O_{i-1}
      double acc = 0.0;
      for (int k = 0; k < 6; ++k) acc = acc + prev[r * 6 + k] * o[k * 6 + c];
      u[tid] = acc;
      U[(i - 1) * 36 + tid] = acc;
    }
    __syncthreads();
    if (entry) {  // S_i = D_i - O_{i-1}^T U_{i-1} + 1e-10 I
      double acc = 0.0;
      for (int k = 0; k < 6; ++k) acc = acc + o[k * 6 + r] * u[k * 6 + c];
      a[tid] = (d_cur - acc) + (r == c ? kDiag : 0.0);
    }
    __syncthreads();
    inv6(a, prev, perm, &scale, tid);
    if (entry) s_inv[i * 36 + tid] = prev[tid];
  }
}

// The apply's scratch holds 12n doubles: y, then u.
__device__ __forceinline__ double* u_scratch(double* y, int n) { return y + 6 * n; }

__global__ void __launch_bounds__(kApplyThreads)
backbone_apply_kernel(const double* __restrict__ s_inv, const double* __restrict__ U,
                      const float* __restrict__ rhs, double* __restrict__ y, float* __restrict__ z, int n) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int c = lane < 6 ? lane : 0;  // lanes 6..31 shadow lane 0 and write nothing
  const unsigned full = 0xffffffffu;

  if (tid < 32) {  // forward: y_0 = r_0, y_i = r_i - U_{i-1}^T y_{i-1}
    double yc = rhs[c];
    if (lane < 6) y[c] = yc;
    double col[6], next[6];  // column c of U_{i-1}
    if (n > 1) {
      for (int k = 0; k < 6; ++k) next[k] = U[k * 6 + c];
    }
    for (int i = 1; i < n; ++i) {
      for (int k = 0; k < 6; ++k) col[k] = next[k];
      if (i + 1 < n) {
        for (int k = 0; k < 6; ++k) next[k] = U[i * 36 + k * 6 + c];
      }
      const double rc = rhs[i * 6 + c];
      double acc = 0.0;
      for (int k = 0; k < 6; ++k) acc = acc + col[k] * __shfl_sync(full, yc, k);
      yc = rc - acc;
      if (lane < 6) y[i * 6 + c] = yc;
    }
  }
  __syncthreads();
  for (int e = tid; e < 6 * n; e += blockDim.x) {  // u_i = S_i^-1 y_i, into the scratch's second half
    const int i = e / 6, row = e % 6;
    double acc = 0.0;
    for (int k = 0; k < 6; ++k) acc = acc + s_inv[i * 36 + row * 6 + k] * y[i * 6 + k];
    u_scratch(y, n)[e] = acc;
  }
  __syncthreads();
  if (tid < 32) {  // backward: z_{n-1} = u_{n-1}, z_i = u_i - U_i z_{i+1}
    const double* uu = u_scratch(y, n);
    double zc = uu[(n - 1) * 6 + c];
    if (lane < 6) z[(n - 1) * 6 + c] = static_cast<float>(zc);
    double row[6], next[6];  // row c of U_i
    if (n > 1) {
      for (int k = 0; k < 6; ++k) next[k] = U[(n - 2) * 36 + c * 6 + k];
    }
    for (int i = n - 2; i >= 0; --i) {
      for (int k = 0; k < 6; ++k) row[k] = next[k];
      if (i > 0) {
        for (int k = 0; k < 6; ++k) next[k] = U[(i - 1) * 36 + c * 6 + k];
      }
      const double uc = uu[i * 6 + c];
      double acc = 0.0;
      for (int k = 0; k < 6; ++k) acc = acc + row[k] * __shfl_sync(full, zc, k);
      zc = uc - acc;
      if (lane < 6) z[i * 6 + c] = static_cast<float>(zc);
    }
  }
  __syncthreads();
  int bad = 0;  // the CG guard: any non-finite entry sends r through unchanged
  for (int e = tid; e < 6 * n; e += blockDim.x) bad |= !isfinite(z[e]);
  if (__syncthreads_or(bad)) {
    for (int e = tid; e < 6 * n; e += blockDim.x) z[e] = rhs[e];
  }
}

}  // namespace

extern "C" int rst_backbone_factor(const float* D, const float* O, double* s_inv, double* U, int n,
                                   void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  backbone_factor_kernel<<<1, kFactorThreads, 0, static_cast<cudaStream_t>(stream)>>>(D, O, s_inv, U, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rst_backbone_apply(const double* s_inv, const double* U, const float* rhs, double* y, float* z,
                                  int n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  backbone_apply_kernel<<<1, kApplyThreads, 0, static_cast<cudaStream_t>(stream)>>>(s_inv, U, rhs, y, z, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rst_backbone_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
