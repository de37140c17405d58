"""The odometry-backbone preconditioner of pose-graph CG, factor and apply.

The port's own kernel: the JAX package computes this solve in plain XLA
as a block-LDL^T chain (``lax.scan``,
realsensetracker_tpu/optimize/pose_graph.py:222-258), which carried over
op for op would cost eager PyTorch ~6 launches per node per CG iteration.
Here the same block-tridiagonal system is solved by block cyclic
(odd-even) reduction, which is parallel in the nodes: log2(n) + 1 levels,
each a batch of independent 6x6 inversions and products.
``backbone_factor`` and ``backbone_apply`` launch the CUDA kernels of
``csrc/backbone.cu`` (the factor on one thread-block cluster of 8 blocks,
the apply on one block; each runs all levels inside one launch) for CUDA
tensors and run their plain versions,
``backbone_factor_reference`` and ``backbone_apply_reference`` -- the same
levels, batched over each level's nodes -- for CPU tensors. There is no
fallback: a CUDA tensor either goes through the kernel or raises.

The reduction. Level l (s = 2^l) holds the nodes i with (i + 1) % s == 0;
those with (i + 1) / s odd are eliminated there, the rest kept for level
l + 1, so node i is eliminated at the level of the trailing ones of i.
A[i] is node i's diagonal block at its level and B[i] its coupling to
node i + s (M[i, i + s]); level 0 takes A = D + 1e-10 I (nodes >= 1, the
f32 constant JAX adds to each S_i) and B = O. An eliminated node p stores

  S_inv[p] = inv6(A[p]), UL[p] = S_inv[p] B[p - s]^T, UR[p] = S_inv[p] B[p]

(zero where the neighbour does not exist), and a kept node j takes

  A[j] <- (A[j] - B[j - s]^T UR[j - s]) - B[j] UL[j + s],
  B[j] <- -(B[j] UR[j + s]).

The apply runs the levels up, x[j] <- (x[j] - UR[j - s]^T x[j - s]) -
UL[j + s]^T x[j + s] on the kept nodes, then down, x[p] <- (S_inv[p] x[p] -
UL[p] x[p - s]) - UR[p] x[p + s] on the eliminated ones; z is x in f32, or
r itself when any entry of z is non-finite (CG's guard). inv6 is Gauss-
Jordan elimination with partial pivoting (the first largest pivot, the
row of LU's getrf) on M / s, s = tr(M) / 6 (1 when |s| <= 1e-30), the
result divided by s (both as products with 1/s; tr(M) / 6 as tr(M) * (1 /
6), as torch computes a tensor over a number on the card): a singular
block gives non-finite entries, and the
apply then returns r. M is SPD in optimize_pose_graph (the damping is at
least 1e-6 and node 0 is an identity block), so every block the reduction
inverts is SPD too.

Every product sums k = 0..5 in order from 0, and the kernel (built with
-fmad=false) does each operation of its plain version in the same order,
so the two agree bit for bit.

Shapes: D (n, 6, 6) per-node diagonal blocks and O (n - 1, 6, 6) the
superdiagonal blocks M[i, i + 1], f32; the factors S_inv (n, 6, 6) and
U (n, 2, 6, 6) (UL, UR), f64; r and z (6n,), f32. The solve runs in f64: in
f32 (as JAX computes it) a 1000-node backbone at the LM damping's floor
solves 5-13% from the exact solution (csrc/backbone.cu).

``LAUNCHES`` counts kernel launches per entry (never reference runs).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from realsensetracker_tpu_torch.kernels import build

SOURCE = "backbone.cu"
LAUNCHES = {"backbone_factor": 0, "backbone_apply": 0}

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rst_backbone_factor.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, ptr]
        lib.rst_backbone_factor.restype = i32
        lib.rst_backbone_apply.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, ptr]
        lib.rst_backbone_apply.restype = i32
        lib.rst_backbone_error_string.argtypes = [i32]
        lib.rst_backbone_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


DIAG = float(np.float32(1e-10))  # the f32 constant JAX adds to each S_i


def levels(n: int, device=None) -> list[tuple[int, torch.Tensor, torch.Tensor]]:
    """(s, eliminated nodes, kept nodes) of each level of the reduction."""
    out, s = [], 1
    while s <= n:
        out.append((s, torch.arange(s - 1, n, 2 * s, device=device),
                    torch.arange(2 * s - 1, max(n, 2 * s - 1), 2 * s, device=device)))
        s *= 2
    return out


def _mm(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Batched 6x6 X @ Y, summed k = 0..5 in order from 0."""
    acc = torch.zeros(X.shape, dtype=X.dtype, device=X.device)
    for k in range(6):
        acc = acc + X[:, :, k : k + 1] * Y[:, k : k + 1, :]
    return acc


def _mv(M: torch.Tensor, v: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """Batched M @ v (or M^T @ v), summed k = 0..5 in order from 0."""
    acc = torch.zeros(v.shape, dtype=v.dtype, device=v.device)
    for k in range(6):
        acc = acc + (M[:, k, :] if transpose else M[:, :, k]) * v[:, k : k + 1]
    return acc


def gj_inv6(M: torch.Tensor) -> torch.Tensor:
    """inv(M / s) / s, s = tr(M) / 6, of a batch (m, 6, 6) of f64 blocks (the
    divisions as products with 1/6 and 1/s):
    Gauss-Jordan with partial pivoting, the kernel's operations in its
    order (non-finite for a singular block)."""
    m = M.shape[0]
    s = (((((M[:, 0, 0] + M[:, 1, 1]) + M[:, 2, 2]) + M[:, 3, 3]) + M[:, 4, 4]) + M[:, 5, 5]) * (1.0 / 6.0)
    rs = (1.0 / torch.where(s.abs() > 1e-30, s, 1.0))[:, None, None]
    a = M * rs
    x = torch.eye(6, dtype=M.dtype, device=M.device).expand(m, 6, 6).clone()
    rows = torch.arange(m, device=M.device)
    for k in range(6):
        best = a[:, k, k].abs()
        piv = torch.full((m,), k, dtype=torch.long, device=M.device)
        for r in range(k + 1, 6):
            v = a[:, r, k].abs()
            take = v > best  # the first largest: NaN never wins
            best = torch.where(take, v, best)
            piv = torch.where(take, r, piv)
        for t in (a, x):
            row_k, row_p = t[:, k].clone(), t[rows, piv]
            t[:, k] = row_p
            t[rows, piv] = row_k
        col = a[:, :, k].clone()  # column k: the pivot and the multipliers
        inv = (1.0 / col[:, k])[:, None]
        a[:, k] = a[:, k] * inv
        x[:, k] = x[:, k] * inv
        for r in range(6):
            if r != k:
                a[:, r] = a[:, r] - col[:, r : r + 1] * a[:, k]
                x[:, r] = x[:, r] - col[:, r : r + 1] * x[:, k]
    return x * rs


def backbone_factor_reference(D: torch.Tensor, O: torch.Tensor):
    """Plain torch version of the factor: block cyclic reduction in f64,
    level by level (module docstring). Returns (S_inv (n, 6, 6), U (n, 2,
    6, 6))."""
    n = D.shape[0]
    A = D.double().clone()
    A[1:, range(6), range(6)] += DIAG
    B = torch.zeros_like(A)
    B[: n - 1] = O.double()
    S_inv, U = torch.zeros_like(A), A.new_zeros((n, 2, 6, 6))
    for s, p, j in levels(n, D.device):
        X = gj_inv6(A[p])
        S_inv[p] = X
        left, right = (p - s >= 0)[:, None, None], (p + s < n)[:, None, None]
        U[p, 0] = torch.where(left, _mm(X, B[(p - s).clamp(min=0)].transpose(1, 2)), 0.0)
        U[p, 1] = torch.where(right, _mm(X, B[p]), 0.0)
        if len(j):
            right = (j + s < n)[:, None, None]
            jr = torch.where(j + s < n, j + s, j - s)  # any index where there is no right neighbour
            t1 = _mm(B[j - s].transpose(1, 2), U[j - s, 1])
            t2 = torch.where(right, _mm(B[j], U[jr, 0]), 0.0)
            A[j] = (A[j] - t1) - t2
            B[j] = torch.where(right, -_mm(B[j], U[jr, 1]), 0.0)
    return S_inv, U


def backbone_apply_reference(S_inv: torch.Tensor, U: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the apply with CG's guard (pose_graph.py:
    120-122), in f64: the reduction's levels up and down (module
    docstring); z rounds to r's dtype, and is r itself if any entry of it
    is non-finite."""
    n = S_inv.shape[0]
    x = r.reshape(n, 6).to(S_inv.dtype).clone()
    lv = levels(n, S_inv.device)
    for s, _, j in lv:
        if len(j):
            right = (j + s < n)[:, None]
            jr = torch.where(j + s < n, j + s, j - s)
            t1 = _mv(U[j - s, 1], x[j - s], transpose=True)
            t2 = torch.where(right, _mv(U[jr, 0], x[jr], transpose=True), 0.0)
            x[j] = (x[j] - t1) - t2
    for s, p, _ in reversed(lv):
        left, right = (p - s >= 0)[:, None], (p + s < n)[:, None]
        pl, pr = (p - s).clamp(min=0), torch.where(p + s < n, p + s, p)
        w = _mv(S_inv[p], x[p])
        t1 = torch.where(left, _mv(U[p, 0], x[pl]), 0.0)
        t2 = torch.where(right, _mv(U[p, 1], x[pr]), 0.0)
        x[p] = (w - t1) - t2
    z = x.reshape(-1).to(r.dtype)
    return torch.where(torch.isfinite(z).all(), z, r)


def _check(name: str, t: torch.Tensor, shape: tuple, dtype=torch.float32) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _same_device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"tensors on several devices: {[str(t.device) for t in ts]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {_library().rst_backbone_error_string(err).decode()} ({err})")


def backbone_factor(D: torch.Tensor, O: torch.Tensor):
    """(S_inv (n,6,6), U (n,2,6,6)), f64: the cyclic reduction of the
    block-tridiagonal matrix with f32 diagonal blocks D and superdiagonal
    blocks O. CUDA tensors launch the kernel on the current stream without
    synchronizing; CPU tensors run backbone_factor_reference."""
    n = D.shape[0] if D.dim() == 3 else -1
    if n < 1:
        raise ValueError(f"D must be (n, 6, 6) with n >= 1, got {tuple(D.shape)}")
    _check("D", D, (n, 6, 6))
    _check("O", O, (n - 1, 6, 6))
    dev = _same_device(D, O)
    if dev.type == "cpu":
        return backbone_factor_reference(D, O)
    s_inv = torch.empty(D.shape, dtype=torch.float64, device=dev)
    U = torch.empty((n, 2, 6, 6), dtype=torch.float64, device=dev)
    level = torch.empty((n, 2, 6, 6), dtype=torch.float64, device=dev)  # scratch: each node's A and B
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.rst_backbone_factor(D.data_ptr(), O.data_ptr(), s_inv.data_ptr(), U.data_ptr(), level.data_ptr(),
                                      n, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "backbone_factor")
    LAUNCHES["backbone_factor"] += 1
    return s_inv, U


def backbone_apply(S_inv: torch.Tensor, U: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """z = M^-1 r for the factored backbone M, or r itself when any entry
    of z is non-finite. CUDA tensors launch the kernel on the current stream
    without synchronizing; CPU tensors run backbone_apply_reference."""
    n = S_inv.shape[0] if S_inv.dim() == 3 else -1
    if n < 1:
        raise ValueError(f"S_inv must be (n, 6, 6) with n >= 1, got {tuple(S_inv.shape)}")
    _check("S_inv", S_inv, (n, 6, 6), torch.float64)
    _check("U", U, (n, 2, 6, 6), torch.float64)
    _check("r", r, (6 * n,))
    dev = _same_device(S_inv, U, r)
    if dev.type == "cpu":
        return backbone_apply_reference(S_inv, U, r)
    z = torch.empty_like(r)
    x = torch.empty(12 * n, dtype=torch.float64, device=dev)  # scratch (x, xo) where they outgrow shared memory
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.rst_backbone_apply(S_inv.data_ptr(), U.data_ptr(), r.data_ptr(), x.data_ptr(), z.data_ptr(), n,
                                     torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "backbone_apply")
    LAUNCHES["backbone_apply"] += 1
    return z
