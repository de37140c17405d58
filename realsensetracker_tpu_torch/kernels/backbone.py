"""The odometry-backbone preconditioner of pose-graph CG, factor and apply.

The port's own kernel: the JAX package computes this chain in plain XLA
(``lax.scan``, realsensetracker_tpu/optimize/pose_graph.py:222-258), which
carried over op for op would cost eager PyTorch ~6 launches per node per
CG iteration. ``backbone_factor`` and ``backbone_apply`` launch the CUDA
kernels of ``csrc/backbone.cu`` (one block per graph, sequential over the
nodes) for CUDA tensors and run their plain versions,
``backbone_factor_reference`` and ``backbone_apply_reference`` -- Python
loops mirroring the three scans -- for CPU tensors. There is no fallback:
a CUDA tensor either goes through the kernel or raises.

Shapes: D (n, 6, 6) per-node diagonal blocks and O (n - 1, 6, 6) the
superdiagonal blocks M[i, i + 1], f32; the factors S_inv (n, 6, 6) and
U (n - 1, 6, 6), f64; r and z (6n,), f32. The chain runs in f64: in f32 (as
JAX computes it) a 1000-node backbone at the LM damping's floor factors
5-13% from the exact solve (csrc/backbone.cu).

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
        lib.rst_backbone_factor.argtypes = [ptr, ptr, ptr, ptr, i32, ptr]
        lib.rst_backbone_factor.restype = i32
        lib.rst_backbone_apply.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, ptr]
        lib.rst_backbone_apply.restype = i32
        lib.rst_backbone_error_string.argtypes = [i32]
        lib.rst_backbone_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


DIAG = float(np.float32(1e-10))  # the f32 constant JAX adds to each S_i


def backbone_factor_reference(D: torch.Tensor, O: torch.Tensor):
    """Plain torch version of the block-LDL^T factor (pose_graph.py:220-230),
    in f64: S_0^-1 = _inv6(D_0); U_{i-1} = S_{i-1}^-1 O_{i-1},
    S_i^-1 = _inv6(D_i - O_{i-1}^T U_{i-1} + 1e-10 I). Returns (S_inv, U)."""
    from realsensetracker_tpu_torch.optimize.pose_graph import _inv6

    D, O = D.double(), O.double()
    eye = DIAG * torch.eye(6, dtype=torch.float64, device=D.device)
    s_inv, us = [_inv6(D[0])], []
    for i in range(1, D.shape[0]):
        u = torch.matmul(s_inv[-1], O[i - 1])
        s_inv.append(_inv6(D[i] - torch.matmul(O[i - 1].T, u) + eye))
        us.append(u)
    U = torch.stack(us) if us else D.new_zeros((0, 6, 6))
    return torch.stack(s_inv), U


def backbone_apply_reference(S_inv: torch.Tensor, U: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the preconditioner apply (pose_graph.py:
    232-258) with CG's guard (:120-122), in f64: L y = r, u = S^-1 y,
    L^T z = u; z rounds to r's dtype, and is r itself if any entry of it is
    non-finite."""
    n = S_inv.shape[0]
    rn = r.reshape(n, 6).to(S_inv.dtype)
    ys = [rn[0]]
    for i in range(1, n):
        ys.append(rn[i] - torch.matmul(U[i - 1].T, ys[-1]))
    u = torch.einsum("nij,nj->ni", S_inv, torch.stack(ys))
    zs = [u[-1]]
    for i in range(n - 2, -1, -1):
        zs.append(u[i] - torch.matmul(U[i], zs[-1]))
    z = torch.stack(zs[::-1]).reshape(-1).to(r.dtype)
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
    """(S_inv (n,6,6), U (n-1,6,6)), f64, of the block-tridiagonal matrix
    with f32 diagonal blocks D and superdiagonal blocks O. CUDA tensors launch the
    kernel on the current stream without synchronizing; CPU tensors run
    backbone_factor_reference."""
    n = D.shape[0] if D.dim() == 3 else -1
    if n < 1:
        raise ValueError(f"D must be (n, 6, 6) with n >= 1, got {tuple(D.shape)}")
    _check("D", D, (n, 6, 6))
    _check("O", O, (n - 1, 6, 6))
    dev = _same_device(D, O)
    if dev.type == "cpu":
        return backbone_factor_reference(D, O)
    s_inv = torch.empty(D.shape, dtype=torch.float64, device=dev)
    U = torch.empty(O.shape, dtype=torch.float64, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.rst_backbone_factor(D.data_ptr(), O.data_ptr(), s_inv.data_ptr(), U.data_ptr(), n,
                                      torch.cuda.current_stream(dev).cuda_stream)
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
    _check("U", U, (n - 1, 6, 6), torch.float64)
    _check("r", r, (6 * n,))
    dev = _same_device(S_inv, U, r)
    if dev.type == "cpu":
        return backbone_apply_reference(S_inv, U, r)
    z = torch.empty_like(r)
    y = torch.empty(12 * n, dtype=torch.float64, device=dev)  # scratch: y, then u
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.rst_backbone_apply(S_inv.data_ptr(), U.data_ptr(), r.data_ptr(), y.data_ptr(), z.data_ptr(), n,
                                     torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "backbone_apply")
    LAUNCHES["backbone_apply"] += 1
    return z
