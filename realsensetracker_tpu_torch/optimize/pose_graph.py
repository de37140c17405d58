"""Pose-graph optimization: nonlinear least squares over SE(3) trajectories.

Port of realsensetracker_tpu/optimize/pose_graph.py. Given node poses and
relative-pose edge measurements (odometry + loop closures) it minimizes

    sum_e || w_e * log( T_meas_e^-1 * T_i^-1 * T_j ) ||^2

by Gauss-Newton (staged Huber -> Geman-McClure IRLS, a per-node trust
region, Levenberg-Marquardt accept/reject) with the normal equations
solved by conjugate gradients, preconditioned by an exact solve of the
odometry backbone (JAX: block-LDL^T; the port: block cyclic reduction,
kernels/backbone.py). Node 0 is gauge-fixed.

Where JAX forms Hv by jax.jvp + jax.vjp through the residuals, the port
builds the same linear operator from the per-edge 6x12 Jacobians the
preconditioner needs anyway (one vmapped jacfwd per GN iteration): Hv is a
gather of (v_i, v_j), two batched products and one scatter-add, plus the
damping. The backbone factor and apply are the port's own CUDA kernel
(kernels/backbone.py) on the card and their plain torch versions on the
CPU. Every
decision -- the preconditioner's finiteness guard, the step's, the LM
accept/reject -- is a torch.where on the device: one optimize_pose_graph
call copies nothing to the host until its result is read.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from realsensetracker_tpu_torch import device as device_mod
from realsensetracker_tpu_torch.geometry import se3
from realsensetracker_tpu_torch.kernels import backbone


class PoseGraph(NamedTuple):
    poses: torch.Tensor  # (N, 4, 4) world_from_node estimates
    edges_i: torch.Tensor  # (E,) int64 source node
    edges_j: torch.Tensor  # (E,) int64 target node
    measurements: torch.Tensor  # (E, 4, 4) measured T_i^-1 T_j
    weights: torch.Tensor  # (E,) scalar edge weights


def _f32(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def from_trajectory(poses, loop_edges=(), odometry=None, odometry_weights=None, device=None) -> PoseGraph:
    """Build a graph with consecutive odometry edges + optional loop edges.

    loop_edges: iterable of (i, j, T_ij (4,4), weight). odometry: optional
    explicit consecutive-edge measurements (n-1 of (4,4), T_i^-1 T_j as
    MEASURED at tracking time); without it they are re-extracted from
    ``poses`` -- fine for a one-shot solve, wrong for repeated online
    optimization, which must pass the measurements it recorded.
    odometry_weights: per-edge confidence of the odometry edges.
    device: where the graph lives; by default the device of ``poses`` when
    it is a tensor, else the card.
    """
    if device is None:
        device = poses.device if isinstance(poses, torch.Tensor) else device_mod.DEFAULT
    device = device_mod.resolve(device)
    poses = _f32(poses, device)
    n = poses.shape[0]
    if n < 2:
        raise ValueError(f"a pose graph needs >= 2 poses, got {n}")
    ei = list(range(n - 1))
    ej = list(range(1, n))
    if odometry is None:
        meas = list(se3.compose(se3.inverse(poses[:-1]), poses[1:]))
    else:
        meas = [_f32(T, device) for T in odometry]
        if len(meas) != n - 1:
            raise ValueError(f"odometry must have {n - 1} edges, got {len(meas)}")
    if odometry_weights is None:
        w = [1.0] * (n - 1)
    else:
        w = [float(x) for x in odometry_weights]
        if len(w) != n - 1:
            raise ValueError(f"odometry_weights must have {n - 1} entries, got {len(w)}")
    for (i, j, T_ij, weight) in loop_edges:
        if not (0 <= i < n and 0 <= j < n):
            # An out-of-range index would gather another node (or fault on
            # the card): fail loudly, as the JAX package does.
            raise ValueError(f"loop edge ({i}, {j}) out of range for {n} nodes")
        ei.append(int(i))
        ej.append(int(j))
        meas.append(_f32(T_ij, device))
        w.append(float(weight))
    return PoseGraph(
        poses=poses,
        edges_i=torch.tensor(ei, dtype=torch.int64, device=device),
        edges_j=torch.tensor(ej, dtype=torch.int64, device=device),
        measurements=torch.stack(meas),
        weights=torch.tensor(w, dtype=torch.float32, device=device),
    )


def _gauge(twists: torch.Tensor) -> torch.Tensor:
    """Node 0's twist set to zero (no assignment into a CUDA view)."""
    return torch.cat([torch.zeros_like(twists[:1]), twists[1:]])


def _edge_residuals(twists: torch.Tensor, graph: PoseGraph) -> torch.Tensor:
    """Stacked weighted residuals (E, 6) at correction ``twists`` (N, 6):
    node poses are exp(twist_n) @ pose_n, node 0's twist zeroed."""
    T = se3.compose(se3.exp(_gauge(twists)), graph.poses)
    Ti = T[graph.edges_i]
    Tj = T[graph.edges_j]
    pred = se3.compose(se3.inverse(Ti), Tj)
    err = se3.compose(se3.inverse(graph.measurements), pred)
    return se3.log(err) * graph.weights[:, None]


def _edge_r(tw12, pose_i, pose_j, meas, w):
    """One edge's weighted residual (6,) at endpoint twists tw12 (12,).
    The twists keep a leading dim of 1: under jacfwd, torch.where of a 0-d
    tensor and a Python float turns float64 (se3.exp's Taylor branches)."""
    Ti = se3.compose(se3.exp(tw12[None, :6]), pose_i)
    Tj = se3.compose(se3.exp(tw12[None, 6:]), pose_j)
    pred = se3.compose(se3.inverse(Ti), Tj)
    err = se3.compose(se3.inverse(meas), pred)
    return se3.log(err)[0] * w


def edge_jacobians(graph: PoseGraph, poses: torch.Tensor, w_total: torch.Tensor) -> torch.Tensor:
    """Per-edge Jacobians (E, 6, 12) of the residuals weighted by w_total
    with respect to the two endpoint twists at zero, the columns of a
    node-0 endpoint zeroed (the gauge fix): J = [J_i | J_j]."""
    e = graph.edges_i.shape[0]
    zero = torch.zeros((e, 12), dtype=torch.float32, device=poses.device)
    J = torch.func.vmap(torch.func.jacfwd(_edge_r))(
        zero, poses[graph.edges_i], poses[graph.edges_j], graph.measurements, w_total
    )
    keep = torch.stack([graph.edges_i != 0, graph.edges_j != 0], dim=-1).repeat_interleave(6, dim=-1)
    return J * keep[:, None, :].to(J.dtype)


def _endpoints(graph: PoseGraph) -> torch.Tensor:
    """(E, 2) node indices (i, j) of every edge."""
    return torch.stack([graph.edges_i, graph.edges_j], dim=-1)


def _scatter_nodes(per_edge: torch.Tensor, pairs: torch.Tensor, n: int) -> torch.Tensor:
    """Sum per-edge endpoint vectors (E, 12) into their nodes: (6n,).
    A self-edge (i == j) sums both halves into its one node."""
    out = torch.zeros((n, 6), dtype=per_edge.dtype, device=per_edge.device)
    return out.index_add_(0, pairs.reshape(-1), per_edge.reshape(-1, 6)).reshape(-1)


def hessian_matvec(J: torch.Tensor, graph: PoseGraph, n: int, damping):
    """v (6n,) -> J^T J v + damping v for the stacked edge Jacobians J
    (E, 6, 12) of edge_jacobians: the Gauss-Newton operator of the JAX
    package's jvp/vjp matvec (pose_graph.py:327-330), node 0's columns
    zero."""
    Jt = J.transpose(1, 2).contiguous()
    pairs = _endpoints(graph)

    def matvec(v: torch.Tensor) -> torch.Tensor:
        v12 = v.reshape(n, 6)[pairs].reshape(-1, 12, 1)
        jv = torch.bmm(J, v12)
        return _scatter_nodes(torch.bmm(Jt, jv)[..., 0], pairs, n) + damping * v

    return matvec


def gradient(J: torch.Tensor, graph: PoseGraph, r0: torch.Tensor, n: int) -> torch.Tensor:
    """J^T r0 (6n,) for the stacked residuals r0 (6E,)."""
    return _scatter_nodes(torch.bmm(J.transpose(1, 2), r0.reshape(-1, 6, 1))[..., 0], _endpoints(graph), n)


def _cg(matvec, b, iters: int, eps: float = 1e-12, precond=None):
    """(Preconditioned) conjugate gradients for SPD systems, fixed count.

    precond: optional M^-1 apply, guarded (it returns its input where its
    output would be non-finite). Without it this is plain CG (z = r)."""
    if precond is None:
        precond = lambda r: r  # noqa: E731
    x = torch.zeros_like(b)
    r = b
    z = precond(b)
    p = z
    rz = torch.dot(b, z)
    for _ in range(iters):
        Ap = matvec(p)
        alpha = rz / torch.clamp(torch.dot(p, Ap), min=eps)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / torch.clamp(rz, min=eps)
        p = z + beta * p
        rz = rz_new
    return x


def backbone_blocks(graph: PoseGraph, J: torch.Tensor, n: int, damping):
    """The block-tridiagonal backbone (pose_graph.py:174-213) from the
    stacked edge Jacobians J (E, 6, 12): diagonal blocks D (n, 6, 6) --
    every edge's J_i^T J_i and J_j^T J_j, + (damping + 1e-8) I, node 0 an
    identity block -- and superdiagonal blocks O (n - 1, 6, 6), the J_i^T
    J_j of CHAIN edges (j == i + 1, i > 0); loop edges are left to CG."""
    dev = J.device
    Ji, Jj = J[:, :, :6], J[:, :, 6:]
    Bi = torch.bmm(Ji.transpose(1, 2), Ji)
    Bj = torch.bmm(Jj.transpose(1, 2), Jj)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    D = torch.zeros((n, 6, 6), dtype=torch.float32, device=dev)
    D = D.index_add_(0, graph.edges_i, Bi).index_add_(0, graph.edges_j, Bj) + (damping + 1e-8) * eye6
    D = torch.cat([eye6[None], D[1:]])
    is_chain = (graph.edges_j == graph.edges_i + 1) & (graph.edges_i > 0)
    Bij = torch.bmm(Ji.transpose(1, 2), Jj)
    O = torch.zeros((n - 1, 6, 6), dtype=torch.float32, device=dev).index_add_(
        0, torch.where(is_chain, graph.edges_i, 0), torch.where(is_chain[:, None, None], Bij, 0.0)
    )
    return D.contiguous(), O.contiguous()


def _block_tridiag_precond(graph: PoseGraph, J: torch.Tensor, n: int, damping):
    """The odometry-backbone preconditioner (pose_graph.py:155-258): the
    backbone_blocks factored exactly (kernels/backbone.py), so each apply
    solves the whole chain and CG only fixes up the loop edges. Node 0
    keeps an identity block with no couplings, matching the matvec's
    zeroed row and column."""
    if n < 2:
        return None
    S_inv, U = backbone.backbone_factor(*backbone_blocks(graph, J, n, damping))
    return lambda r: backbone.backbone_apply(S_inv, U, r.contiguous())


def robust_weights(r_edges: torch.Tensor, huber_delta: float, use_gm: bool) -> torch.Tensor:
    """sqrt of the IRLS weight per edge (E,): Huber's min(1, delta/|r|), or
    Geman-McClure's (delta^2 / (|r|^2 + delta^2))^2 in the second half of
    the schedule; ones when huber_delta is 0. Python numerators divide as
    tensors (torch turns c / x into reciprocal(x) * c)."""
    if huber_delta <= 0:
        return torch.ones(r_edges.shape[0], dtype=torch.float32, device=r_edges.device)
    rn = torch.linalg.vector_norm(r_edges, dim=-1)
    if use_gm:
        d2 = torch.full_like(rn, float(np.float32(huber_delta * huber_delta)))
        w = (d2 / (rn * rn + d2)) ** 2
    else:
        w = torch.clamp(torch.full_like(rn, huber_delta) / torch.clamp(rn, min=1e-12), max=1.0)
    return torch.sqrt(w)


def optimize_pose_graph(
    graph: PoseGraph,
    gn_iters: int = 10,
    cg_iters: int = 50,
    damping: float = 1e-6,
    huber_delta: float = 0.1,
    precondition: bool = True,
    trust_radius: float = 2.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Optimize node poses; returns (poses (N, 4, 4), final cost) on the
    graph's device.

    Each iteration linearizes all edges, takes IRLS weights from the
    current residuals (Huber for the first half of the iterations,
    Geman-McClure after), and solves the damped normal equations by
    cg_iters of CG, preconditioned by default by the backbone
    factorization. The step is clipped to trust_radius per node, then
    accepted only if it is finite and does not raise the robustified cost
    (damping / 2, at least ``damping``) or rejected (damping x 10, at most
    1e4). The final cost is the unrobustified one at the returned poses.
    """
    n = graph.poses.shape[0]
    dev = graph.poses.device
    zero = torch.zeros((n, 6), dtype=torch.float32, device=dev)
    poses = graph.poses
    lm = torch.full((), damping, dtype=torch.float32, device=dev)
    for it in range(gn_iters):
        g = graph._replace(poses=poses)
        r_edges = _edge_residuals(zero, g)  # (E, 6), already edge-weighted
        w_rob = robust_weights(r_edges, huber_delta, it >= gn_iters // 2)
        r0 = (r_edges * w_rob[:, None]).reshape(-1)
        J = edge_jacobians(graph, poses, graph.weights * w_rob)
        precond = _block_tridiag_precond(graph, J, n, lm) if precondition else None
        dx = _cg(hessian_matvec(J, graph, n, lm), -gradient(J, graph, r0, n), cg_iters, precond=precond)
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        tw = _gauge(dx.reshape(n, 6))
        # Trust region: a single ill-conditioned linearization (log's
        # Jacobian ~ 1/sin(theta) near pi) can emit a huge, useless step.
        step_norm = torch.linalg.vector_norm(tw, dim=-1, keepdim=True)
        tw = tw * torch.clamp(torch.full_like(step_norm, trust_radius) / torch.clamp(step_norm, min=1e-12), max=1.0)
        new_poses = se3.compose(se3.exp(tw), poses)
        cost = 0.5 * torch.sum(r0 * r0)
        r_new = _edge_residuals(zero, g._replace(poses=new_poses)) * w_rob[:, None]
        new_cost = 0.5 * torch.sum(r_new * r_new)
        accept = torch.isfinite(new_cost) & torch.isfinite(new_poses).all() & (new_cost <= cost)
        poses = torch.where(accept, new_poses, poses)
        lm = torch.where(accept, torch.clamp(lm * 0.5, min=damping), torch.clamp(lm * 10.0, max=1e4))
    final_r = _edge_residuals(zero, graph._replace(poses=poses))
    return poses, 0.5 * torch.sum(final_r * final_r)
