"""Parity of the port's pose-graph optimization with the JAX package.

The graphs: tests/test_posegraph_loops.py's 12-node noisy loop (drift
0.03, one loop edge of weight 4) and a 200-node two-lap graph built as its
1000-node one (data.synthetic.lap_graph, numpy seed 3, a loop edge every
10 nodes). Operator-level parity is tight: residuals 1e-5, the
explicit-Jacobian Hv against JAX's jvp/vjp Hv within 1e-5 of |Hv|, the
backbone preconditioner's apply within 1e-5 relative (residuals: 1e-5 +
1e-4 relative, poses 5 m out). optimize_pose_graph
is held to 1e-4 (poses) and 1e-4 relative (cost) over the GN iterations
that carry the cost down. Past them the parting is recorded, not hidden:
unpreconditioned 60-step CG on an ill-conditioned graph, and LM steps at
the cost's rounding floor, depend on the last ulp, and JAX parts from
itself when its input moves by one ulp (ROADMAP section 3). The 1000-node
case runs on the card only (chip_smoke.py phase pose_graph).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realsensetracker_tpu.optimize import pose_graph as jpg
from realsensetracker_tpu_torch.data import synthetic
from realsensetracker_tpu_torch.geometry import se3
from realsensetracker_tpu_torch.kernels import backbone
from realsensetracker_tpu_torch.optimize import pose_graph as pg
from tests.torch_parity import j32

CPU = "cpu"


def _noisy_loop(n=12, drift=0.02, seed=0):
    """tests/test_posegraph_loops.py:14-35: ground truth round a circle and
    drifted odometry estimates (the port's se3.exp, f32 numpy)."""
    rng = np.random.RandomState(seed)
    step = se3.exp(torch.tensor([0.5, 0, 0, 0, 0, 2 * np.pi / (n - 1)], dtype=torch.float32)).numpy()
    gt, est = [np.eye(4, dtype=np.float32)], [np.eye(4, dtype=np.float32)]
    for _ in range(n - 1):
        gt.append((gt[-1] @ step).astype(np.float32))
        noise = se3.exp(torch.tensor(drift * rng.randn(6), dtype=torch.float32)).numpy()
        est.append((est[-1] @ step @ noise).astype(np.float32))
    return np.stack(gt), np.stack(est)


def _loop12():
    gt, est = _noisy_loop(drift=0.03)
    return gt, est, [(0, 11, (np.linalg.inv(gt[0]) @ gt[-1]).astype(np.float32), 4.0)]


def _graph200():
    return synthetic.lap_graph(2, 100, seed=3, loop_every=10)


GRAPHS = {"loop12": _loop12, "graph200": _graph200}


def _both(est, loops, **kw):
    """(JAX graph, port graph) of the same numpy inputs."""
    jg = jpg.from_trajectory(j32(est), loop_edges=[(i, j, j32(T), w) for i, j, T, w in loops], **kw)
    return jg, pg.from_trajectory(est, loop_edges=loops, device=CPU, **kw)


@pytest.fixture(scope="module", params=list(GRAPHS))
def graph(request):
    gt, est, loops = GRAPHS[request.param]()
    return request.param, gt, est, loops, *_both(est, loops)


# --- graph construction -------------------------------------------------------


@pytest.mark.parametrize("explicit", [False, True], ids=["from_poses", "explicit_odometry"])
def test_from_trajectory_matches_jax(explicit):
    gt, est, loops = _loop12()
    kw = {}
    if explicit:
        kw = dict(odometry=[(np.linalg.inv(est[i]) @ est[i + 1]).astype(np.float32) for i in range(11)],
                  odometry_weights=[1.0] * 5 + [0.25] + [1.0] * 5)
    jg, g = _both(est, loops, **kw)
    np.testing.assert_array_equal(g.edges_i.numpy(), np.asarray(jg.edges_i))
    np.testing.assert_array_equal(g.edges_j.numpy(), np.asarray(jg.edges_j))
    np.testing.assert_array_equal(g.weights.numpy(), np.asarray(jg.weights))
    np.testing.assert_allclose(g.measurements.numpy(), np.asarray(jg.measurements), atol=1e-6)


@pytest.mark.parametrize("case", ["one_pose", "loop_out_of_range", "odometry_count", "weight_count"])
def test_from_trajectory_raises_as_jax(case):
    est = np.stack([np.eye(4, dtype=np.float32)] * 4)
    kw, match = {
        "one_pose": ({"poses": est[:1]}, ">= 2 poses"),
        "loop_out_of_range": ({"loop_edges": [(0, 4, np.eye(4), 1.0)]}, "out of range"),
        "odometry_count": ({"odometry": [np.eye(4)] * 2}, "odometry must have 3"),
        "weight_count": ({"odometry_weights": [1.0] * 4}, "odometry_weights must have 3"),
    }[case]
    args = {"poses": est, **kw}
    with pytest.raises(ValueError, match=match):
        pg.from_trajectory(device=CPU, **args)
    jargs = {k: (j32(v) if k == "poses" else v) for k, v in args.items()}
    with pytest.raises(ValueError, match=match):
        jpg.from_trajectory(**jargs)


# --- the linearization ----------------------------------------------------------


def _jax_linearization(jg, n, huber_delta=0.1):
    """JAX's residuals, Huber IRLS weights, and its jvp/vjp Hv and J^T r0
    at zero (pose_graph.py:301-332)."""
    zero = jnp.zeros((n, 6), jnp.float32)
    r_edges = jpg._edge_residuals(zero, jg)
    rn = jnp.linalg.norm(r_edges, axis=-1)
    w_rob = jnp.sqrt(jnp.minimum(1.0, huber_delta / jnp.maximum(rn, 1e-12)))

    def res_flat(tw):
        return (jpg._edge_residuals(tw.reshape(n, 6), jg) * w_rob[:, None]).reshape(-1)

    r0 = res_flat(zero.reshape(-1))
    _, vjp = jax.vjp(res_flat, zero.reshape(-1))

    def hv(v):
        _, jv = jax.jvp(res_flat, (zero.reshape(-1),), (v,))
        return vjp(jv)[0]

    return r_edges, w_rob, r0, hv, vjp(r0)[0]


def test_edge_residuals_match_jax(graph):
    _, _, est, _, jg, g = graph
    n = est.shape[0]
    tw = (0.05 * np.random.RandomState(4).randn(n, 6)).astype(np.float32)
    got = pg._edge_residuals(torch.from_numpy(tw), g).numpy()
    np.testing.assert_allclose(got, np.asarray(jpg._edge_residuals(j32(tw), jg)), rtol=1e-4, atol=1e-5)


def test_hessian_matvec_and_gradient_match_jax(graph):
    """The explicit-Jacobian operator (gather, two batched products, one
    scatter-add) against JAX's jvp + vjp on random v, within 1e-5 of |Hv|;
    the gradient J^T r0 likewise; damping adds lm v."""
    _, _, est, _, jg, g = graph
    n = est.shape[0]
    r_edges, w_rob, r0, hv, grad = _jax_linearization(jg, n)
    w_port = pg.robust_weights(pg._edge_residuals(torch.zeros((n, 6)), g), 0.1, use_gm=False)
    np.testing.assert_allclose(w_port.numpy(), np.asarray(w_rob), rtol=1e-5)
    J = pg.edge_jacobians(g, g.poses, g.weights * torch.from_numpy(np.asarray(w_rob)))
    v = np.random.RandomState(1).randn(6 * n).astype(np.float32)
    ref = np.asarray(hv(j32(v)))
    got = pg.hessian_matvec(J, g, n, 0.0)(torch.from_numpy(v)).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.linalg.norm(ref)
    damped = pg.hessian_matvec(J, g, n, 0.5)(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(damped, got + 0.5 * v, rtol=1e-6, atol=1e-6)
    g_ref = np.asarray(grad)
    g_got = pg.gradient(J, g, torch.from_numpy(np.asarray(r0)), n).numpy()
    assert np.abs(g_got - g_ref).max() <= 1e-5 * np.linalg.norm(g_ref)
    assert not g_got[:6].any() and not got[:6].any()  # the gauge: node 0's row


def test_backbone_preconditioner_matches_jax(graph):
    """The plain factor + apply (the kernel's plain version) against JAX's
    _block_tridiag_precond on random r. At lm = 1e-3 the 200-node backbone
    is ill-conditioned, and f32 leaves either side ~1e-4 from the exact
    solve: the port is held within 1e-4 of JAX's |z| and, against the same
    chain solved in f64, within twice JAX's own error (+1e-6)."""
    _, _, est, _, jg, g = graph
    n = est.shape[0]
    _, w_rob, _, _, _ = _jax_linearization(jg, n)
    lm = 1e-3
    j_apply = jpg._block_tridiag_precond(jg, jg.poses, w_rob, n, jnp.float32(lm))
    J = pg.edge_jacobians(g, g.poses, g.weights * torch.from_numpy(np.asarray(w_rob)))
    apply = pg._block_tridiag_precond(g, J, n, torch.tensor(lm))
    r = np.random.RandomState(2).randn(6 * n).astype(np.float32)
    ref = np.asarray(j_apply(j32(r)))
    got = apply(torch.from_numpy(r)).numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    Jd = J.double()
    Ji, Jj = Jd[:, :, :6], Jd[:, :, 6:]
    eye = torch.eye(6, dtype=torch.float64)
    D = torch.zeros((n, 6, 6), dtype=torch.float64).index_add_(0, g.edges_i, Ji.transpose(1, 2) @ Ji)
    D = D.index_add_(0, g.edges_j, Jj.transpose(1, 2) @ Jj) + (lm + 1e-8) * eye
    D[0] = eye
    chain = (g.edges_j == g.edges_i + 1) & (g.edges_i > 0)
    O = torch.zeros((n - 1, 6, 6), dtype=torch.float64).index_add_(
        0, torch.where(chain, g.edges_i, 0), torch.where(chain[:, None, None], Ji.transpose(1, 2) @ Jj, 0.0))
    z64 = backbone.backbone_apply_reference(*backbone.backbone_factor_reference(D, O), torch.from_numpy(r).double())
    z64 = z64.numpy()
    err = lambda z: np.abs(z - z64).max() / np.abs(z64).max()  # noqa: E731
    assert err(got) <= 2 * err(ref) + 1e-6


def test_inv6_matches_jax_including_singular_blocks():
    """The scaled 6x6 inverse (the backbone's Gauss-Jordan, in f64), and
    the non-finite pattern of a singular block (all ones), as JAX's _inv6
    (jnp.linalg.inv) gives them."""
    rng = np.random.RandomState(5)
    A = rng.randn(4, 6, 6).astype(np.float32)
    blocks = np.concatenate([A @ A.transpose(0, 2, 1) + np.eye(6, dtype=np.float32), np.ones((1, 6, 6), np.float32)])
    got = backbone.gj_inv6(torch.from_numpy(blocks).double()).numpy()
    ref = np.stack([np.asarray(jpg._inv6(j32(b))) for b in blocks])
    np.testing.assert_allclose(got[:4], ref[:4], rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(np.isfinite(got[4]), np.isfinite(ref[4]))
    assert not np.isfinite(got[4]).all()


def test_backbone_plain_version_solves_and_guards():
    """backbone_factor/apply on the CPU solve the block-tridiagonal system;
    a singular block (A_9 exactly 0 and decoupled from both neighbours, so
    it is still 0 when the reduction inverts it) or a NaN in r sends r
    through unchanged (CG's guard)."""
    n = 40
    g = torch.Generator().manual_seed(0)
    J = torch.randn((n - 1, 6, 12), generator=g)
    D = torch.zeros((n, 6, 6)) + torch.eye(6)
    D[:-1] += J[:, :, :6].transpose(1, 2) @ J[:, :, :6]
    D[1:] += J[:, :, 6:].transpose(1, 2) @ J[:, :, 6:]
    O = (J[:, :, :6].transpose(1, 2) @ J[:, :, 6:]).contiguous()
    r = torch.randn(6 * n, generator=g)
    S_inv, U = backbone.backbone_factor(D, O)
    z = backbone.backbone_apply(S_inv, U, r).double()
    M = _dense(D, O)
    assert ((M @ z - r.double()).abs().max() / r.abs().max()).item() < 1e-5
    D[9], O[8], O[9] = -backbone.DIAG * torch.eye(6), 0.0, 0.0  # A_9 = 0 at every level
    S_bad, U_bad = backbone.backbone_factor(D, O)
    assert not torch.isfinite(S_bad[9]).any()  # 0 * NaN carries it on to the later levels' blocks
    assert torch.equal(backbone.backbone_apply(S_bad, U_bad, r), r)
    r_nan = r.clone()
    r_nan[3] = float("nan")
    assert torch.equal(backbone.backbone_apply(S_inv, U, r_nan).isnan(), r_nan.isnan())
    with pytest.raises(ValueError, match="shape"):
        backbone.backbone_apply(S_inv, U, r[:-6])


def _dense(D, O, diag=backbone.DIAG):
    """The block-tridiagonal matrix in f64, + diag I on nodes >= 1."""
    n = D.shape[0]
    M = torch.zeros((6 * n, 6 * n), dtype=torch.float64)
    for i in range(n):
        M[6 * i : 6 * i + 6, 6 * i : 6 * i + 6] = D[i].double() + (diag * torch.eye(6, dtype=torch.float64) if i else 0)
        if i + 1 < n:
            M[6 * i : 6 * i + 6, 6 * i + 6 : 6 * i + 12] = O[i].double()
            M[6 * i + 6 : 6 * i + 12, 6 * i : 6 * i + 6] = O[i].double().T
    return M


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 64, 127, 200])
def test_backbone_cyclic_reduction_solves_in_f64(n):
    """The reduction at odd n, powers of two and one below: every node is
    eliminated at exactly one level, and the plain factor and apply in f64
    solve the system to f64 rounding (1e-12 of |z|)."""
    lv = backbone.levels(n)
    assert len(lv) == n.bit_length()
    assert torch.equal(torch.sort(torch.cat([p for _, p, _ in lv])).values, torch.arange(n))
    rng = np.random.RandomState(n)
    J = torch.from_numpy(rng.randn(max(n - 1, 0), 6, 12))
    D = torch.eye(6, dtype=torch.float64).repeat(n, 1, 1)
    D[:-1] += J[:, :, :6].transpose(1, 2) @ J[:, :, :6]
    D[1:] += J[:, :, 6:].transpose(1, 2) @ J[:, :, 6:]
    O = J[:, :, :6].transpose(1, 2) @ J[:, :, 6:]
    r = torch.from_numpy(rng.randn(6 * n))
    z = backbone.backbone_apply_reference(*backbone.backbone_factor_reference(D, O), r)
    ref = torch.linalg.solve(_dense(D, O), r)
    assert ((z - ref).abs().max() / ref.abs().max()).item() < 1e-12


def test_gj_inv6_inverts_and_marks_singular_blocks():
    """The reduction's 6x6 inverse (Gauss-Jordan with partial pivoting)
    against torch.linalg.inv in f64, a scale of 1e6 included; a zero block,
    an all-ones block and a NaN entry give non-finite entries, as JAX's
    _inv6 does."""
    rng = np.random.RandomState(6)
    A = rng.randn(8, 6, 6)
    blocks = torch.from_numpy(A @ A.transpose(0, 2, 1) + np.eye(6))
    blocks[3] *= 1e6
    blocks[5] = torch.from_numpy(rng.randn(6, 6))  # not symmetric: pivoting matters
    np.testing.assert_allclose(backbone.gj_inv6(blocks).numpy(), torch.linalg.inv(blocks).numpy(),
                               rtol=1e-9, atol=1e-12 * 1e-6)
    bad = torch.stack([torch.zeros(6, 6), torch.ones(6, 6), torch.eye(6)]).double()
    bad[2, 2, 3] = float("nan")
    got = backbone.gj_inv6(bad)
    for b, g_ in zip(bad, got):
        assert not np.isfinite(np.asarray(jpg._inv6(j32(b.float().numpy())))).all()
        assert not torch.isfinite(g_).all()


def _jax_guarded(j_apply, r):
    """JAX's precond behind its CG guard (pose_graph.py:120-122)."""
    z = j_apply(j32(r))
    return np.asarray(jnp.where(jnp.all(jnp.isfinite(z)), z, j32(r)))


@pytest.mark.parametrize("case", ["nan_in_r", "inf_weight", "nan_pose"])
def test_backbone_guard_matches_jax(case):
    """Where JAX's guarded preconditioner sends r through (a NaN in r, an
    infinite loop-edge weight, a NaN in a pose), the port's does too, and
    elsewhere both are finite."""
    gt, est, loops = _loop12()
    if case == "inf_weight":
        loops = [(i, j, T, np.inf) for i, j, T, _ in loops]
    if case == "nan_pose":
        est = est.copy()
        est[5, 0, 3] = np.nan
    jg, g = _both(est, loops)
    n = est.shape[0]
    _, w_rob, _, _, _ = _jax_linearization(jg, n)
    j_apply = jpg._block_tridiag_precond(jg, jg.poses, w_rob, n, jnp.float32(1e-3))
    J = pg.edge_jacobians(g, g.poses, g.weights * torch.from_numpy(np.array(w_rob)))
    apply = pg._block_tridiag_precond(g, J, n, torch.tensor(1e-3))
    r = np.random.RandomState(7).randn(6 * n).astype(np.float32)
    if case == "nan_in_r":
        r[8] = np.nan
    ref = _jax_guarded(j_apply, r)
    got = apply(torch.from_numpy(r)).numpy()
    sent_through = np.array_equal(ref, r, equal_nan=True)
    assert sent_through and np.array_equal(got, r, equal_nan=True)


def test_backbone_singular_block_guard_as_jax():
    """A singular diagonal block (A_5 = 0, decoupled): JAX's _inv6 of it is
    non-finite, so its chain and then its guard give r; the port's plain
    version gives r too."""
    n = 12
    g = torch.Generator().manual_seed(3)
    D = torch.eye(6).repeat(n, 1, 1) * 2.0
    O = 0.1 * torch.randn((n - 1, 6, 6), generator=g)
    D[5], O[4], O[5] = -backbone.DIAG * torch.eye(6), 0.0, 0.0
    assert not (D[5].double() + backbone.DIAG * torch.eye(6, dtype=torch.float64)).any()
    assert not np.isfinite(np.asarray(jpg._inv6(j32(np.zeros((6, 6), np.float32))))).all()
    r = torch.randn(6 * n, generator=g)
    assert torch.equal(backbone.backbone_apply(*backbone.backbone_factor(D, O), r), r)


def _jax_ldlt_guarded(D, O, r):
    """JAX's backbone solve on given blocks (D, O): the block LDL^T of
    realsensetracker_tpu/optimize/pose_graph.py:222-258 with its _inv6, its
    1e-10 on each S_i and HIGHEST matmuls, then CG's guard (:120-122)."""
    hi = jax.lax.Precision.HIGHEST
    Dj, Oj, rn = j32(D.numpy()), j32(O.numpy()), j32(r.numpy()).reshape(-1, 6)
    n = Dj.shape[0]
    S_inv, U = [jpg._inv6(Dj[0])], []
    for i in range(1, n):
        U.append(jnp.matmul(S_inv[-1], Oj[i - 1], precision=hi))
        S = Dj[i] - jnp.matmul(Oj[i - 1].T, U[-1], precision=hi) + 1e-10 * jnp.eye(6, dtype=jnp.float32)
        S_inv.append(jpg._inv6(S))
    y = [rn[0]]
    for i in range(1, n):
        y.append(rn[i] - jnp.matmul(U[i - 1].T, y[-1], precision=hi))
    z = [jnp.matmul(S_inv[-1], y[-1], precision=hi)]
    for i in range(n - 2, -1, -1):
        z.insert(0, jnp.matmul(S_inv[i], y[i], precision=hi) - jnp.matmul(U[i], z[0], precision=hi))
    return _jax_guarded(lambda _: jnp.concatenate(z), r.numpy())


def test_backbone_left_singular_block_diverges_from_jax():
    """Where the port parts from JAX, recorded: a block singular only from
    the left (D_9 = -1e-10 I, O_8 = 0, O_9 kept) makes M indefinite. JAX's
    LDL^T meets S_9 = 0 there, its _inv6 is non-finite and its guard
    returns r. The reduction keeps node 9 at its first level, where its
    right neighbour makes the block regular, and solves M z = r to a finite
    z (1e-5 of |r|). optimize_pose_graph never builds such an M: its
    backbone is SPD (test_backbone_blocks_are_spd_at_the_damping_floor)."""
    n = 40
    g = torch.Generator().manual_seed(0)
    J = torch.randn((n - 1, 6, 12), generator=g)
    D = torch.zeros((n, 6, 6)) + torch.eye(6)
    D[:-1] += J[:, :, :6].transpose(1, 2) @ J[:, :, :6]
    D[1:] += J[:, :, 6:].transpose(1, 2) @ J[:, :, 6:]
    O = (J[:, :, :6].transpose(1, 2) @ J[:, :, 6:]).contiguous()
    r = torch.randn(6 * n, generator=g)
    D[9], O[8] = -backbone.DIAG * torch.eye(6), 0.0  # S_9 = 0 exactly in LDL^T
    M = _dense(D, O)
    assert torch.linalg.eigvalsh(M).min().item() < 0
    assert np.array_equal(_jax_ldlt_guarded(D, O, r), r.numpy())
    z = backbone.backbone_apply(*backbone.backbone_factor(D, O), r)
    assert torch.isfinite(z).all() and not torch.equal(z, r)
    assert ((M @ z.double() - r.double()).abs().max() / r.abs().max()).item() < 1e-5
    D_ok, O_ok = D.clone(), O.clone()
    D_ok[9] = torch.eye(6)  # the same chain with a regular block: JAX and the port agree
    ref = _jax_ldlt_guarded(D_ok, O_ok, r)
    got = backbone.backbone_apply(*backbone.backbone_factor(D_ok, O_ok), r).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("use_gm", [False, True], ids=["huber", "geman_mcclure"])
@pytest.mark.parametrize("at", ["start", "optimized"])
def test_backbone_blocks_are_spd_at_the_damping_floor(graph, at, use_gm):
    """The claim the reduction's guard rests on: the backbone that
    optimize_pose_graph builds (backbone_blocks: every edge's J^T J, +
    damping + 1e-8 on nodes >= 1, node 0 an identity block, + the factor's
    1e-10) is SPD at the damping floor (1e-6), with either IRLS weight, at
    the start poses and after three GN iterations: symmetric, its smallest
    eigenvalue in f64 above 0 and its Cholesky factor found."""
    _, _, est, loops, _, g = graph
    n = est.shape[0]
    poses = g.poses if at == "start" else pg.optimize_pose_graph(g, gn_iters=3)[0]
    r_edges = pg._edge_residuals(torch.zeros((n, 6)), g._replace(poses=poses))
    w_rob = pg.robust_weights(r_edges, 0.1, use_gm)
    J = pg.edge_jacobians(g, poses, g.weights * w_rob)
    D, O = pg.backbone_blocks(g, J, n, torch.tensor(1e-6))
    M = _dense(D, O)
    assert torch.equal(M, M.T)
    assert torch.linalg.eigvalsh(M).min().item() > 0
    assert torch.linalg.cholesky_ex(M).info.item() == 0


# --- optimize_pose_graph --------------------------------------------------------


@pytest.mark.parametrize("name,precondition", [("loop12", True), ("loop12", False), ("graph200", True)],
                         ids=["loop12-pcg", "loop12-plain", "graph200-pcg"])
def test_optimize_matches_jax(name, precondition):
    """Two GN iterations of 60 CG steps (the cost falls from 0.34 to its
    floor on the loop, and by 2 orders on the 200-node graph): poses within
    1e-4, cost within 1e-4 relative."""
    _, est, loops = GRAPHS[name]()
    jg, g = _both(est, loops)
    kw = dict(gn_iters=2, cg_iters=60, precondition=precondition)
    jp, jc = jpg.optimize_pose_graph(jg, **kw)
    p, c = pg.optimize_pose_graph(g, **kw)
    assert np.abs(p.numpy() - np.asarray(jp)).max() < 1e-4
    assert abs(float(c) / float(jc) - 1) < 1e-4


def _ulp_moved(est):
    """est with every rotation and translation entry one ulp up."""
    out = np.nextafter(est, np.float32(np.inf)).astype(np.float32)
    out[:, 3, :] = est[:, 3, :]
    return out


@pytest.mark.parametrize("name,precondition,gn_iters", [("loop12", False, 15), ("graph200", True, 6),
                                                        ("graph200", False, 2)],
                         ids=["loop12-plain-15", "graph200-pcg-6", "graph200-plain-2"])
def test_optimize_parts_where_jax_parts_from_itself(name, precondition, gn_iters):
    """The parting, found stage by stage: the operator agrees to 4e-8 of
    |Hv| (above), but unpreconditioned CG's 60th iterate on an
    ill-conditioned graph, and the LM steps taken at the cost's rounding
    floor, follow the last ulp. At the JAX tests' own settings JAX's result
    moves past the 1e-4 bar when its input poses move by ONE ulp; the port
    parts from JAX by at most ten times that move, its cost within 1e-2
    relative."""
    _, est, loops = GRAPHS[name]()
    jg, g = _both(est, loops)
    jg_ulp, _ = _both(_ulp_moved(est), loops)
    kw = dict(gn_iters=gn_iters, cg_iters=60, precondition=precondition)
    jp, jc = jpg.optimize_pose_graph(jg, **kw)
    jp_ulp, _ = jpg.optimize_pose_graph(jg_ulp, **kw)
    p, c = pg.optimize_pose_graph(g, **kw)
    jax_moves = np.abs(np.asarray(jp_ulp) - np.asarray(jp)).max()
    assert jax_moves > 1e-4
    assert np.abs(p.numpy() - np.asarray(jp)).max() < 10 * jax_moves
    assert abs(float(c) / float(jc) - 1) < 1e-2


# --- the JAX tests' semantics, on the port ---------------------------------------


def _solve(est, loops=(), **kw):
    g = pg.from_trajectory(est, loop_edges=loops, device=CPU,
                           **{k: kw.pop(k) for k in ("odometry", "odometry_weights") if k in kw})
    p, c = pg.optimize_pose_graph(g, **kw)
    return p.numpy(), float(c)


def test_odometry_only_is_stationary_and_gauge_fixed():
    _, est = _noisy_loop()
    poses, cost = _solve(est, gn_iters=3, cg_iters=30)
    assert cost < 1e-8
    np.testing.assert_allclose(poses, est, atol=1e-4)
    np.testing.assert_allclose(poses[0], np.eye(4), atol=1e-5)


def test_loop_closure_removes_drift():
    gt, est, loops = _loop12()
    poses, cost = _solve(est, loops, gn_iters=15, cg_iters=60)
    before = np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])
    assert np.linalg.norm(poses[-1][:3, 3] - gt[-1][:3, 3]) < 0.5 * before
    assert np.isfinite(cost)


def test_huber_bounds_outlier_edge_damage():
    gt, est = _noisy_loop(n=10, drift=0.0)
    T_bad = se3.exp(torch.tensor([0.5, -0.3, 0.4, 0.4, -0.3, 0.5])).numpy() @ (np.linalg.inv(gt[0]) @ gt[-1])
    loops = [(0, 9, T_bad.astype(np.float32), 1.0)]
    err = {}
    for delta in (0.1, 0.0):
        poses, _ = _solve(est, loops, gn_iters=10, cg_iters=50, huber_delta=delta)
        err[delta] = max(np.linalg.norm(poses[k][:3, 3] - gt[k][:3, 3]) for k in range(10))
    assert err[0.1] < 0.5 * err[0.0]


def test_backbone_preconditioning_beats_plain_cg_at_the_same_budget():
    """The 1000-node test's claim on the 200-node graph: PCG at 60 steps
    reaches a long plain-CG run's cost, plain CG at 60 falls short."""
    gt, est, loops = _graph200()
    kw = dict(gn_iters=6, huber_delta=0.1)
    p_pcg, c_pcg = _solve(est, loops, cg_iters=60, precondition=True, **kw)
    _, c_plain = _solve(est, loops, cg_iters=60, precondition=False, **kw)
    _, c_ref = _solve(est, loops, cg_iters=600, precondition=False, **kw)
    assert c_pcg <= 1.05 * c_ref + 1e-8
    assert c_plain > 1.5 * c_pcg
    err = lambda P: np.abs(P[:, :3, 3] - gt[:, :3, 3]).max()  # noqa: E731
    assert err(p_pcg) < 0.5 * err(est)


def test_lm_safeguard_survives_meter_scale_drift():
    n = 80
    step_gt = se3.exp(torch.tensor([0.05, 0, 0, 0, 0, 0.0])).numpy()
    step_est = se3.exp(torch.tensor([0.05, 0, 0, 0, 0, 0.042])).numpy()
    gt, est = [np.eye(4, dtype=np.float32)], [np.eye(4, dtype=np.float32)]
    for _ in range(n - 1):
        gt.append((gt[-1] @ step_gt).astype(np.float32))
        est.append((est[-1] @ step_est).astype(np.float32))
    gt, est = np.stack(gt), np.stack(est)
    loops = [(0, j, (np.linalg.inv(gt[0]) @ gt[j]).astype(np.float32), 1.0) for j in (n - 1, n - 2, n - 3, n // 2)]
    poses, cost = _solve(est, loops, gn_iters=25, cg_iters=60)
    assert np.isfinite(poses).all() and np.isfinite(cost)
    before = np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])
    assert np.linalg.norm(poses[-1][:3, 3] - gt[-1][:3, 3]) < 0.5 * before


def test_downweighted_odometry_lets_loop_reanchor():
    n = 10
    step = se3.exp(torch.tensor([0.3, 0, 0, 0, 0, 0.0])).numpy().astype(np.float32)
    gt = [np.eye(4, dtype=np.float32)]
    for _ in range(n - 1):
        gt.append((gt[-1] @ step).astype(np.float32))
    odom = [step] * (n - 1)
    odom[4] = np.eye(4, dtype=np.float32)  # this edge saw no motion (held pose)
    est = [np.eye(4, dtype=np.float32)]
    for T in odom:
        est.append((est[-1] @ T).astype(np.float32))
    loops = [(0, n - 1, (np.linalg.inv(gt[0]) @ gt[-1]).astype(np.float32), 2.0)]
    err = {}
    for name, w4 in (("flat", 1.0), ("weighted", 0.05)):
        weights = [1.0] * (n - 1)
        weights[4] = w4
        poses, _ = _solve(np.stack(est), loops, odometry=odom, odometry_weights=weights, gn_iters=15, cg_iters=60)
        err[name] = np.linalg.norm(poses[-1][:3, 3] - gt[-1][:3, 3])
    assert err["weighted"] < 0.5 * err["flat"] and err["weighted"] < 0.03


def test_inert_padding_changes_nothing():
    """Weight-0 chain edges to repeated poses and (0, 0) self-edges, the
    SLAM layer's padding, leave the real nodes' result within 1e-5 over
    the GN iterations before the cost's floor. (At the floor the padding
    moves the last ulps, and the loop's result with them: by 1.8e-4 at 6
    GN iterations in JAX as in the port.)"""
    _, est, loops = _loop12()
    kw = dict(gn_iters=3, cg_iters=40)
    plain, _ = _solve(est, loops, **kw)
    eye = np.eye(4, dtype=np.float32)
    padded_est = np.concatenate([est, np.repeat(est[-1:], 4, axis=0)])
    odom = [(np.linalg.inv(est[i]) @ est[i + 1]).astype(np.float32) for i in range(11)] + [eye] * 4
    padded, _ = _solve(padded_est, loops + [(0, 0, eye, 0.0)] * 3, odometry=odom,
                       odometry_weights=[1.0] * 11 + [0.0] * 4, **kw)
    np.testing.assert_allclose(padded[:12], plain, atol=1e-5)


def test_optimize_copies_nothing_to_the_host_before_the_read(monkeypatch):
    """Every decision is a torch.where: no .item(), bool() or .cpu() runs
    inside optimize_pose_graph (on the card each would be a sync)."""
    _, est, loops = _loop12()
    g = pg.from_trajectory(est, loop_edges=loops, device=CPU)
    calls = []
    for name in ("item", "cpu", "numpy", "tolist", "__bool__", "__float__", "__int__"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name, lambda self, *a, _n=name, _o=orig, **k: (calls.append(_n), _o(self, *a, **k))[1])
    pg.optimize_pose_graph(g, gn_iters=2, cg_iters=5)
    monkeypatch.undo()
    assert calls == []
