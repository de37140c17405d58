"""Trajectory container + TUM-format I/O, ATE and RPE.

Port of realsensetracker_tpu/tracking/trajectory.py. Poses are host
float64 4x4 arrays (world_from_cam); the TUM quaternions go through the
port's se3 on CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from realsensetracker_tpu_torch.geometry import se3


@dataclass
class Trajectory:
    timestamps: list = field(default_factory=list)
    poses: list = field(default_factory=list)  # 4x4 np arrays, world_from_cam

    def append(self, timestamp: float, pose) -> None:
        self.timestamps.append(float(timestamp))
        self.poses.append(np.asarray(pose, dtype=np.float64))

    def __len__(self) -> int:
        return len(self.poses)

    def save_tum(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_tum())

    def to_tum(self) -> str:
        lines = []
        for ts, T in zip(self.timestamps, self.poses):
            t = T[:3, 3]
            q = se3.quaternion_from_matrix(torch.from_numpy(T[:3, :3].astype(np.float32))).numpy()
            lines.append(
                f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}"
            )
        return "\n".join(lines) + "\n"

    @staticmethod
    def load_tum(path: str) -> "Trajectory":
        traj = Trajectory()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, tx, ty, tz, qx, qy, qz, qw = (float(x) for x in line.split()[:8])
                R = se3.matrix_from_quaternion(torch.tensor([qx, qy, qz, qw], dtype=torch.float32))
                T = np.eye(4)
                T[:3, :3] = R.numpy()
                T[:3, 3] = [tx, ty, tz]
                traj.append(ts, T)
        return traj


def relative_pose_error(est: Trajectory, gt: Trajectory, delta: float = 1.0) -> dict:
    """TUM-benchmark RPE over a fixed time interval `delta` seconds:
    translational RMSE/mean/max in meters, rotational in degrees."""
    if len(est) < 2 or len(gt) < 2:
        return {"trans_rmse": float("inf"), "pairs": 0}
    est_ts = np.asarray(est.timestamps)
    gt_ts = np.asarray(gt.timestamps)

    def associate(ts):
        j = int(np.argmin(np.abs(gt_ts - ts)))
        return j if abs(gt_ts[j] - ts) <= 0.02 else None

    terr, rerr = [], []
    for i, ts in enumerate(est_ts):
        k = int(np.argmin(np.abs(est_ts - (ts + delta))))
        # Only near-exact windows count (as in the TUM evaluate_rpe tool).
        if abs(est_ts[k] - (ts + delta)) > 0.1 * delta or k == i:
            continue
        j0, j1 = associate(ts), associate(est_ts[k])
        if j0 is None or j1 is None:
            continue
        dP = np.linalg.inv(est.poses[i]) @ est.poses[k]
        dQ = np.linalg.inv(gt.poses[j0]) @ gt.poses[j1]
        E = np.linalg.inv(dQ) @ dP
        terr.append(np.linalg.norm(E[:3, 3]))
        c = np.clip((np.trace(E[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        rerr.append(np.degrees(np.arccos(c)))
    if not terr:
        return {"trans_rmse": float("inf"), "pairs": 0}
    terr, rerr = np.asarray(terr), np.asarray(rerr)
    return {
        "trans_rmse": float(np.sqrt((terr**2).mean())),
        "trans_mean": float(terr.mean()),
        "trans_max": float(terr.max()),
        "rot_rmse_deg": float(np.sqrt((rerr**2).mean())),
        "rot_mean_deg": float(rerr.mean()),
        "rot_max_deg": float(rerr.max()),
        "delta_s": float(delta),
        "pairs": int(len(terr)),
    }


def absolute_trajectory_error(est: Trajectory, gt: Trajectory) -> dict:
    """ATE after Horn alignment (rotation + translation, unit scale) of
    poses associated by nearest timestamp (max 0.02 s): {"rmse", "mean",
    "median", "max", "pairs"} in meters."""
    if len(est) == 0 or len(gt) == 0:
        return {"rmse": float("inf"), "pairs": 0}
    est_ts = np.asarray(est.timestamps)
    gt_ts = np.asarray(gt.timestamps)
    pairs = []
    for i, ts in enumerate(est_ts):
        j = int(np.argmin(np.abs(gt_ts - ts)))
        if abs(gt_ts[j] - ts) <= 0.02:
            pairs.append((i, j))
    if len(pairs) < 2:
        return {"rmse": float("inf"), "pairs": len(pairs)}
    P = np.stack([est.poses[i][:3, 3] for i, _ in pairs])  # est positions
    Q = np.stack([gt.poses[j][:3, 3] for _, j in pairs])  # gt positions
    mu_p, mu_q = P.mean(0), Q.mean(0)
    W = (Q - mu_q).T @ (P - mu_p)
    U, _, Vt = np.linalg.svd(W)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ S @ Vt
    t = mu_q - R @ mu_p
    err = np.linalg.norm((P @ R.T + t) - Q, axis=1)
    return {
        "rmse": float(np.sqrt((err**2).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "max": float(err.max()),
        "pairs": len(pairs),
    }
