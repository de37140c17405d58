"""Loop-closure detection: place recognition over keyframe descriptors.

Port of realsensetracker_tpu/loop_closure/detector.py. Each keyframe is
summarized by a global descriptor pooled from its FPFH point features
(mean + max pooling, 66-D, L2-normalized); the database is a
fixed-capacity set of device tensors (descriptors (K, 66), clouds
(K, N, 3) + masks, features (K, N, 33)) that doubles when full, so a query
is one matrix-vector product against the whole store and one host copy of
the (K,) similarities. Geometric verification registers the query onto
each candidate with robust global registration, checks the symmetric
cloud overlap and refines by ICP: the port's register_robust reads its
peel and GNC stop flags on the host, so candidates verify one after
another, in order, where JAX vmaps them. Accepted candidates become loop
edges of the pose graph (optimize/pose_graph.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from realsensetracker_tpu_torch.align import icp as icp_mod
from realsensetracker_tpu_torch.align import robust_global
from realsensetracker_tpu_torch.ops import fpfh as fpfh_mod
from realsensetracker_tpu_torch.ops.cloud import Cloud

DESCRIPTOR_DIM = 2 * fpfh_mod.FPFH_SIZE  # mean-pool + max-pool halves


def global_descriptor(feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Pool per-point FPFH features (N, 33) into one L2-normalized 66-D
    place descriptor."""
    m = mask.to(feats.dtype)[:, None]
    denom = torch.clamp(m.sum(), min=1.0)
    mean = (feats * m).sum(0) / denom
    mx = torch.where(m > 0, feats, -torch.inf).amax(0)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    d = torch.cat([mean, mx])
    return d / torch.clamp(torch.linalg.vector_norm(d), min=1e-12)


def _verify_one(q: Cloud, q_feats, c: Cloud, c_feats, noise_bound, min_inliers, min_inlier_fraction,
                overlap_tau, min_overlap, refine_iters):
    """One candidate (realsensetracker_tpu/loop_closure/detector.py:98-128):
    robust global registration of the query onto the candidate, then
    acceptance on absolute inliers, inlier fraction and symmetric overlap;
    the ICP refinement of the coarse transform is kept only when finite and
    not losing overlap. Returns (T (4,4), ok, overlap) on the device."""
    res = robust_global.register_robust(q, c, q_feats, c_feats, noise_bound)
    frac = res.num_inliers / torch.clamp(res.num_correspondences, min=1)
    fwd, bwd = robust_global.symmetric_overlap(res.transform, q, c, overlap_tau)
    ov = torch.minimum(fwd, bwd)
    ok = res.valid & (res.num_inliers >= min_inliers) & (frac >= min_inlier_fraction) & (ov >= min_overlap)
    ref = icp_mod.align_icp(q, c, max_iter=refine_iters, init_transform=res.transform)
    f2, b2 = robust_global.symmetric_overlap(ref.transform, q, c, overlap_tau)
    use_ref = torch.isfinite(ref.transform).all() & (torch.minimum(f2, b2) >= ov)
    return torch.where(use_ref, ref.transform, res.transform), ok, ov


@dataclass
class KeyframeDatabase:
    """Device-resident keyframe store + dense similarity place recognition."""

    min_separation: int = 10  # skip temporally adjacent keyframes
    similarity_threshold: float = 0.95  # cosine similarity gate
    capacity: int = 256  # keyframe slots (grows by doubling when exceeded)

    _desc: object = None  # (K, 66) device
    _pts: object = None  # (K, N, 3) device
    _mask: object = None  # (K, N) device
    _feats: object = None  # (K, N, 33) device
    _ids: list = field(default_factory=list)  # host frame ids, insert order

    def __len__(self) -> int:
        return len(self._ids)

    def _ensure_store(self, cloud: Cloud) -> None:
        n, dev = cloud.capacity, cloud.points.device
        if self._desc is None:
            k = self.capacity
            self._desc = torch.zeros((k, DESCRIPTOR_DIM), dtype=torch.float32, device=dev)
            self._pts = torch.zeros((k, n, 3), dtype=torch.float32, device=dev)
            self._mask = torch.zeros((k, n), dtype=torch.bool, device=dev)
            self._feats = torch.zeros((k, n, fpfh_mod.FPFH_SIZE), dtype=torch.float32, device=dev)
        elif len(self._ids) >= self._desc.shape[0]:
            # Double the store (amortized O(1) copies).
            self._desc = torch.cat([self._desc, torch.zeros_like(self._desc)])
            self._pts = torch.cat([self._pts, torch.zeros_like(self._pts)])
            self._mask = torch.cat([self._mask, torch.zeros_like(self._mask)])
            self._feats = torch.cat([self._feats, torch.zeros_like(self._feats)])

    def add(self, frame_id: int, cloud: Cloud, feats: torch.Tensor) -> None:
        """Insert one keyframe: its descriptor, cloud and features become
        row len(self) of the store (row writes, no host copy)."""
        self._ensure_store(cloud)
        k = len(self._ids)
        self._desc[k] = global_descriptor(feats, cloud.mask)
        self._pts[k] = cloud.points.to(torch.float32)
        self._mask[k] = cloud.mask
        self._feats[k] = feats.to(torch.float32)
        self._ids.append(int(frame_id))

    def query(self, frame_id: int, cloud: Cloud, feats: torch.Tensor, top_k: int = 3,
              desc: torch.Tensor | None = None):
        """[(candidate_frame_id, similarity), ...] above threshold, most
        similar first, excluding temporally nearby keyframes: one product on
        the device and one host copy of the (K,) similarities. desc: the
        query descriptor when the caller has it."""
        if not self._ids:
            return []
        count = len(self._ids)
        q = global_descriptor(feats, cloud.mask) if desc is None else desc
        sims = (self._desc @ q).cpu().numpy()[:count]  # the query's one host copy
        order = np.argsort(-sims, kind="stable")
        out = []
        for k in order:
            cand_id = self._ids[k]
            if abs(cand_id - frame_id) < self.min_separation:
                continue
            if sims[k] < self.similarity_threshold:
                break
            out.append((cand_id, float(sims[k])))
            if len(out) >= top_k:
                break
        return out

    def verify_batch(self, frame_id_a: int, cloud_a, feats_a, candidate_ids: list,
                     noise_bound: float = 0.25, min_inliers: int = 10,
                     min_inlier_fraction: float = 0.3, overlap_tau: float = 0.05,
                     min_overlap: float = 0.6, refine_iters: int = 64, pad_to: int | None = None):
        """Verify the candidates of one query: [(T_ab (4,4) np, ok bool),
        ...] aligned with candidate_ids, truncated to the first pad_to when
        more are passed."""
        out = self.verify_batch_async(
            frame_id_a, cloud_a, feats_a, candidate_ids, noise_bound=noise_bound, min_inliers=min_inliers,
            min_inlier_fraction=min_inlier_fraction, overlap_tau=overlap_tau, min_overlap=min_overlap,
            refine_iters=refine_iters, pad_to=pad_to,
        )
        if out is None:
            return []
        return self.finish_verify(*out)

    def verify_batch_async(self, frame_id_a, cloud_a, feats_a, candidate_ids: list,
                           noise_bound: float = 0.25, min_inliers: int = 10,
                           min_inlier_fraction: float = 0.3, overlap_tau: float = 0.05,
                           min_overlap: float = 0.6, refine_iters: int = 64, pad_to: int | None = None):
        """Verification without the final host copy: (T (C,4,4), ok (C,),
        kept_ids) on the device, for finish_verify; None without candidates.
        pad_to keeps the first pad_to candidates (callers rank them by
        similarity)."""
        del frame_id_a
        if not candidate_ids:
            return None
        if pad_to is not None and len(candidate_ids) > pad_to:
            candidate_ids = candidate_ids[:pad_to]
        q = Cloud(cloud_a.points.to(torch.float32), cloud_a.mask)
        q_feats = feats_a.to(torch.float32)
        Ts, oks = [], []
        for cid in candidate_ids:
            row = self._ids.index(cid)
            T, ok, _ov = _verify_one(
                q, q_feats, Cloud(self._pts[row], self._mask[row]), self._feats[row],
                float(noise_bound), int(min_inliers), float(min_inlier_fraction), float(overlap_tau),
                float(min_overlap), int(refine_iters),
            )
            Ts.append(T)
            oks.append(ok)
        return torch.stack(Ts), torch.stack(oks), list(candidate_ids)

    @staticmethod
    def finish_verify(T_dev, ok_dev, kept_ids):
        """Materialize a verify_batch_async result: [(T_ab, ok), ...]
        aligned with kept_ids."""
        T = T_dev.cpu().numpy()
        ok = ok_dev.cpu().numpy()
        return [(T[i], bool(ok[i])) for i in range(len(kept_ids))]

    def verify(self, frame_id_a: int, cloud_a, feats_a, candidate_id: int, noise_bound: float = 0.25,
               min_inliers: int = 10, min_inlier_fraction: float = 0.3, overlap_tau: float = 0.05,
               min_overlap: float = 0.6):
        """Single-candidate verify_batch: (T_ab (4,4) tensor on the store's
        device, ok)."""
        ((T, ok),) = self.verify_batch(
            frame_id_a, cloud_a, feats_a, [candidate_id], noise_bound=noise_bound, min_inliers=min_inliers,
            min_inlier_fraction=min_inlier_fraction, overlap_tau=overlap_tau, min_overlap=min_overlap,
        )
        return torch.as_tensor(T, device=self._desc.device), ok
