"""Pipeline presets: named, configured registration pipelines.

Port of realsensetracker_tpu/models/.

| name              | pipeline                                   | reference analog |
|-------------------|--------------------------------------------|------------------|
| projective-icp    | pyramid + projective point-to-plane GN     | north-star rebuild of the ICP stack |
| keyframe          | projective ICP of a depth pair, as the keyframe tracker registers | rs_replay_app.cpp:274-287 |
| gnc-icp           | brute-force 1-NN GNC-weighted SVD ICP      | AlignIcp3d, align_icp.cpp:73-167 |
| gicp              | whitened plane-to-plane Gauss-Newton       | ComputeAlignment, align_gicp.cpp |
| fpfh-kabsch-icp   | FPFH match + Lowe + weighted Kabsch + ICP  | rs_align_app pipeline, rs_align_app.cpp:272-308 |
| robust-global     | GNC-TLS global registration                | RegisterTeaser, teaser_interface.cpp |
"""

from realsensetracker_tpu_torch.models.pairwise import AlignPairResult, align_pair  # noqa: F401
from realsensetracker_tpu_torch.models.registry import get_pipeline, list_pipelines  # noqa: F401
