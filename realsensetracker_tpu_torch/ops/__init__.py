"""Dense image-grid ops (grid normals, the depth pyramid) and sparse cloud
ops (masked clouds, voxel downsample, nearest neighbours, k-NN PCA normals,
FPFH)."""
