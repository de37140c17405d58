"""Dense mapping: the TSDF volume (integrate, raycast, surface extraction),
marching-tetrahedra meshes and the submap atlas."""
