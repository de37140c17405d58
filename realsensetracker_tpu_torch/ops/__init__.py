"""Dense image-grid ops: grid normals and the depth pyramid."""
