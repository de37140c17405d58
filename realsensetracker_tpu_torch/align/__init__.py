"""Registration: projective point-to-plane ICP, Kabsch, GNC-ICP, GICP and
robust global registration."""
