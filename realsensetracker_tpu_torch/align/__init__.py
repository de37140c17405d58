"""Registration: projective point-to-plane ICP, Kabsch and GNC-ICP."""
