"""Registration: projective point-to-plane ICP."""
