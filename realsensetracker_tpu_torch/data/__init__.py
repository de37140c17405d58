"""Data sources: synthetic raycast scenes and the depth-unit policy."""
