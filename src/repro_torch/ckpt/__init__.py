"""Checkpoints of a train state: per-leaf ``.npy`` files, atomic commit."""
