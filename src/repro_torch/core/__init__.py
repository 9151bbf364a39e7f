"""Sparse formats, pruning and the Sparse-on-Dense apply surface."""
