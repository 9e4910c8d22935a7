"""Read-to-graph aligner: the on-device replacement for minigraph.

Seed (minimizers) → vote (diagonal binning) → extend (banded affine-gap DP
against the locus panel) → winner-takes-the-cluster counting.
"""
