"""Fused k-means assign + accumulate: Hopper kernel, plain version, dispatch."""
