"""Secure MapReduce on the virtual mesh: shuffle, engine, driver, k-means."""
