"""Window loops, one module per traffic kind (`traffic/<workload>.json`'s
`kind`): `jobs` (served secure k-means jobs), `prefill` and `decode`."""
