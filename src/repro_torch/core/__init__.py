"""Secure MapReduce on the virtual mesh: shuffle, engine (`run_mapreduce`,
`run_mapreduce_until`), iterative driver with replicated and sharded carried
state, and the workloads: k-means, sampling sort, streaming grep, word count."""
