"""Algorithm library and workloads (the reference's L4 `library/`).
Ported so far: the window triangle count and its workload pipelines."""
