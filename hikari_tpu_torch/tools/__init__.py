"""Tools of the port: the primitives of ``tools/bench_pallas_prims.py`` as
CUDA kernels (``prims``) and that microbenchmark (``bench_pallas_prims``)."""
