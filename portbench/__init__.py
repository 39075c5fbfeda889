"""The benchmark of taichi_3d_gaussian_splatting_torch: `run.py` runs one
cell of BENCHMARK.json once."""
