"""The benchmark of gennerf_tpu_torch on one or four NVIDIA cards.

`python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json once. Everything a cell needs is found by
name: its configuration under configs/, its traffic mix under traffic/ and
the driver that mix names under drivers/, its correctness limits under
limits/, its per-layer metric readers under metrics/, the operation counts
under counts/ and the plain reference of its configuration under
reference/. Nothing here imports JAX or the JAX package.
"""
