"""The benchmark of pycricodecs_tpu_torch, the port (PyTorch and CUDA).

`python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once on one CUDA device and
prints its result as the last line of standard output. Everything that
belongs to one configuration, traffic mix, job or metric is a file of its
own here, found by the name BENCHMARK.json gives it: configs/<config>.json
(with the committed stream it names under streams/),
traffic/<traffic>.json, jobs/<job>.py, metrics/<metric>.py. The plain
reference (reference.py) imports torch and numpy only. Nothing here
imports jax or the JAX package pycricodecs_tpu.
"""
