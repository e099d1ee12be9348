"""The port's benchmark: one command runs one cell of BENCHMARK.json.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` from the root of a checkout.  Everything that belongs to one
model configuration, traffic mix or per-layer metric sits in a file of its
own (configs/, traffic/, metrics/), found by the name BENCHMARK.json gives.
"""
