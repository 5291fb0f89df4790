"""pdnbench: the benchmark of padne_tpu_torch, the PyTorch and CUDA port.

`python3 pdnbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once on a CUDA card and
prints one JSON line (see harness.py).  Configurations, traffic mixes
and metrics are files found by name: configs/<config>.json,
traffic/<mix>.json (read by the entry named in it, entries/<entry>.py),
metrics/<metric>.py.
"""
