"""The port's benchmark: the rrData noise sweep through
`tpudenoise_torch.eval.harness.test_net_batched` on an NVIDIA GPU.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json once and prints one JSON line.  Cells,
configurations, traffic mixes, per-layer metrics and kernel cost counts
are found by name: `configs/<name>.json`, `traffic/<name>.json`,
`metrics/<name>.py`, `kernels/<entry>.py`.  `reference/` is the plain
float32 reference that decides `correct`; it imports nothing of the
program.
"""
