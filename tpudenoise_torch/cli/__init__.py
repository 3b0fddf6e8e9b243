"""Command-line entry points of the port: `python -m
tpudenoise_torch.cli.test` and `python -m tpudenoise_torch.cli.demo`."""
