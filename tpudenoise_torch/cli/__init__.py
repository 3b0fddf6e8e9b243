"""Command-line entry points of the port: `python -m
tpudenoise_torch.cli.test`, `python -m tpudenoise_torch.cli.demo`,
`python -m tpudenoise_torch.cli.trainval` and `python -m
tpudenoise_torch.cli.reval`."""
