"""Experiments run through the port: `python -m
tpudenoise_torch.experiments.noise_grid`."""
