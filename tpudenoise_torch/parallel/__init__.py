"""Data and spatial parallelism over `torch.distributed` ranks."""
