"""Training (counterpart of `tpudenoise/train`): target layers, losses, the
train step and the solver."""
