"""Datasets for evaluation (an eval-only copy of `tpudenoise/data`)."""
