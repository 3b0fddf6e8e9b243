"""Datasets, roidb preparation and the training loader (counterpart of
`tpudenoise/data`)."""
