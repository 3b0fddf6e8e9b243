"""Host arrays to a device without waiting on it."""

from __future__ import annotations

import numpy as np
import torch


def to_device(a, device) -> torch.Tensor:
    """A host array (numpy or CPU tensor) on `device`.  To a GPU it goes
    through pinned memory with a non-blocking copy, so the host does not
    wait for the device (a pageable copy synchronizes); the caching host
    allocator keeps the staging buffer until the copy has run."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    if torch.device(device).type == 'cuda':
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
