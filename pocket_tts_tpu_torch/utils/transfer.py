"""Host-to-device copies that do not wait for the device.

A copy from pageable host memory to the card first synchronises with the
stream, so a small index or noise tensor uploaded that way stalls the host
until every queued kernel has run. Staged through pinned memory with
non_blocking=True the copy is queued like a kernel (PyTorch's pinned-memory
allocator keeps the staging buffer alive until the copy has run).
"""

from __future__ import annotations

import torch


def host_to_device(t: torch.Tensor, device) -> torch.Tensor:
    """`t` (a CPU tensor) on `device`, queued without a host sync on a card."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
