"""Device choice and dtype policy for the port.

Entry points run on ``cuda:0`` unless the caller names another device (the
tests pass ``device="cpu"``, which runs every kernel's plain version). With no
device named and no CUDA present, :func:`resolve_device` raises: the port never
carries on quietly on the host.

Dtype policy: every integer quantity (cpu milli-cores, memory bytes,
nanoseconds, sums) is int64 and every percent is float64. Every float literal
that meets a tensor is a float64 tensor: a Python float meeting an integer
tensor would promote to torch's default float32 and break bit-parity with the
reference's Go float64 math. Integer literals meet only integer tensors,
whose dtype they keep.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

I32 = torch.int32
I64 = torch.int64
F64 = torch.float64

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda:0`` when ``device`` is None (raises without CUDA), else ``device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the plain "
                "versions of the kernels on the host"
            )
        return torch.device("cuda", 0)
    return torch.device(device)


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
