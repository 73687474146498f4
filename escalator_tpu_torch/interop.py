"""Carrying state across between numpy and the port.

:func:`cluster_from_numpy` takes any packed cluster whose sections (``groups``,
``pods``, ``nodes``) hold numpy arrays under the port's field names — the JAX
package's ``ClusterArrays`` among them, read by field name with no import —
and returns the port's cluster on a device. :func:`decision_to_numpy` brings a
decide's output back as numpy arrays keyed by field name.
"""

from __future__ import annotations

from dataclasses import fields
from typing import Dict

import numpy as np

from escalator_tpu_torch.core.arrays import (
    ClusterArrays, GroupArrays, NodeArrays, PodArrays, to_device,
)
from escalator_tpu_torch.device import DeviceLike, resolve_device
from escalator_tpu_torch.ops.kernel import DecisionArrays


def _section(cls, src):
    return cls(**{f.name: np.asarray(getattr(src, f.name)) for f in fields(cls)})


def cluster_from_numpy(c, device: DeviceLike = None) -> ClusterArrays:
    """The port's cluster, as tensors on ``device`` (``cuda:0`` when None)."""
    device = resolve_device(device)
    host = ClusterArrays(
        groups=_section(GroupArrays, c.groups),
        pods=_section(PodArrays, c.pods),
        nodes=_section(NodeArrays, c.nodes),
    )
    return to_device(host, device)


def decision_to_numpy(out: DecisionArrays) -> Dict[str, np.ndarray]:
    """Every ``DecisionArrays`` field as a numpy array, keyed by field name."""
    return {f.name: getattr(out, f.name).cpu().numpy() for f in fields(DecisionArrays)}
