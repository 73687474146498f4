"""Dense structure-of-arrays cluster state — the host<->device boundary.

Copied from the JAX package's ``core/arrays.py``. The packer walks the
per-group object lists once per tick and builds flat numpy arrays on the host:

- pods:  flat ``[P]`` arrays tagged with a group id;
- nodes: flat ``[N]`` arrays tagged with a group id plus taint/cordon/no-delete
  flags and creation/taint timestamps;
- groups: ``[G]`` config+state vectors.

Pods and nodes are laid out group-contiguously (group 0's lanes first), the
layout the segment-sum kernel's warp merge relies on for speed (not for
correctness). Padding entries carry ``valid=False``. :func:`to_device` then
moves every array to the device in one place.

All quantities are int64 (cpu milli-cores, memory bytes, unix nanoseconds).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from escalator_tpu_torch.core import semantics
from escalator_tpu_torch.k8s import types as k8s

#: Sentinel for "no taint timestamp" in node_taint_time_sec.
NO_TAINT_TIME = np.int64(-(2**62))


@dataclass
class GroupArrays:
    """Per-nodegroup config + cross-tick state, ``[G]``-shaped."""

    min_nodes: np.ndarray          # int32
    max_nodes: np.ndarray          # int32
    taint_lower: np.ndarray        # int32
    taint_upper: np.ndarray        # int32
    scale_up_thr: np.ndarray       # int32
    slow_rate: np.ndarray          # int32
    fast_rate: np.ndarray          # int32
    locked: np.ndarray             # bool
    requested_nodes: np.ndarray    # int32
    cached_cpu_milli: np.ndarray   # int64
    cached_mem_bytes: np.ndarray   # int64
    soft_grace_sec: np.ndarray     # int64
    hard_grace_sec: np.ndarray     # int64
    emptiest: np.ndarray           # bool: scale_down_selection == emptiest_first
    valid: np.ndarray              # bool


@dataclass
class PodArrays:
    """Flat pod state, ``[P]``-shaped. Pods are pre-filtered per group the way the
    reference's filtered listers are (pkg/controller/node_group.go:218-275)."""

    group: np.ndarray        # int32
    cpu_milli: np.ndarray    # int64 (computed pod resource request)
    mem_bytes: np.ndarray    # int64
    node: np.ndarray         # int32 global node index, -1 if unscheduled/unknown
    valid: np.ndarray        # bool


@dataclass
class NodeArrays:
    """Flat node state, ``[N]``-shaped."""

    group: np.ndarray           # int32
    cpu_milli: np.ndarray       # int64 allocatable
    mem_bytes: np.ndarray       # int64 allocatable
    creation_ns: np.ndarray     # int64
    tainted: np.ndarray         # bool (dry-mode packing maps the taint tracker here)
    cordoned: np.ndarray        # bool
    no_delete: np.ndarray       # bool (atlassian.com/no-delete annotation non-empty)
    taint_time_sec: np.ndarray  # int64, NO_TAINT_TIME if absent/unparseable
    valid: np.ndarray           # bool


@dataclass
class ClusterArrays:
    """The packed cluster: numpy arrays from the packer, tensors after
    :func:`to_device` (same field names and dtypes either way)."""

    groups: GroupArrays
    pods: PodArrays
    nodes: NodeArrays


def _pad_to(n: int, pad: Optional[int]) -> int:
    if pad is None:
        return max(n, 1)
    if pad < n:
        raise ValueError(f"padded capacity {pad} < actual size {n}")
    return max(pad, 1)


def pack_groups(
    config_states: Sequence[Tuple[semantics.GroupConfig, semantics.GroupState]],
    pad_groups: Optional[int] = None,
) -> GroupArrays:
    """[G] group config+state vectors (GroupConfig/GroupState -> GroupArrays)."""
    G = len(config_states)
    GP = _pad_to(G, pad_groups)
    g = GroupArrays(
        min_nodes=np.zeros(GP, np.int32),
        max_nodes=np.zeros(GP, np.int32),
        taint_lower=np.zeros(GP, np.int32),
        taint_upper=np.zeros(GP, np.int32),
        scale_up_thr=np.ones(GP, np.int32),  # avoid /0 on padding lanes
        slow_rate=np.zeros(GP, np.int32),
        fast_rate=np.zeros(GP, np.int32),
        locked=np.zeros(GP, bool),
        requested_nodes=np.zeros(GP, np.int32),
        cached_cpu_milli=np.zeros(GP, np.int64),
        cached_mem_bytes=np.zeros(GP, np.int64),
        soft_grace_sec=np.zeros(GP, np.int64),
        hard_grace_sec=np.zeros(GP, np.int64),
        emptiest=np.zeros(GP, bool),
        valid=np.zeros(GP, bool),
    )
    for gi, (config, state) in enumerate(config_states):
        g.min_nodes[gi] = config.min_nodes
        g.max_nodes[gi] = config.max_nodes
        g.taint_lower[gi] = config.taint_lower_percent
        g.taint_upper[gi] = config.taint_upper_percent
        g.scale_up_thr[gi] = config.scale_up_percent
        g.slow_rate[gi] = config.slow_removal_rate
        g.fast_rate[gi] = config.fast_removal_rate
        g.locked[gi] = state.locked
        g.requested_nodes[gi] = state.requested_nodes
        g.cached_cpu_milli[gi] = state.cached_cpu_milli
        g.cached_mem_bytes[gi] = state.cached_mem_bytes
        g.soft_grace_sec[gi] = config.soft_delete_grace_sec
        g.hard_grace_sec[gi] = config.hard_delete_grace_sec
        g.emptiest[gi] = config.scale_down_selection == "emptiest_first"
        g.valid[gi] = True
    return g


def pack_cluster(
    group_inputs,
    dry_mode_flags: Optional[Sequence[bool]] = None,
    taint_trackers: Optional[Sequence[Sequence[str]]] = None,
    pad_pods: Optional[int] = None,
    pad_nodes: Optional[int] = None,
    pad_groups: Optional[int] = None,
) -> ClusterArrays:
    """Pack per-group ``(pods, nodes, config, state)`` into dense numpy arrays.

    Also refreshes each group's cached node capacity from its first listed node, the
    way scaleNodeGroup does before computing (reference: controller.go:208-211) — that
    cross-tick cache stays host-side state, mutated here.

    In dry mode for a group, taint/cordon flags take the reference's dry-mode view:
    membership of the in-memory taint tracker defines "tainted" and nothing is treated
    as cordoned (reference: controller.go:126-138).
    """
    total_pods = sum(len(p) for p, *_ in group_inputs)
    total_nodes = sum(len(n) for _, n, *_ in group_inputs)
    P = _pad_to(total_pods, pad_pods)
    N = _pad_to(total_nodes, pad_nodes)

    # refresh cached capacity BEFORE packing group rows (controller.go:208-211)
    for _pods, nodes, _config, state in group_inputs:
        if nodes:
            state.cached_cpu_milli = nodes[0].cpu_allocatable_milli
            state.cached_mem_bytes = nodes[0].mem_allocatable_bytes

    g = pack_groups(
        [(config, state) for _, _, config, state in group_inputs], pad_groups
    )
    p = PodArrays(
        group=np.zeros(P, np.int32),
        cpu_milli=np.zeros(P, np.int64),
        mem_bytes=np.zeros(P, np.int64),
        node=np.full(P, -1, np.int32),
        valid=np.zeros(P, bool),
    )
    n = NodeArrays(
        group=np.zeros(N, np.int32),
        cpu_milli=np.zeros(N, np.int64),
        mem_bytes=np.zeros(N, np.int64),
        creation_ns=np.zeros(N, np.int64),
        tainted=np.zeros(N, bool),
        cordoned=np.zeros(N, bool),
        no_delete=np.zeros(N, bool),
        taint_time_sec=np.full(N, NO_TAINT_TIME, np.int64),
        valid=np.zeros(N, bool),
    )

    pi = 0
    ni = 0
    for gi, (pods, nodes, _config, _state) in enumerate(group_inputs):
        dry = bool(dry_mode_flags[gi]) if dry_mode_flags is not None else False
        tracker = set(taint_trackers[gi]) if taint_trackers is not None else set()

        node_index = {}
        for node in nodes:
            n.group[ni] = gi
            n.cpu_milli[ni] = node.cpu_allocatable_milli
            n.mem_bytes[ni] = node.mem_allocatable_bytes
            n.creation_ns[ni] = node.creation_time_ns
            taint = k8s.get_to_be_removed_taint(node)
            if dry:
                n.tainted[ni] = node.name in tracker
                n.cordoned[ni] = False
            else:
                n.tainted[ni] = taint is not None
                n.cordoned[ni] = node.unschedulable
            n.no_delete[ni] = bool(
                node.annotations.get(k8s.NODE_ESCALATOR_IGNORE_ANNOTATION)
            )
            if taint is not None:
                try:
                    n.taint_time_sec[ni] = int(taint.value)
                except ValueError:
                    pass
            n.valid[ni] = True
            node_index[node.name] = ni
            ni += 1

        for pod in pods:
            req = k8s.compute_pod_resource_request(pod)
            p.group[pi] = gi
            p.cpu_milli[pi] = req.cpu_milli
            p.mem_bytes[pi] = req.mem_bytes
            p.node[pi] = node_index.get(pod.node_name, -1)
            p.valid[pi] = True
            pi += 1

    return ClusterArrays(groups=g, pods=p, nodes=n)


def _section_to_device(section, device: torch.device):
    return type(section)(**{
        f.name: torch.from_numpy(np.ascontiguousarray(getattr(section, f.name))).to(device)
        for f in fields(section)
    })


def to_device(cluster: ClusterArrays, device: torch.device) -> ClusterArrays:
    """The packed numpy cluster as tensors on ``device`` (dtypes unchanged)."""
    return ClusterArrays(
        groups=_section_to_device(cluster.groups, device),
        pods=_section_to_device(cluster.pods, device),
        nodes=_section_to_device(cluster.nodes, device),
    )
