"""The slice of the Kubernetes object model that the packer reads.

Copied from the JAX package's ``k8s/types.py``. CPU is carried in milli-cores
and memory in bytes (reference: pkg/k8s/resource/quantity.go:7-17). The
functions here read objects by attribute only, so any object with the same
attribute names packs (the JAX package's ``Pod``/``Node`` among them).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

# Taint key the autoscaler uses to mark nodes for removal
# (reference: pkg/k8s/taint.go:29-32).
TO_BE_REMOVED_BY_AUTOSCALER_KEY = "atlassian.com/escalator"

# Annotation marking a node as never-delete (reference: pkg/controller/scale_down.go:15-20).
NODE_ESCALATOR_IGNORE_ANNOTATION = "atlassian.com/no-delete"


@dataclass
class Taint:
    key: str
    value: str = ""
    effect: str = "NoSchedule"


@dataclass
class ResourceRequests:
    """Per-container resource requests. cpu in milli-cores, memory in bytes."""

    cpu_milli: int = 0
    mem_bytes: int = 0


@dataclass
class Pod:
    name: str
    namespace: str = "default"
    node_name: str = ""  # "" = pending / unscheduled
    containers: List[ResourceRequests] = field(default_factory=list)
    init_containers: List[ResourceRequests] = field(default_factory=list)
    overhead: Optional[ResourceRequests] = None
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[object] = None
    owner_kind: str = ""  # e.g. "DaemonSet", "ReplicaSet"
    annotations: Dict[str, str] = field(default_factory=dict)
    phase: str = "Running"


@dataclass
class Node:
    name: str
    creation_time_ns: int = 0  # unix nanoseconds
    cpu_allocatable_milli: int = 0
    mem_allocatable_bytes: int = 0
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    unschedulable: bool = False  # cordoned
    provider_id: str = ""


def pod_is_daemonset(pod) -> bool:
    """Reference: pkg/k8s/util.go:11-18."""
    return pod.owner_kind == "DaemonSet"


def compute_pod_resource_request(pod) -> ResourceRequests:
    """Sum container requests, take elementwise max vs each init container, add
    overhead (reference: pkg/k8s/scheduler/types.go:72-89)."""
    cpu = 0
    mem = 0
    for c in pod.containers:
        cpu += c.cpu_milli
        mem += c.mem_bytes
    for ic in pod.init_containers:
        cpu = max(cpu, ic.cpu_milli)
        mem = max(mem, ic.mem_bytes)
    if pod.overhead is not None:
        cpu += pod.overhead.cpu_milli
        mem += pod.overhead.mem_bytes
    return ResourceRequests(cpu_milli=cpu, mem_bytes=mem)


def get_to_be_removed_taint(node):
    """The autoscaler's taint on ``node``, or None (reference: pkg/k8s/taint.go:78-88)."""
    for taint in node.taints:
        if taint.key == TO_BE_REMOVED_BY_AUTOSCALER_KEY:
            return taint
    return None
