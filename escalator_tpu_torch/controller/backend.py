"""The compute backend: where the scale decision runs, once per controller tick.

The port of ``escalator_tpu/controller/backend.py``'s ``JaxBackend`` (:576).
The controller calls ``decide(group_inputs, now_sec, ...)`` with each group's
pods, nodes, config and state, and gets back one :class:`GroupDecision` per
group: the decision plus the object-level node selections its executors walk.
Pod and node objects are read by attribute, so any objects with the k8s
model's attribute names work.

One tick of :class:`TorchBackend`: pack the objects into numpy arrays on the
host (high-water power-of-two padding), move them to the device, run the
lazy-orders decide (:func:`escalator_tpu_torch.ops.kernel.lazy_orders_decide`),
and unpack the result into objects.
"""

from __future__ import annotations

import abc
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from escalator_tpu_torch.core import semantics
from escalator_tpu_torch.core.arrays import pack_cluster, to_device
from escalator_tpu_torch.device import DeviceLike, resolve_device, synchronize
from escalator_tpu_torch.ops import kernel


@dataclass
class GroupDecision:
    """Backend output for one nodegroup, at object level."""

    decision: semantics.Decision
    #: untainted nodes in victim order (per the group's scale_down_selection:
    #: oldest-first by default, emptiest-first when configured)
    scale_down_order: List = field(default_factory=list)
    untaint_order: List = field(default_factory=list)     # newest-first
    reap_nodes: List = field(default_factory=list)
    cordoned_nodes: List = field(default_factory=list)
    node_pods_remaining: Dict[str, int] = field(default_factory=dict)


class ComputeBackend(abc.ABC):
    name = "abstract"
    #: the controller reads this to decide whether to list pods and nodes for
    #: the backend (escalator_tpu/controller/controller.py, which drives this
    #: backend in tests/test_torch_backend.py); every backend of the port
    #: takes objects
    needs_objects = True

    @abc.abstractmethod
    def decide(
        self,
        group_inputs,
        now_sec: int,
        dry_mode_flags: Optional[Sequence[bool]] = None,
        taint_trackers: Optional[Sequence[Sequence[str]]] = None,
    ) -> List[GroupDecision]:
        ...


def _round_up(n: int, minimum: int = 64) -> int:
    """Next power of two >= n (>= minimum): keeps shapes stable as the cluster
    grows and shrinks."""
    size = max(n, minimum)
    return 1 << (size - 1).bit_length()


class PaddedPacker:
    """pack_cluster with high-water-mark power-of-two padding."""

    def __init__(self):
        self._pad_pods = 0
        self._pad_nodes = 0
        self._pad_groups = 0

    def pack(self, group_inputs, dry_mode_flags=None, taint_trackers=None):
        total_pods = sum(len(p) for p, *_ in group_inputs)
        total_nodes = sum(len(n) for _, n, *_ in group_inputs)
        self._pad_pods = max(self._pad_pods, _round_up(total_pods))
        self._pad_nodes = max(self._pad_nodes, _round_up(total_nodes))
        self._pad_groups = max(self._pad_groups, _round_up(len(group_inputs), 8))
        return pack_cluster(
            group_inputs,
            dry_mode_flags=dry_mode_flags,
            taint_trackers=taint_trackers,
            pad_pods=self._pad_pods,
            pad_nodes=self._pad_nodes,
            pad_groups=self._pad_groups,
        )


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _unpack(out, group_inputs, ordered: bool, nodes) -> List[GroupDecision]:
    """Decide output -> GroupDecision per group.

    ``nodes`` is the packed numpy ``NodeArrays`` the decide saw (carrying the
    dry-mode taint view). ``ordered=False`` means the decide ran the light
    program: the order permutations are placeholders and, by the lazy-orders
    gate, no ordering consumer exists (no tainted nodes, no negative delta).
    The candidate lists are then filled as unordered membership from
    ``nodes``. reap_nodes and node_pods_remaining come from flat outputs and
    are exact either way."""
    flat_nodes: List = []
    for _, group_nodes, _, _ in group_inputs:
        flat_nodes.extend(group_nodes)

    status = _np(out.status)
    delta = _np(out.nodes_delta)
    cpu_pct = _np(out.cpu_percent)
    mem_pct = _np(out.mem_percent)
    cpu_req = _np(out.cpu_request_milli)
    mem_req = _np(out.mem_request_bytes)
    cpu_cap = _np(out.cpu_capacity_milli)
    mem_cap = _np(out.mem_capacity_bytes)
    n_unt = _np(out.num_untainted)
    n_tnt = _np(out.num_tainted)
    n_crd = _np(out.num_cordoned)
    n_all = _np(out.num_nodes)
    n_pods = _np(out.num_pods)
    if ordered:
        down = _np(out.scale_down_order)
        up = _np(out.untaint_order)
        u_off = _np(out.untainted_offsets)
        t_off = _np(out.tainted_offsets)
    else:
        untainted_mask = nodes.valid & ~nodes.tainted & ~nodes.cordoned
        tainted_mask = nodes.valid & nodes.tainted & ~nodes.cordoned
    reap = _np(out.reap_mask)
    remaining = _np(out.node_pods_remaining)

    results: List[GroupDecision] = []
    for gi in range(len(group_inputs)):
        decision = semantics.Decision(
            status=semantics.DecisionStatus(int(status[gi])),
            nodes_delta=int(delta[gi]),
            cpu_percent=float(cpu_pct[gi]),
            mem_percent=float(mem_pct[gi]),
            cpu_request_milli=int(cpu_req[gi]),
            mem_request_bytes=int(mem_req[gi]),
            cpu_capacity_milli=int(cpu_cap[gi]),
            mem_capacity_bytes=int(mem_cap[gi]),
            num_untainted=int(n_unt[gi]),
            num_tainted=int(n_tnt[gi]),
            num_cordoned=int(n_crd[gi]),
            num_nodes=int(n_all[gi]),
            num_pods=int(n_pods[gi]),
        )
        if ordered:
            down_nodes = [flat_nodes[i] for i in down[u_off[gi]: u_off[gi + 1]]]
            up_nodes = [flat_nodes[i] for i in up[t_off[gi]: t_off[gi + 1]]]
        else:
            down_nodes, up_nodes = [], []
        results.append(GroupDecision(
            decision=decision, scale_down_order=down_nodes, untaint_order=up_nodes,
        ))
    # the packer lays each group's nodes out as one contiguous range
    base = 0
    for gi, (_pods, group_nodes, _config, _state) in enumerate(group_inputs):
        idxs = range(base, base + len(group_nodes))
        if not ordered:
            results[gi].scale_down_order = [flat_nodes[i] for i in idxs if untainted_mask[i]]
            results[gi].untaint_order = [flat_nodes[i] for i in idxs if tainted_mask[i]]
        results[gi].reap_nodes = [flat_nodes[i] for i in idxs if reap[i]]
        results[gi].node_pods_remaining = {
            flat_nodes[i].name: int(remaining[i]) for i in idxs
        }
        base += len(group_nodes)
    return results


def _lazy_decide(nodes, dispatch):
    """The lazy-orders gate: ``nodes`` is the packed host-side node section
    (the decided snapshot, dry-mode taint view included) and
    ``dispatch(with_orders)`` runs one decide. Returns ``(out, ordered)``."""
    tainted_any = bool((nodes.valid & nodes.tainted).any())
    return kernel.lazy_orders_decide(dispatch, tainted_any)


class TorchBackend(ComputeBackend):
    """The batched decide on one device: ``cuda:0`` by default (raises without
    CUDA), or the device named, such as ``"cpu"`` for the plain versions.

    After each :meth:`decide`, ``last_out``/``last_ordered`` hold the decide's
    arrays and whether it ran the ordered program, and ``phase_seconds`` the
    host-clock time of each phase (``pack``, ``to_device``, ``decide``,
    ``unpack``); the decide phase ends with a device synchronize."""

    name = "torch"

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._packer = PaddedPacker()
        self.last_out: Optional[kernel.DecisionArrays] = None
        self.last_ordered: Optional[bool] = None
        self.phase_seconds: Dict[str, float] = {}

    def decide(self, group_inputs, now_sec, dry_mode_flags=None, taint_trackers=None):
        for _pods, _nodes, config, _state in group_inputs:
            if getattr(config, "packing_aware", False):
                raise NotImplementedError(
                    "packing_aware groups need the first-fit-decreasing packing "
                    "pass (escalator_tpu/ops/binpack.py), which the port does not "
                    "have yet: it comes with the binpack slice"
                )
        t0 = time.perf_counter()
        host = self._packer.pack(group_inputs, dry_mode_flags, taint_trackers)
        t1 = time.perf_counter()
        cluster = to_device(host, self.device)
        synchronize(self.device)
        t2 = time.perf_counter()
        out, ordered = _lazy_decide(
            host.nodes, lambda w: kernel.decide(cluster, now_sec, with_orders=w))
        synchronize(self.device)
        t3 = time.perf_counter()
        results = _unpack(out, group_inputs, ordered, host.nodes)
        t4 = time.perf_counter()
        self.last_out, self.last_ordered = out, ordered
        self.phase_seconds = {
            "pack": t1 - t0, "to_device": t2 - t1, "decide": t3 - t2, "unpack": t4 - t3,
        }
        return results


_BACKENDS = {"torch": TorchBackend}


def make_backend(kind: str = "torch", device: DeviceLike = None) -> ComputeBackend:
    """Construct a backend by name (the port has one: ``"torch"``)."""
    if kind not in _BACKENDS:
        raise ValueError(f"unknown backend {kind!r}; known: {sorted(_BACKENDS)}")
    return _BACKENDS[kind](device=device)
