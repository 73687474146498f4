"""Decision types of the scale decision: status codes, per-group inputs, result.

Copied from the JAX package's ``core/semantics.py``; the integer values of
:class:`DecisionStatus` are the same, so decisions from either package compare
equal. The golden evaluator stays with the JAX package, which the tests hold
this port against.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

# Go's math.MaxFloat64 — used as the scale-up-from-zero sentinel
# (reference: pkg/controller/util.go:71-73).
MAX_FLOAT64 = 1.7976931348623157e308

# Scale-up deltas are clamped to int32 range (the executor re-clamps to
# max_nodes anyway; only inputs describing >2^31 nodes could ever notice).
MAX_DELTA = 2**31 - 1


class DecisionStatus(enum.IntEnum):
    """Terminal state of one nodegroup evaluation. Mirrors the control-flow exits of
    scaleNodeGroup (reference: pkg/controller/controller.go:192-397)."""

    OK = 0                    # normal path: nodes_delta holds the decision
    NOOP_EMPTY = 1            # 0 nodes and 0 pods -> do nothing (controller.go:233-236)
    ERR_BELOW_MIN = 2         # node count < min (controller.go:238-246)
    ERR_ABOVE_MAX = 3         # node count > max (controller.go:247-255)
    FORCED_MIN_SCALE_UP = 4   # untainted < min -> immediate scale up (controller.go:281-294)
    LOCKED = 5                # scale lock held -> return requested nodes (controller.go:317-323)
    ERR_DIV_ZERO = 6          # zero capacity with >0 untainted nodes (util.go:75)
    ERR_NEG_DELTA = 7         # negative scale-up delta (util.go:42-44)


@dataclass
class GroupConfig:
    """Per-nodegroup decision inputs that come from configuration.
    Mirrors the fields of NodeGroupOptions the decision math reads
    (reference: pkg/controller/node_group.go:20-52)."""

    min_nodes: int = 0
    max_nodes: int = 0
    taint_lower_percent: int = 0
    taint_upper_percent: int = 0
    scale_up_percent: int = 0
    slow_removal_rate: int = 0
    fast_removal_rate: int = 0
    soft_delete_grace_sec: int = 0
    hard_delete_grace_sec: int = 0
    #: scale-down victim ordering: "oldest_first" (reference behavior,
    #: sort.go:12-24) or "emptiest_first" (fewest non-daemonset pods first,
    #: ties oldest-first)
    scale_down_selection: str = "oldest_first"
    #: replace the average-based scale-up delta with a first-fit-decreasing
    #: packing count (not yet ported: the backend refuses such groups)
    packing_aware: bool = False
    #: max virtual new nodes the packing pass may propose per tick
    packing_budget: int = 128


@dataclass
class GroupState:
    """Cross-tick mutable state the decision reads.
    Mirrors NodeGroupState (reference: pkg/controller/controller.go:28-44)."""

    locked: bool = False
    requested_nodes: int = 0
    cached_cpu_milli: int = 0     # cached per-node cpu allocatable (controller.go:208-211)
    cached_mem_bytes: int = 0


@dataclass
class Decision:
    status: DecisionStatus
    nodes_delta: int = 0          # the value scaleNodeGroup would compute (pre-execution)
    cpu_percent: float = 0.0
    mem_percent: float = 0.0
    # Aggregates, for metrics parity (controller.go:275-278)
    cpu_request_milli: int = 0
    mem_request_bytes: int = 0
    cpu_capacity_milli: int = 0
    mem_capacity_bytes: int = 0
    num_untainted: int = 0
    num_tainted: int = 0
    num_cordoned: int = 0
    num_nodes: int = 0
    num_pods: int = 0
