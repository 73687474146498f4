"""Batched scale decision for all nodegroups at once, on tensors.

The port of ``escalator_tpu/ops/kernel.py``'s ``decide`` (:750). One call:

- sums the pod requests per group, and the pods per node, and the node
  capacities and partition counts per group, in one launch of the CUDA
  segment-sum kernel (:func:`escalator_tpu_torch.ops.segsum.decide_sweeps`;
  its plain version on the CPU);
- runs the float64 decision math over the ``[G]`` groups, bit-matching
  calcPercentUsage (reference: pkg/controller/util.go:58-81), calcScaleUpDelta
  (util.go:13-46) and the status exits of scaleNodeGroup (controller.go:192-397);
- sorts the nodes once for both the scale-down and the untaint orders
  (:mod:`escalator_tpu_torch.ops.order_tail`), unless ``with_orders=False``;
- builds the reaper eligibility mask (scale_down.go:51-99).

Every op runs eagerly, one rounding per op, in the reference's order. Literals
that meet a float64 tensor are float64 tensors themselves, so nothing promotes
to float32, and float-to-int casts are clamped first. The decide reads one
number back from the device, at its end: the segment-sum launch's count of
out-of-range ids (:func:`escalator_tpu_torch.ops.segsum.check_bad_ids`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import torch

from escalator_tpu_torch.core.arrays import (
    NO_TAINT_TIME, ClusterArrays, GroupArrays, NodeArrays, PodArrays,
)
from escalator_tpu_torch.core.semantics import MAX_DELTA, MAX_FLOAT64, DecisionStatus
from escalator_tpu_torch.device import F64, I32, I64
from escalator_tpu_torch.ops import segsum
from escalator_tpu_torch.ops.order_tail import combined_order_sort, node_selection_masks


@dataclass
class DecisionArrays:
    """Decide outputs. ``[G]`` per-group decisions + ``[N]`` per-node selections."""

    status: torch.Tensor            # int32 [G] DecisionStatus codes
    nodes_delta: torch.Tensor       # int32 [G] the scaleNodeGroup decision value
    cpu_percent: torch.Tensor       # float64 [G]
    mem_percent: torch.Tensor       # float64 [G]
    cpu_request_milli: torch.Tensor   # int64 [G]
    mem_request_bytes: torch.Tensor   # int64 [G]
    cpu_capacity_milli: torch.Tensor  # int64 [G]
    mem_capacity_bytes: torch.Tensor  # int64 [G]
    num_pods: torch.Tensor          # int32 [G]
    num_nodes: torch.Tensor         # int32 [G]
    num_untainted: torch.Tensor     # int32 [G]
    num_tainted: torch.Tensor       # int32 [G]
    num_cordoned: torch.Tensor      # int32 [G]
    # Node selections (global node indices):
    # scale-down victims: untainted nodes ordered (group asc, creation asc); group g's
    # victims occupy slots [untainted_offsets[g], untainted_offsets[g+1]).
    scale_down_order: torch.Tensor   # int32 [N]
    untainted_offsets: torch.Tensor  # int32 [G+1]
    # untaint candidates: tainted nodes ordered (group asc, creation desc)
    untaint_order: torch.Tensor      # int32 [N]
    tainted_offsets: torch.Tensor    # int32 [G+1]
    reap_mask: torch.Tensor          # bool [N] eligible for deletion this tick
    node_pods_remaining: torch.Tensor  # int32 [N] non-daemonset pods per node


#: The [G] DecisionArrays columns (everything except the per-node selections).
GROUP_DECISION_FIELDS = (
    "status", "nodes_delta", "cpu_percent", "mem_percent",
    "cpu_request_milli", "mem_request_bytes",
    "cpu_capacity_milli", "mem_capacity_bytes",
    "num_pods", "num_nodes", "num_untainted", "num_tainted", "num_cordoned",
)


def _const(value, dtype, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of ``dtype`` on ``like``'s device."""
    return torch.full((), value, dtype=dtype, device=like.device)


def node_pods_remaining_sweep(p: PodArrays, node_group: torch.Tensor, N: int,
                              bad_ids=None):
    """Per-node count of same-group pods. Returns int64 ``[N]``. ``bad_ids``
    as in :func:`escalator_tpu_torch.ops.segsum.fused_segment_sums`."""
    return segsum.fused_segment_sums(
        *segsum.node_pods_sweep_inputs(p, node_group, N), num_segments=N, bad_ids=bad_ids,
    )["node_pods_remaining"]


def aggregate_pods(p: PodArrays, node_group: torch.Tensor, G: int, N: int,
                   bad_ids=None):
    """Per-group pod-request sums + per-node pod counts — the O(P) sweeps.
    Returns (cpu_req[G] i64, mem_req[G] i64, num_pods[G] i64,
    node_pods_remaining[N] i64)."""
    sums = segsum.fused_segment_sums(*segsum.pod_sweep_inputs(p), num_segments=G,
                                     bad_ids=bad_ids)
    return (sums["cpu_req"], sums["mem_req"], sums["num_pods"],
            node_pods_remaining_sweep(p, node_group, N, bad_ids))


def aggregate_nodes(n: NodeArrays, G: int, bad_ids=None):
    """Per-group node capacity sums and partition counts — the O(N) sweep.
    Returns (cpu_cap, mem_cap, num_nodes, num_untainted, num_tainted,
    num_cordoned), each int64 [G]."""
    sums = segsum.fused_segment_sums(*segsum.node_sweep_inputs(n), num_segments=G,
                                     bad_ids=bad_ids)
    return (sums["cpu_cap"], sums["mem_cap"], sums["num_nodes"],
            sums["num_untainted"], sums["num_tainted"], sums["num_cordoned"])


def group_decision_terms(g: GroupArrays, cpu_req, mem_req, cpu_cap, mem_cap,
                         num_pods, num_nodes, num_untainted):
    """The per-group decision calculus with every intermediate named (the
    same keys as the JAX package's ``group_decision_terms``)."""
    zero64 = _const(0, I64, cpu_req)
    one64 = _const(1, I64, cpu_req)
    zero_f = _const(0.0, F64, cpu_req)
    one_f = _const(1.0, F64, cpu_req)
    hundred = _const(100.0, F64, cpu_req)
    max_f = _const(MAX_FLOAT64, F64, cpu_req)

    # ---- percent usage (pkg/controller/util.go:58-81) ----
    # Memory percent uses MilliValue (= bytes*1000) in the reference; replicate the
    # exact int64->float64 conversion order for bit-parity (int64 wraps alike).
    mem_req_milli = mem_req * 1000
    mem_cap_milli = mem_cap * 1000
    all_zero = (
        (cpu_req == 0) & (mem_req_milli == 0) & (cpu_cap == 0) & (mem_cap_milli == 0)
        & (num_untainted == 0)
    )
    zero_cap = (cpu_cap == 0) | (mem_cap_milli == 0)
    from_zero = zero_cap & (num_untainted == 0) & ~all_zero
    div_zero = zero_cap & (num_untainted > 0) & ~all_zero

    safe_cpu_cap = torch.where(cpu_cap == 0, one64, cpu_cap).to(F64)
    safe_mem_cap = torch.where(mem_cap_milli == 0, one64, mem_cap_milli).to(F64)
    cpu_pct = torch.where(
        all_zero | div_zero,
        zero_f,
        torch.where(from_zero, max_f, cpu_req.to(F64) / safe_cpu_cap * hundred),
    )
    mem_pct = torch.where(
        all_zero | div_zero,
        zero_f,
        torch.where(from_zero, max_f, mem_req_milli.to(F64) / safe_mem_cap * hundred),
    )

    # ---- scale-up delta (pkg/controller/util.go:13-46) ----
    # A non-positive threshold is invalid config (node_group.go:96); it becomes
    # ERR_NEG_DELTA rather than a NaN-derived delta.
    bad_thr = g.scale_up_thr <= 0
    thr = torch.where(bad_thr, torch.ones_like(g.scale_up_thr), g.scale_up_thr).to(F64)
    cached_cpu = g.cached_cpu_milli
    cached_mem_milli = g.cached_mem_bytes * 1000
    no_cache = (cached_cpu == 0) | (cached_mem_milli == 0)
    safe_cached_cpu = torch.where(cached_cpu == 0, one64, cached_cpu).to(F64)
    safe_cached_mem = torch.where(cached_mem_milli == 0, one64, cached_mem_milli).to(F64)

    fz_cpu = torch.ceil(cpu_req.to(F64) / safe_cached_cpu / thr * hundred)
    fz_mem = torch.ceil(mem_req_milli.to(F64) / safe_cached_mem / thr * hundred)
    # Operation order matters for bit-parity: Go computes percentageNeeded first
    # (util.go:33-37), i.e. n * ((pct - thr) / thr), NOT (n * (pct - thr)) / thr.
    nrm_cpu = torch.ceil(num_untainted.to(F64) * ((cpu_pct - thr) / thr))
    nrm_mem = torch.ceil(num_untainted.to(F64) * ((mem_pct - thr) / thr))

    needed = torch.where(
        from_zero,
        torch.where(no_cache, one_f, torch.maximum(fz_cpu, fz_mem)),
        torch.maximum(nrm_cpu, nrm_mem),
    )
    # Go: delta := int(math.Max(...)) — truncation toward zero of an integral float.
    up_delta = torch.trunc(needed)
    neg_delta = (up_delta < 0) | bad_thr

    # ---- threshold switch (pkg/controller/controller.go:332-351) ----
    max_pct = torch.maximum(cpu_pct, mem_pct)
    down_fast = max_pct < g.taint_lower.to(F64)
    down_slow = ~down_fast & (max_pct < g.taint_upper.to(F64))
    scale_up = ~down_fast & ~down_slow & (max_pct > g.scale_up_thr.to(F64))

    # clamped to int32 range in float64 BEFORE the cast: a cast of an
    # out-of-range float to an integer is undefined and differs by device
    up_clamped = torch.clamp(
        up_delta,
        _const(-(MAX_DELTA + 1.0), F64, up_delta),
        _const(float(MAX_DELTA), F64, up_delta),
    ).to(I64)
    switch_delta = torch.where(
        down_fast,
        -g.fast_rate.to(I64),
        torch.where(
            down_slow,
            -g.slow_rate.to(I64),
            torch.where(scale_up, up_clamped, zero64),
        ),
    )

    # ---- status priority cascade (exit order of controller.go:192-397) ----
    empty = (num_nodes == 0) & (num_pods == 0)
    below_min = num_nodes < g.min_nodes
    above_max = num_nodes > g.max_nodes
    forced_min = num_untainted < g.min_nodes
    invalid = ~g.valid

    zero32 = torch.zeros_like(num_nodes)
    # (condition, status, nodes_delta) in priority order: the first true
    # condition wins, as in jnp.select
    arms = [
        (invalid | empty, DecisionStatus.NOOP_EMPTY, zero32),
        (below_min, DecisionStatus.ERR_BELOW_MIN, zero32),
        (above_max, DecisionStatus.ERR_ABOVE_MAX, zero32),
        (forced_min, DecisionStatus.FORCED_MIN_SCALE_UP,
         (g.min_nodes - num_untainted).to(I32)),
        (div_zero, DecisionStatus.ERR_DIV_ZERO, zero32),
        (g.locked, DecisionStatus.LOCKED, g.requested_nodes),
        (scale_up & neg_delta, DecisionStatus.ERR_NEG_DELTA, zero32),
    ]
    status = torch.full_like(num_nodes, int(DecisionStatus.OK))
    nodes_delta = switch_delta.to(I32)
    for cond, code, delta in reversed(arms):
        status = torch.where(cond, _const(int(code), I32, cond), status)
        nodes_delta = torch.where(cond, delta, nodes_delta)

    # Percent outputs: statuses that exit before the percent calc report 0.
    pct_computed = ~(invalid | empty | below_min | above_max | forced_min | div_zero)
    cpu_pct_out = torch.where(pct_computed, cpu_pct, zero_f)
    mem_pct_out = torch.where(pct_computed, mem_pct, zero_f)

    # Request/capacity sums: the reference exits on empty/below-min/above-max
    # BEFORE aggregating (controller.go:233-255 precede util.go:27-51), so
    # those groups report zero sums. (Counts stay: they come from the filter
    # pass, which runs before the bounds checks.)
    pre_agg_exit = invalid | empty | below_min | above_max
    cpu_req = torch.where(pre_agg_exit, zero64, cpu_req)
    mem_req = torch.where(pre_agg_exit, zero64, mem_req)
    cpu_cap = torch.where(pre_agg_exit, zero64, cpu_cap)
    mem_cap = torch.where(pre_agg_exit, zero64, mem_cap)

    return {
        # the 8 committed outputs (the masked sums carry the column names)
        "status": status,
        "nodes_delta": nodes_delta,
        "cpu_percent": cpu_pct_out,
        "mem_percent": mem_pct_out,
        "cpu_request_milli": cpu_req,
        "mem_request_bytes": mem_req,
        "cpu_capacity_milli": cpu_cap,
        "mem_capacity_bytes": mem_cap,
        # percent-usage terms (util.go:58-81)
        "cpu_percent_raw": cpu_pct,
        "mem_percent_raw": mem_pct,
        "max_percent": max_pct,
        # scale-up delta derivation (util.go:13-46)
        "from_zero_cpu_needed": fz_cpu,
        "from_zero_mem_needed": fz_mem,
        "percentage_needed_cpu": nrm_cpu,
        "percentage_needed_mem": nrm_mem,
        "nodes_needed": needed,
        "up_delta": up_delta,
        "switch_delta": switch_delta,
        # gates, in evaluation order
        "gate_all_zero": all_zero,
        "gate_from_zero": from_zero,
        "gate_div_zero": div_zero,
        "gate_no_cache": no_cache,
        "gate_bad_threshold": bad_thr,
        "gate_neg_delta": neg_delta,
        "gate_down_fast": down_fast,
        "gate_down_slow": down_slow,
        "gate_scale_up": scale_up,
        "gate_empty": empty,
        "gate_below_min": below_min,
        "gate_above_max": above_max,
        "gate_forced_min": forced_min,
        "gate_invalid": invalid,
        "gate_locked": g.locked,
        "gate_pct_computed": pct_computed,
        "gate_pre_agg_exit": pre_agg_exit,
    }


def group_decision_math(g: GroupArrays, cpu_req, mem_req, cpu_cap, mem_cap,
                        num_pods, num_nodes, num_untainted):
    """The per-group decision core as one elementwise function. ``cpu_req``/
    ``mem_req``/``cpu_cap``/``mem_cap`` are the int64 sums; counts are int32.
    Returns ``(status, nodes_delta, cpu_percent, mem_percent, cpu_req_masked,
    mem_req_masked, cpu_cap_masked, mem_cap_masked)``."""
    t = group_decision_terms(g, cpu_req, mem_req, cpu_cap, mem_cap,
                             num_pods, num_nodes, num_untainted)
    return (t["status"], t["nodes_delta"], t["cpu_percent"], t["mem_percent"],
            t["cpu_request_milli"], t["mem_request_bytes"],
            t["cpu_capacity_milli"], t["mem_capacity_bytes"])


def _node_offsets(counts: torch.Tensor) -> torch.Tensor:
    """Per-group window offsets ([G+1] int32) from a selection's per-group
    counts. The counts are the node sweep's own ``num_untainted`` /
    ``num_tainted`` sums, the same sums the JAX package takes a second time."""
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).to(I32)


def _reap_eligibility(n: NodeArrays, g: GroupArrays, ngroup, tainted_sel,
                      node_pods_remaining, now_sec):
    """Reaper mask (pkg/controller/scale_down.go:51-99), O(N) elementwise.
    ``node_pods_remaining`` is int32."""
    ngroup64 = ngroup.to(I64)
    has_tt = n.taint_time_sec != int(NO_TAINT_TIME)
    age = _const(int(now_sec), I64, n.taint_time_sec) - n.taint_time_sec
    return (
        tainted_sel
        & ~n.no_delete
        & has_tt
        & (age > g.soft_grace_sec[ngroup64])
        & ((node_pods_remaining == 0) | (age > g.hard_grace_sec[ngroup64]))
    )


def decide(cluster: ClusterArrays, now_sec: int, with_orders: bool = True) -> DecisionArrays:
    """Evaluate every nodegroup's scale decision on the cluster's device.

    ``cluster`` holds tensors (:func:`escalator_tpu_torch.core.arrays.to_device`).
    ``with_orders=False`` skips the node-ordering sort and returns input-order
    permutations in the two order fields, which are then NOT the selection
    orders; every other field is bit-identical to the ordered program. This
    is the light half of :func:`lazy_orders_decide`."""
    g: GroupArrays = cluster.groups
    p: PodArrays = cluster.pods
    n: NodeArrays = cluster.nodes
    G = g.valid.shape[0]
    N = n.valid.shape[0]

    # ---- aggregation (replaces pkg/k8s/util.go:27-51 per-group loops) ----
    # aggregate_pods + aggregate_nodes in one launch; its out-of-range
    # counter is read back at the end
    bad_ids = segsum.new_bad_ids(n.valid.device)
    sums = segsum.decide_sweeps(p, n, G, N, bad_ids=bad_ids)
    cpu_req, mem_req = sums["cpu_req"], sums["mem_req"]
    cpu_cap, mem_cap = sums["cpu_cap"], sums["mem_cap"]
    node_pods_remaining64 = sums["node_pods_remaining"]
    nu64, nt64 = sums["num_untainted"], sums["num_tainted"]
    num_pods = sums["num_pods"].to(I32)
    num_nodes = sums["num_nodes"].to(I32)
    num_untainted = nu64.to(I32)
    num_tainted = nt64.to(I32)
    num_cordoned = sums["num_cordoned"].to(I32)

    ngroup, untainted_sel, tainted_sel = node_selection_masks(
        n.valid, n.group, n.tainted, n.cordoned
    )

    (status, nodes_delta, cpu_pct_out, mem_pct_out,
     cpu_req, mem_req, cpu_cap, mem_cap) = group_decision_math(
        g, cpu_req, mem_req, cpu_cap, mem_cap,
        num_pods, num_nodes, num_untainted,
    )

    # ---- selections (pkg/controller/sort.go; scale_up.go:118; scale_down.go:171) ----
    untainted_offsets = _node_offsets(nu64)
    tainted_offsets = _node_offsets(nt64)
    trivial_order = torch.arange(N, dtype=I32, device=n.valid.device)
    if with_orders:
        # emptiest_first groups rank victims by pod count before age; elsewhere
        # the primary key is 0, which is the reference's oldest-first order
        victim_primary = torch.where(
            g.emptiest[ngroup.to(I64)], node_pods_remaining64,
            _const(0, I64, node_pods_remaining64),
        )
        lane_key = torch.arange(N, dtype=I64, device=n.valid.device)
        _, perm = combined_order_sort(
            ngroup, tainted_sel, untainted_sel, victim_primary,
            n.creation_ns, G, lane_key,
        )
        # with no tainted and no untainted lane the JAX program skips the
        # sort and returns the input-order iota; select it on the device
        untaint_order = torch.where(
            (untainted_sel | tainted_sel).any(), perm.to(I32), trivial_order)
        # the untainted block starts right after the tainted block: roll it
        # to the front (jnp.roll by -tainted_offsets[G]) as a gather, with no
        # read back to the host
        shift = tainted_offsets[G].to(I64)
        scale_down_order = untaint_order[(lane_key + shift) % N]
    else:
        untaint_order = trivial_order
        scale_down_order = trivial_order

    # ---- reaper eligibility (pkg/controller/scale_down.go:51-99) ----
    node_pods_remaining = node_pods_remaining64.to(I32)
    reap_mask = _reap_eligibility(
        n, g, ngroup, tainted_sel, node_pods_remaining, now_sec)

    segsum.check_bad_ids(bad_ids)
    return DecisionArrays(
        status=status,
        nodes_delta=nodes_delta,
        cpu_percent=cpu_pct_out,
        mem_percent=mem_pct_out,
        cpu_request_milli=cpu_req,
        mem_request_bytes=mem_req,
        cpu_capacity_milli=cpu_cap,
        mem_capacity_bytes=mem_cap,
        num_pods=num_pods,
        num_nodes=num_nodes,
        num_untainted=num_untainted,
        num_tainted=num_tainted,
        num_cordoned=num_cordoned,
        scale_down_order=scale_down_order,
        untainted_offsets=untainted_offsets,
        untaint_order=untaint_order,
        tainted_offsets=tainted_offsets,
        reap_mask=reap_mask,
        node_pods_remaining=node_pods_remaining,
    )


def lazy_orders_decide(dispatch: Callable[[bool], DecisionArrays],
                       tainted_any: bool) -> Tuple[DecisionArrays, bool]:
    """The lazy-orders tick protocol: pay the node-ordering sort only when a
    consumer exists, as the reference sorts only inside the executors that
    read an order (taintOldestN scale_down.go:171, untaintNewestN
    scale_up.go:118).

    ``dispatch(with_orders)`` runs one decide. Orders are needed when (a)
    tainted nodes exist (known before the decide from the host-side packed
    arrays), or (b) some group decided to scale down (known only after it,
    from nodes_delta, so that case dispatches again with orders). Returns
    ``(out, ordered)``; when ``ordered`` is False the two order fields are
    input-order placeholders and no window may be read."""
    if tainted_any:
        return dispatch(True), True
    out = dispatch(False)
    if bool((out.nodes_delta < 0).any()):
        return dispatch(True), True
    return out, False
