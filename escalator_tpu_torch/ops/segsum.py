"""Exact int64 per-segment sums, one launch per call.

The port of ``escalator_tpu/ops/pallas_kernel.py`` ``fused_segment_sums``
(:177), whose Pallas kernel ``_agg_kernel`` (:113) this module's CUDA kernel,
``csrc/segsum.cu``, replaces. Two entry points:

- :func:`fused_segment_sums`: the JAX wrapper's call signature and output
  dict; pre-masked columns summed under any ids in one launch.
- :func:`decide_sweeps`: the decide's three sweeps (pods by group, pods by
  node, nodes by group) in one launch from the raw pod and node arrays, into
  one zeroed buffer. Its plain version is the three input builders below
  (:func:`pod_sweep_inputs`, :func:`node_pods_sweep_inputs`,
  :func:`node_sweep_inputs`) under :func:`fused_segment_sums_plain`.

A tensor on the card goes to the CUDA kernel: each thread reads four
consecutive lanes with vector loads, merges runs of equal ids across its
lanes and its warp, and issues one 64-bit ``atomicAdd`` per run and nonzero
column. Integer addition mod 2^64 is associative, so the result is bit-equal
to the plain version on every input. A tensor on the CPU goes to the plain
version (an int64 ``index_add_`` per column). Any other device raises.

The id of every valid lane must lie in ``[0, num_segments)``; invalid lanes'
ids are never used. On the CPU the wrappers check that before they sum. On
the card the kernel counts the valid lanes out of range into a one-element
int64 tensor (``bad_ids``), and :func:`check_bad_ids` reads it back and
raises: the wrapper does that after its own launch, or a caller that passes
its own counter does it once, as the decide does.

Bound: bytes (each lane's valid flag, each valid lane's id and columns read
once, the int64 output written once); the source's note gives the numbers at
the north-star shape.

``LAUNCHES`` counts the launches of both entry points, so a run can show that
its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, List, Optional

import torch

from escalator_tpu_torch.core.arrays import NodeArrays, PodArrays
from escalator_tpu_torch.device import I32, I64
from escalator_tpu_torch.ops import _build
from escalator_tpu_torch.ops.order_tail import node_selection_masks

#: kernel launches so far in this process
LAUNCHES = 0

#: column capacity of one launch (int64 columns, count columns)
MAX_INT_COLUMNS = 8
MAX_COUNT_COLUMNS = 8

_PTRS = ctypes.c_void_p * max(MAX_INT_COLUMNS, MAX_COUNT_COLUMNS)

#: the rows of :func:`decide_sweeps`' ``[9, G]`` group sums, in the kernel's order
DECIDE_GROUP_ROWS = (
    "cpu_req", "mem_req", "num_pods",
    "cpu_cap", "mem_cap", "num_nodes", "num_untainted", "num_tainted", "num_cordoned",
)
#: :func:`decide_sweeps`' outputs, in the order it returns them
DECIDE_SUMS = (*DECIDE_GROUP_ROWS[:3], "node_pods_remaining", *DECIDE_GROUP_ROWS[3:])


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("segsum").segsum_launch
    fn.argtypes = [
        ctypes.c_void_p,                   # ids
        ctypes.c_void_p,                   # valid
        ctypes.c_longlong,                 # lanes
        ctypes.POINTER(ctypes.c_void_p),   # int64 column pointers
        ctypes.c_int,                      # number of int64 columns
        ctypes.POINTER(ctypes.c_void_p),   # count column pointers
        ctypes.c_int,                      # number of count columns
        ctypes.c_void_p,                   # out
        ctypes.c_longlong,                 # segments
        ctypes.c_void_p,                   # bad: int64 count of ids out of range
        ctypes.c_int,                      # device index
        ctypes.c_void_p,                   # stream
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _decide_entry():
    fn = _build.load("segsum").segsum_decide_launch
    fn.argtypes = [
        *[ctypes.c_void_p] * 5,   # pods: valid, group, node, cpu_milli, mem_bytes
        ctypes.c_longlong,        # pod lanes
        *[ctypes.c_void_p] * 6,   # nodes: valid, group, tainted, cordoned, cpu_milli, mem_bytes
        ctypes.c_longlong,        # node lanes
        ctypes.c_longlong,        # groups
        ctypes.c_void_p,          # out: [9, groups] then [nodes] int64, zeroed
        ctypes.c_void_p,          # bad: int64 count of ids out of range
        ctypes.c_int,             # device index
        ctypes.c_void_p,          # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(ids, valid, int_columns: List[torch.Tensor],
           count_columns: List[torch.Tensor], num_segments: int) -> None:
    if not isinstance(ids, torch.Tensor) or ids.dtype != I32 or ids.dim() != 1:
        raise TypeError("ids must be a 1-D int32 tensor")
    if ids.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no segment-sum implementation for device {ids.device}")
    if len(int_columns) > MAX_INT_COLUMNS or len(count_columns) > MAX_COUNT_COLUMNS:
        raise ValueError(
            f"at most {MAX_INT_COLUMNS} int64 and {MAX_COUNT_COLUMNS} count columns"
        )
    if num_segments < 0:
        raise ValueError("num_segments must be >= 0")
    tensors = [("valid", valid, torch.bool)]
    tensors += [("int column", c, I64) for c in int_columns]
    tensors += [("count column", c, torch.bool) for c in count_columns]
    for what, t, dtype in tensors:
        if t.dtype != dtype or t.shape != ids.shape or t.device != ids.device:
            raise TypeError(
                f"{what} must be {dtype} of shape {tuple(ids.shape)} on {ids.device}"
            )
    for _, t, _ in [("ids", ids, I32), *tensors]:
        if not t.is_contiguous():
            raise ValueError("segment-sum inputs must be contiguous")


def new_bad_ids(device) -> torch.Tensor:
    """A zeroed counter of out-of-range ids for ``fused_segment_sums(...,
    bad_ids=)``."""
    return torch.zeros(1, dtype=I64, device=device)


def _check_counter(bad_ids: Optional[torch.Tensor], device: torch.device) -> None:
    if bad_ids is not None and (bad_ids.dtype != I64 or bad_ids.shape != (1,)
                                or bad_ids.device != device):
        raise TypeError(f"bad_ids must be an int64 tensor of shape (1,) on {device}")


def check_bad_ids(bad_ids: torch.Tensor) -> None:
    """Raise if the launches that shared ``bad_ids`` met a valid lane whose
    id was out of range (one read-back on the card)."""
    count = int(bad_ids.item())
    if count:
        raise ValueError(f"{count} valid lanes had segment ids outside [0, num_segments)")


def _segsum_cuda(ids, valid, int_columns, count_columns, num_segments,
                 bad_ids) -> torch.Tensor:
    """One kernel launch; ``[num_segments, columns]`` int64."""
    global LAUNCHES
    n_cols = len(int_columns) + len(count_columns)
    out = torch.zeros((num_segments, n_cols), dtype=I64, device=ids.device)
    lanes = ids.numel()
    if lanes == 0:
        return out
    rc = _entry()(
        ids.data_ptr(), valid.data_ptr(), lanes,
        _PTRS(*[c.data_ptr() for c in int_columns]), len(int_columns),
        _PTRS(*[c.data_ptr() for c in count_columns]), len(count_columns),
        out.data_ptr(), num_segments, bad_ids.data_ptr(), ids.device.index,
        torch.cuda.current_stream(ids.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"segsum kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def fused_segment_sums(
    ids: torch.Tensor,
    valid: torch.Tensor,
    int_columns: Dict[str, torch.Tensor],
    count_columns: Dict[str, torch.Tensor],
    num_segments: int,
    *,
    bad_ids: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Exact per-segment sums of all columns in one sweep.

    ids:           [P] int32 segment (group) ids; a valid lane's in [0, num_segments)
    valid:         [P] bool; invalid lanes contribute nothing
    int_columns:   name -> [P] int64
    count_columns: name -> [P] bool 0-1 weights
    bad_ids:       optional counter from :func:`new_bad_ids` on the ids'
                   device; the caller then owes a :func:`check_bad_ids`
                   before it trusts the sums
    returns        name -> [num_segments] int64

    On a CUDA tensor this launches the kernel (or raises); on a CPU tensor it
    runs :func:`fused_segment_sums_plain`. A valid lane with an id out of
    range raises ValueError: here, or at the caller's :func:`check_bad_ids`
    when it passed ``bad_ids`` and the tensors are on the card.
    """
    names = [*int_columns, *count_columns]
    ints = list(int_columns.values())
    counts = list(count_columns.values())
    _check(ids, valid, ints, counts, num_segments)
    _check_counter(bad_ids, ids.device)
    if ids.device.type == "cpu":
        if bool((((ids < 0) | (ids >= num_segments)) & valid).any()):
            raise ValueError(f"segment ids outside [0, {num_segments})")
        return fused_segment_sums_plain(ids, valid, int_columns, count_columns, num_segments)
    own = bad_ids is None
    if own:
        bad_ids = new_bad_ids(ids.device)
    out = _segsum_cuda(ids, valid, ints, counts, num_segments, bad_ids)
    if own:
        check_bad_ids(bad_ids)
    return {name: out[:, c] for c, name in enumerate(names)}


def fused_segment_sums_plain(
    ids: torch.Tensor,
    valid: torch.Tensor,
    int_columns: Dict[str, torch.Tensor],
    count_columns: Dict[str, torch.Tensor],
    num_segments: int,
) -> Dict[str, torch.Tensor]:
    """The plain version of :func:`fused_segment_sums`: one int64
    ``index_add_`` per column on whatever device the inputs are on. Invalid
    lanes add zero to segment 0, whatever their id."""
    zero = torch.zeros((), dtype=I64, device=ids.device)
    ids64 = torch.where(valid, ids.to(I64), zero)
    out = {}
    for name, col in {**int_columns, **count_columns}.items():
        acc = torch.zeros(num_segments, dtype=I64, device=ids.device)
        if num_segments:
            acc.index_add_(0, ids64, torch.where(valid, col.to(I64), zero))
        out[name] = acc
    return out


# ---------------------------------------------------------------- the decide's sweeps


def pod_sweep_inputs(p: PodArrays):
    """``(ids, valid, int_columns, count_columns)`` of the per-group pod sums
    (replaces pkg/k8s/util.go:27-38). The kernel drops invalid lanes, so the
    request columns go in unmasked."""
    pgroup = torch.where(p.valid, p.group, torch.zeros_like(p.group))
    return (pgroup, p.valid, {"cpu_req": p.cpu_milli, "mem_req": p.mem_bytes},
            {"num_pods": p.valid})


def node_pods_sweep_inputs(p: PodArrays, node_group: torch.Tensor, N: int):
    """``(ids, valid, int_columns, count_columns)`` of the per-node pod count:
    each valid pod on a node of its own group counts once for that node (the
    same-group filter of the reference's node-info map, controller.go:259).
    ``node_group`` is the raw ``[N]`` node-group column."""
    on_node = p.valid & (p.node >= 0)
    pod_node = torch.where(on_node, p.node, torch.zeros_like(p.node))
    counted = on_node & (p.group == node_group[torch.clamp(p.node, 0, N - 1).to(I64)])
    return pod_node, counted, {}, {"node_pods_remaining": counted}


def node_sweep_inputs(n: NodeArrays):
    """``(ids, valid, int_columns, count_columns)`` of the per-group node sums:
    capacity over untainted nodes and the partition counts (replaces
    pkg/k8s/util.go:41-51 and filterNodes counting)."""
    ngroup, untainted_sel, tainted_sel = node_selection_masks(
        n.valid, n.group, n.tainted, n.cordoned)
    zero = torch.zeros((), dtype=I64, device=n.cpu_milli.device)
    return (
        ngroup,
        n.valid,
        {"cpu_cap": torch.where(untainted_sel, n.cpu_milli, zero),
         "mem_cap": torch.where(untainted_sel, n.mem_bytes, zero)},
        {"num_nodes": n.valid, "num_untainted": untainted_sel,
         "num_tainted": tainted_sel, "num_cordoned": n.valid & n.cordoned},
    )


def _sweeps(p: PodArrays, n: NodeArrays, G: int, N: int,
            segment_sums: Callable[..., Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    sums = {
        **segment_sums(*pod_sweep_inputs(p), G),
        **segment_sums(*node_pods_sweep_inputs(p, n.group, N), N),
        **segment_sums(*node_sweep_inputs(n), G),
    }
    return {name: sums[name] for name in DECIDE_SUMS}


_POD_FIELDS = (("valid", torch.bool), ("group", I32), ("node", I32),
               ("cpu_milli", I64), ("mem_bytes", I64))
_NODE_FIELDS = (("valid", torch.bool), ("group", I32), ("tainted", torch.bool),
                ("cordoned", torch.bool), ("cpu_milli", I64), ("mem_bytes", I64))


def _check_decide(p: PodArrays, n: NodeArrays, G: int, N: int) -> torch.device:
    device = p.valid.device
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no segment-sum implementation for device {device}")
    if G < 0 or N < 1:
        raise ValueError(f"need G >= 0 groups and N >= 1 node lanes, got G={G}, N={N}")
    for section, fields, lanes in ((p, _POD_FIELDS, p.valid.shape[0]), (n, _NODE_FIELDS, N)):
        for name, dtype in fields:
            t = getattr(section, name)
            if t.dtype != dtype or t.shape != (lanes,) or t.device != device:
                raise TypeError(f"{type(section).__name__}.{name} must be {dtype} "
                                f"of shape ({lanes},) on {device}")
            if not t.is_contiguous():
                raise ValueError("segment-sum inputs must be contiguous")
    return device


def decide_sweeps(p: PodArrays, n: NodeArrays, G: int, N: int, *,
                  bad_ids: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The decide's three sweeps in one launch, from the raw pod and node
    arrays: exactly what :func:`fused_segment_sums` gives on the inputs of
    :func:`pod_sweep_inputs` (``G`` groups), :func:`node_pods_sweep_inputs`
    (``N`` nodes, ``N`` the node lanes) and :func:`node_sweep_inputs`
    (``G`` groups).

    Returns name -> int64 sums, in :data:`DECIDE_SUMS` order: ``cpu_req``,
    ``mem_req``, ``num_pods`` ``[G]``; ``node_pods_remaining`` ``[N]``;
    ``cpu_cap``, ``mem_cap``, ``num_nodes``, ``num_untainted``,
    ``num_tainted``, ``num_cordoned`` ``[G]``. On the card they are views
    into one zeroed buffer. ``bad_ids`` as in :func:`fused_segment_sums`: a
    valid pod or node with a group outside ``[0, G)``, or a counted pod on a
    node ``>= N``, raises ValueError, here or at the caller's
    :func:`check_bad_ids`.
    """
    global LAUNCHES
    device = _check_decide(p, n, G, N)
    _check_counter(bad_ids, device)
    if device.type == "cpu":
        return _sweeps(p, n, G, N, fused_segment_sums)
    own = bad_ids is None
    if own:
        bad_ids = new_bad_ids(device)
    out = torch.zeros(len(DECIDE_GROUP_ROWS) * G + N, dtype=I64, device=device)
    rc = _decide_entry()(
        *[getattr(p, name).data_ptr() for name, _ in _POD_FIELDS], p.valid.numel(),
        *[getattr(n, name).data_ptr() for name, _ in _NODE_FIELDS], N,
        G, out.data_ptr(), bad_ids.data_ptr(), device.index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"segsum decide kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    if own:
        check_bad_ids(bad_ids)
    rows = out[: len(DECIDE_GROUP_ROWS) * G].view(len(DECIDE_GROUP_ROWS), G)
    sums = dict(zip(DECIDE_GROUP_ROWS, rows, strict=True))
    sums["node_pods_remaining"] = out[len(DECIDE_GROUP_ROWS) * G:]
    return {name: sums[name] for name in DECIDE_SUMS}


def decide_sweeps_plain(p: PodArrays, n: NodeArrays, G: int, N: int) -> Dict[str, torch.Tensor]:
    """The plain version of :func:`decide_sweeps` on whatever device the
    inputs are on: the three input builders under
    :func:`fused_segment_sums_plain`."""
    return _sweeps(p, n, G, N, fused_segment_sums_plain)
