#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--seed N]

1. device: requires CUDA and prints the card's name and power limit;
2. build:  compiles every kernel of the decide path from ``escalator_tpu_torch/ops/csrc``
   into ``build/kernels/``;
3. kernel: both entry points of the segment-sum kernel against their plain
   versions on the card, bit-equal: the generic sum on edge-case layouts, and
   the decide's fused sweeps (``segsum.decide_sweeps``) on edge-case pod and
   node layouts, ragged lane counts and inputs that start off a 16-byte
   boundary; a valid lane's id out of range raises;
4. main path: ``make_backend("torch").decide`` at 100k pods, 50k nodes and 2048
   nodegroups (objects made from ``--seed``) over three ticks — healthy
   (light program), tainted nodes (ordered program), scale-down (light, then
   ordered). Every decide field and every ``GroupDecision`` must be bit-equal
   to the same ticks on ``device="cpu"`` (the plain versions), and every
   decide must have launched the kernel exactly once;
5. timings: pack / to_device / decide / unpack medians per tick; the device
   time of one call of the decide's fused launch and, per call site, of the
   generic entry, each beside its plain version, the PyTorch calls that
   compute the same sums (``index_add_``) and the kernel's bound, from a CUDA
   graph of back-to-back calls; and the host's launch rate of each, and of
   the wrapper, from CUDA events around back-to-back calls;
6. profiles (torch.profiler): the device time of each tick's decide, and the
   kernel's own device time per launch;
7. the ``kernels`` line, the card line, and last the result line.

It drives one card: the first that ``CUDA_VISIBLE_DEVICES`` names (card 0
when that is unset) is the only one the process sees. Any failure raises and
exits non-zero before the result line. Without CUDA it exits non-zero at
once.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

GROUPS, NODES, PODS = 2048, 50_000, 100_000
NOW = 1_700_000_000
NODE_CPU, NODE_MEM = 4000, 16 * 2**30
#: the card's published peaks (H100 SXM data sheet): HBM bytes/s, and the
#: float32 rate outside the tensor cores, used as the rate of scalar adds
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12


def log(**fields) -> None:
    print(json.dumps(fields), flush=True)


def use_one_card() -> str:
    """Make the first card that CUDA_VISIBLE_DEVICES names (card 0 when it
    is unset) the only one this process sees; returns its index or UUID.
    Must run before the first CUDA call."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is None:
        os.environ["CUDA_DEVICE_ORDER"] = "PCI_BUS_ID"  # nvidia-smi's order
        card = "0"
    else:
        card = visible.split(",")[0].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = card
    return card


def card_line(card: str) -> str:
    proc = subprocess.run(
        ["nvidia-smi", "-i", card, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return proc.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing


def graph_ms(fn, iters: int = 100, reps: int = 7) -> float:
    """Median device time of one ``fn()`` call: ``iters`` calls captured in
    one CUDA graph and replayed between CUDA events. The replay launches the
    calls back to back from the device, so, unlike :func:`device_ms`, the
    host's launch rate does not enter."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream, as capture needs
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def device_ms(fn, iters: int = 200, reps: int = 7) -> float:
    """Median time of one ``fn()`` call from CUDA events around ``iters``
    back-to-back calls: for a call of a few microseconds, the rate at which
    the host launches it rather than the device's time."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


# ---------------------------------------------------------------- kernel checks


def _sorted_ids(rng, P, G):
    return np.repeat(np.arange(G, dtype=np.int32), rng.multinomial(P, np.full(G, 1.0 / G)))


def kernel_layouts(rng):
    """(name, ids, valid, int columns, count columns, segments) in numpy."""
    def cols(P, n_int, n_cnt, lo=0, hi=2**40):
        return ({f"i{c}": rng.integers(lo, hi, P, dtype=np.int64) for c in range(n_int)},
                {f"c{c}": rng.random(P) < 0.5 for c in range(n_cnt)})

    P = 1_000_003  # not a multiple of the block
    yield ("group_contiguous", _sorted_ids(rng, P, 2048), rng.random(P) < 0.9, *cols(P, 2, 1), 2048)
    yield ("interleaved", rng.integers(0, 2048, P).astype(np.int32), rng.random(P) < 0.9,
           *cols(P, 2, 4), 2048)
    P, G = 12_000, 2048
    ids = _sorted_ids(rng, P, G)
    valid = np.ones(P, bool)
    freed = rng.random(P) < 0.15
    valid[freed] = False
    reused = freed & (rng.random(P) < 0.5)
    ids[reused] = rng.integers(0, G, int(reused.sum())).astype(np.int32)
    valid[reused] = True
    yield ("slot_reuse", ids, valid, *cols(P, 2, 1), G)
    yield ("one_lane_per_group", rng.permutation(4096).astype(np.int32), np.ones(4096, bool),
           *cols(4096, 2, 1), 4096)
    yield ("under_one_lane_per_group", rng.integers(0, 65536, 1000).astype(np.int32),
           np.ones(1000, bool), *cols(1000, 1, 1), 65536)
    P = 100_000
    yield ("values_ge_2^48", _sorted_ids(rng, P, 64), np.ones(P, bool),
           *cols(P, 2, 0, 2**48, 2**56), 64)
    yield ("negative_values", _sorted_ids(rng, P, 64), rng.random(P) < 0.9,
           *cols(P, 2, 1, -(2**62), 2**62), 64)
    ids = np.concatenate([np.zeros(500, np.int32), np.full(500, 1900, np.int32),
                          np.full(500, 2047, np.int32)])
    yield ("empty_groups_between", ids, np.ones(1500, bool), *cols(1500, 1, 1), 2048)
    yield ("one_lane", np.zeros(1, np.int32), np.ones(1, bool), *cols(1, 2, 1), 1)
    yield ("lanes_257", _sorted_ids(rng, 257, 5), np.ones(257, bool), *cols(257, 2, 4), 5)
    P = (1 << 23) + 12_345  # beyond the TPU kernel's int32 accumulator bound
    yield ("lanes_over_2^23", _sorted_ids(rng, P, 2048), rng.random(P) < 0.95,
           *cols(P, 2, 1), 2048)
    yield ("all_columns", _sorted_ids(rng, 5000, 40), rng.random(5000) < 0.9,
           *cols(5000, 8, 8, -(2**62), 2**62), 40)


def check_kernel_vs_plain(segsum, ids, valid, ints, counts, G) -> int:
    """Kernel through its wrapper vs the plain version, same tensors on the
    card; returns the max abs difference (raises unless 0)."""
    got = segsum.fused_segment_sums(ids, valid, ints, counts, G)
    want = segsum.fused_segment_sums_plain(ids, valid, ints, counts, G)
    torch.cuda.synchronize()
    err = 0
    for name, w in want.items():
        err = max(err, int((got[name] - w).abs().max()) if w.numel() else 0)
        if not torch.equal(got[name], w):
            raise AssertionError(f"segsum kernel != plain on column {name}: max abs err {err}")
    return err


def sweep_arrays(rng, P, N, G, *, pod_live=0.9, node_live=0.9, contiguous=True):
    """``(pods, nodes)`` numpy dicts under the PodArrays / NodeArrays field
    names that the decide's sweeps read. Node lanes group-contiguous (or
    interleaved), 10% tainted, 5% cordoned; a pod sits on a random node lane
    (-1 for none, 1 in N+1) and mostly takes that node's group, 5% another."""
    n_group = (_sorted_ids(rng, N, G) if contiguous else rng.integers(0, G, N).astype(np.int32))
    nodes = dict(valid=rng.random(N) < node_live, group=n_group,
                 tainted=rng.random(N) < 0.1, cordoned=rng.random(N) < 0.05,
                 cpu_milli=rng.integers(0, 2**40, N), mem_bytes=rng.integers(0, 2**47, N))
    node = rng.integers(-1, N, P).astype(np.int32)
    if contiguous:
        node.sort()
    group = n_group[np.clip(node, 0, N - 1)]
    other = rng.random(P) < 0.05
    group[other] = rng.integers(0, G, int(other.sum()))
    pods = dict(valid=rng.random(P) < pod_live, group=group, node=node,
                cpu_milli=rng.integers(0, 2**40, P), mem_bytes=rng.integers(0, 2**47, P))
    return pods, nodes


def decide_layouts(rng, P=131_072, N=65_536, G=GROUPS, lane_counts=(1, 3, 33, 4097, 1_000_003)):
    """(name, pods, nodes, G) for the decide's fused sweeps, in numpy: edge
    cases at ``P`` pod lanes, ``N`` node lanes and ``G`` groups (by default
    the main path's), then ``P = N`` at each of ``lane_counts``. Every valid
    id is in range; :func:`decide_bad_layouts` holds the ones that are not."""
    def arrays(**kw):
        return sweep_arrays(rng, P, N, G, **kw)

    yield ("contiguous", *arrays(), G)
    yield ("interleaved", *arrays(contiguous=False), G)
    pods, nodes = arrays()
    pods["node"][rng.random(P) < 0.5] = -1
    yield ("pods_off_node", pods, nodes, G)
    pods, nodes = arrays()
    moved = rng.random(P) < 0.5
    pods["group"][moved] = (pods["group"][moved] + 1) % G
    yield ("pods_on_other_group_nodes", pods, nodes, G)
    yield ("pods_on_invalid_node_lanes", *arrays(node_live=0.5), G)
    pods, nodes = arrays(pod_live=0.7, node_live=0.7)
    for arr, fields in ((pods, ("group", "node")), (nodes, ("group",))):
        dead = ~arr["valid"]
        for f in fields:
            arr[f][dead] = rng.integers(-(2**31), 2**31, int(dead.sum()))
    yield ("padding_garbage_ids", pods, nodes, G)
    for name, lo, hi in (("values_ge_2^48", 2**48, 2**62), ("negative_values", -(2**62), 2**62)):
        pods, nodes = arrays()
        for arr in (pods, nodes):
            for f in ("cpu_milli", "mem_bytes"):
                arr[f] = rng.integers(lo, hi, len(arr[f]))
        yield (name, pods, nodes, G)
    for name, tainted, cordoned in (("all_tainted", True, False), ("all_cordoned", False, True),
                                    ("tainted_and_cordoned", True, True)):
        pods, nodes = arrays()
        nodes["tainted"][:] = tainted
        nodes["cordoned"][:] = cordoned
        yield (name, pods, nodes, G)
    yield ("zero_valid", *arrays(pod_live=0.0, node_live=0.0), G)
    yield ("one_group_one_node", *sweep_arrays(rng, P, 1, 1), 1)
    pods, nodes = arrays()
    beyond = pods["valid"] & (rng.random(P) < 0.1)
    pods["node"][beyond] = N + rng.integers(0, 1000, int(beyond.sum()))
    pods["group"][beyond] = (nodes["group"][N - 1] + 1) % G  # not the clamped node's group
    yield ("uncounted_pods_on_node_ge_N", pods, nodes, G)
    for lanes in lane_counts:
        yield (f"lanes_{lanes}", *sweep_arrays(rng, lanes, lanes, min(G, lanes)), min(G, lanes))


def decide_bad_layouts(rng, P=4096, N=2048, G=64):
    """(name, pods, nodes, G) on which :func:`segsum.decide_sweeps` must
    raise: a valid pod or node with group >= G, or a counted pod (valid, of
    its clamped node's group) on a node >= N."""
    pods, nodes = sweep_arrays(rng, P, N, G)
    pods["valid"][7] = True
    pods["group"][7] = G
    yield ("pod_group_ge_G", pods, nodes, G)
    pods, nodes = sweep_arrays(rng, P, N, G)
    nodes["valid"][5] = True
    nodes["group"][5] = G
    yield ("node_group_ge_G", pods, nodes, G)
    pods, nodes = sweep_arrays(rng, P, N, G)
    pods["valid"][9], pods["node"][9], pods["group"][9] = True, N + 3, nodes["group"][N - 1]
    yield ("counted_pod_on_node_ge_N", pods, nodes, G)


def sweep_tensors(pods, nodes, device, offset=0):
    """The numpy layout as the port's PodArrays / NodeArrays on ``device``.
    With ``offset``, each tensor is a slice that starts ``offset`` elements
    into a larger one, so its storage is off the allocator's alignment."""
    from escalator_tpu_torch.core.arrays import NodeArrays, PodArrays

    def t(a):
        a = torch.from_numpy(np.ascontiguousarray(a))
        if not offset:
            return a.to(device)
        big = torch.zeros(a.numel() + offset, dtype=a.dtype, device=device)
        big[offset:] = a.to(device)
        return big[offset:]

    def section(cls, arrays):  # fields the layout leaves out stay None
        return cls(**{f.name: t(arrays[f.name]) if f.name in arrays else None
                      for f in dataclasses.fields(cls)})

    return section(PodArrays, pods), section(NodeArrays, nodes)


def check_decide_vs_plain(segsum, p, n, G) -> int:
    """decide_sweeps through its wrapper vs decide_sweeps_plain, same tensors
    on the card; returns the max abs difference (raises unless 0)."""
    N = n.valid.numel()
    got = segsum.decide_sweeps(p, n, G, N)
    want = segsum.decide_sweeps_plain(p, n, G, N)
    torch.cuda.synchronize()
    if list(got) != list(want):
        raise AssertionError(f"decide_sweeps gives {list(got)}, plain {list(want)}")
    err = 0
    for name, w in want.items():
        err = max(err, int((got[name] - w).abs().max()) if w.numel() else 0)
        if not torch.equal(got[name], w):
            raise AssertionError(f"decide kernel != plain on {name}: max abs err {err}")
    return err


# ---------------------------------------------------------------- world


def build_world(rng, k8s, sem):
    """GROUPS nodegroups holding NODES nodes and PODS pods (two per node, all
    scheduled), each group at 50-60% of its capacity except every tenth,
    which runs hot (75-85%) and scales up. Every fourth group picks victims
    emptiest-first."""
    per_group = 1 + rng.multinomial(NODES - GROUPS, np.full(GROUPS, 1.0 / GROUPS))
    world = []
    for g in range(GROUPS):
        n = int(per_group[g])
        created = rng.integers(10**18, 2 * 10**18, n)
        nodes = [k8s.Node(name=f"g{g}-n{i}", creation_time_ns=int(created[i]),
                          cpu_allocatable_milli=NODE_CPU, mem_allocatable_bytes=NODE_MEM)
                 for i in range(n)]
        lo, hi = (0.75, 0.85) if g % 10 == 1 else (0.50, 0.60)
        load = rng.uniform(lo, hi, 2 * n)
        pods = [k8s.Pod(name=f"g{g}-p{j}", node_name=nodes[j // 2].name,
                        containers=[k8s.ResourceRequests(
                            cpu_milli=int(load[j] * NODE_CPU / 2),
                            mem_bytes=int(load[j] * NODE_MEM / 2))])
                for j in range(2 * n)]
        cfg = sem.GroupConfig(
            min_nodes=1, max_nodes=1000, taint_lower_percent=30, taint_upper_percent=45,
            scale_up_percent=70, slow_removal_rate=1, fast_removal_rate=2,
            soft_delete_grace_sec=300, hard_delete_grace_sec=900,
            scale_down_selection="emptiest_first" if g % 4 == 0 else "oldest_first")
        world.append((pods, nodes, cfg, sem.GroupState()))
    return world


def tainted_tick(rng, world, k8s):
    """5% of the nodes tainted (some past the hard grace), 1% cordoned, 1% no-delete."""
    out = []
    for pods, nodes, cfg, state in world:
        marked = []
        for node in nodes:
            r = rng.random()
            if r < 0.05:
                node = dataclasses.replace(node, taints=[k8s.Taint(
                    key=k8s.TO_BE_REMOVED_BY_AUTOSCALER_KEY,
                    value=str(NOW - int(rng.integers(0, 1200))))])
            elif r < 0.06:
                node = dataclasses.replace(node, unschedulable=True)
            if rng.random() < 0.01:
                node = dataclasses.replace(
                    node, annotations={k8s.NODE_ESCALATOR_IGNORE_ANNOTATION: "true"})
            marked.append(node)
        out.append((pods, marked, cfg, state))
    return out


def scale_down_tick(world):
    """Every tenth group (offset 3) loses 70% of its pods and drops below the
    lower threshold."""
    return [(pods[: len(pods) * 3 // 10] if g % 10 == 3 else pods, nodes, cfg, state)
            for g, (pods, nodes, cfg, state) in enumerate(world)]


def decision_key(gd):
    d = gd.decision
    return (tuple(getattr(d, f.name) for f in dataclasses.fields(d)),
            [n.name for n in gd.scale_down_order], [n.name for n in gd.untaint_order],
            [n.name for n in gd.reap_nodes], [n.name for n in gd.cordoned_nodes],
            gd.node_pods_remaining)


# ---------------------------------------------------------------- phases


def sweep_bound(ids, valid, ints, counts, G):
    """(bound_ms, bound_by, bytes) of one segment sum on these inputs: the
    valid flag read for every lane; the id and each distinct column read for
    the valid lanes only (a padding lane needs nothing else, and the kernel
    reads nothing else); the [G, columns] int64 output written once; one add
    per valid lane and column."""
    live = int(valid.sum())
    columns = {t.data_ptr(): t for t in [*ints.values(), *counts.values()]}
    columns.pop(valid.data_ptr(), None)  # a count column that is the valid flag
    n_cols = len(ints) + len(counts)
    nbytes = (valid.numel() * valid.element_size()
              + live * (ids.element_size() + sum(t.element_size() for t in columns.values()))
              + G * n_cols * 8)
    return _bound(nbytes, live * n_cols)


def decide_bound(p, n, G):
    """(bound_ms, bound_by, bytes) of the decide's fused launch on these
    inputs: each lane's valid flag; a valid pod's group, node, cpu and mem; a
    valid node's group, tainted and cordoned flags, cpu and mem (a pod's
    gather of its node's group reads nothing new); the [9, G] and [N] int64
    sums written once; one add per valid lane and sum (4 per pod, 6 per
    node)."""
    live_p, live_n = int(p.valid.sum()), int(n.valid.sum())
    pod_bytes = sum(getattr(p, f).element_size() for f in ("group", "node", "cpu_milli", "mem_bytes"))
    node_bytes = sum(getattr(n, f).element_size()
                     for f in ("group", "tainted", "cordoned", "cpu_milli", "mem_bytes"))
    N = n.valid.numel()
    nbytes = (p.valid.numel() * p.valid.element_size() + live_p * pod_bytes
              + N * n.valid.element_size() + live_n * node_bytes + (9 * G + N) * 8)
    return _bound(nbytes, 4 * live_p + 6 * live_n)


def _bound(nbytes, ops):
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_SCALAR_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), nbytes


def raw_launcher(segsum, ids, valid, ints, counts, G):
    """One launch of the kernel through its C entry, with the arguments built
    once: timing it measures the kernel and not the wrapper's host work."""
    int_list, cnt_list = list(ints.values()), list(counts.values())
    out = torch.zeros((G, len(int_list) + len(cnt_list)), dtype=torch.int64, device=ids.device)
    bad_ids = segsum.new_bad_ids(ids.device)
    entry = segsum._entry()
    args = (ids.data_ptr(), valid.data_ptr(), ids.numel(),
            segsum._PTRS(*[c.data_ptr() for c in int_list]), len(int_list),
            segsum._PTRS(*[c.data_ptr() for c in cnt_list]), len(cnt_list),
            out.data_ptr(), G, bad_ids.data_ptr(), ids.device.index)

    def launch():  # names out and bad_ids, so the closure keeps them alive
        # the stream is read at each call, so a graph capture records the launch
        if entry(*args, torch.cuda.current_stream(ids.device).cuda_stream) != 0:
            raise RuntimeError(f"segsum launch into {tuple(out.shape)}, {bad_ids} failed")

    return launch


def decide_launcher(segsum, p, n, G):
    """One launch of the decide's fused sweeps through its C entry, with the
    arguments built once (see :func:`raw_launcher`)."""
    N = n.valid.numel()
    out = torch.zeros(len(segsum.DECIDE_GROUP_ROWS) * G + N, dtype=torch.int64,
                      device=n.valid.device)
    bad_ids = segsum.new_bad_ids(n.valid.device)
    entry = segsum._decide_entry()
    args = (*[getattr(p, f).data_ptr() for f, _ in segsum._POD_FIELDS], p.valid.numel(),
            *[getattr(n, f).data_ptr() for f, _ in segsum._NODE_FIELDS], N,
            G, out.data_ptr(), bad_ids.data_ptr(), n.valid.device.index)

    def launch():  # names out and bad_ids, so the closure keeps them alive
        if entry(*args, torch.cuda.current_stream(n.valid.device).cuda_stream) != 0:
            raise RuntimeError(f"segsum decide launch into {tuple(out.shape)}, {bad_ids} failed")

    return launch


def sweep_callables(segsum, ids, valid, ints, counts, G):
    """(kernel, wrapper, plain, library) callables of one call site: the raw
    launch, the wrapper as the decide calls it (a shared out-of-range counter,
    no read-back), the plain version, and one index_add_ of the stacked,
    pre-masked columns (the library yardstick; the port never calls it)."""
    ids64 = ids.to(torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=ids.device)
    cols2d = torch.stack([torch.where(valid, c.to(torch.int64), zero)
                          for c in [*ints.values(), *counts.values()]], 1).contiguous()
    lib_out = torch.zeros((G, cols2d.shape[1]), dtype=torch.int64, device=ids.device)
    bad_ids = segsum.new_bad_ids(ids.device)
    return (
        raw_launcher(segsum, ids, valid, ints, counts, G),
        lambda: segsum.fused_segment_sums(ids, valid, ints, counts, G, bad_ids=bad_ids),
        lambda: segsum.fused_segment_sums_plain(ids, valid, ints, counts, G),
        lambda: lib_out.index_add_(0, ids64, cols2d),
    )


def kernel_profiler_ms(launch, iters: int = 100):
    """The segsum kernels' own device time per launch from torch.profiler,
    over ``iters`` launches; "not measured" when the profiler recorded no
    device event, which happens now and then."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            launch()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and "segsum" in e.key]
    count = sum(e.count for e in events)
    if not count:
        return "not measured"
    return sum(e.self_device_time_total for e in events) / count / 1e3


def decide_profile(backend, inputs, decide_ms: float) -> dict:
    """Device time of one tick from torch.profiler, split into copies
    (``Memcpy``: the to_device uploads, the unpack reads and the decide's few
    read-backs) and everything else (kernels and memsets, all launched by the
    decide phase), with the latter's share of the unprofiled median decide
    phase and the largest items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        backend.decide(inputs, NOW)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    copies = [e for e in events if e.key.startswith("Memcpy")]
    work = [e for e in events if not e.key.startswith("Memcpy")]
    work_ms = sum(e.self_device_time_total for e in work) / 1e3
    if work_ms == 0:
        return {"device_work_ms": "not measured"}
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    return {
        "device_work_ms": work_ms,
        "device_work_ops": sum(e.count for e in work),
        "device_copy_ms": sum(e.self_device_time_total for e in copies) / 1e3,
        "device_copies": sum(e.count for e in copies),
        "decide_ms_median": decide_ms,
        "work_share_of_decide": work_ms / decide_ms,
        "top": [(e.key[:60], e.count, e.self_device_time_total / 1e3) for e in top],
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    # ---- 1. device
    card_id = use_one_card()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 1
    if torch.cuda.device_count() != 1:
        raise AssertionError(f"{torch.cuda.device_count()} cards visible; expected one")
    dev = torch.device("cuda", 0)
    card = card_line(card_id)
    print(card, flush=True)
    log(phase="device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        card=card_id, torch=torch.__version__, cuda=torch.version.cuda)

    from escalator_tpu_torch.controller.backend import PaddedPacker, make_backend
    from escalator_tpu_torch.core import semantics as sem
    from escalator_tpu_torch.core.arrays import to_device
    from escalator_tpu_torch.interop import decision_to_numpy
    from escalator_tpu_torch.k8s import types as k8s
    from escalator_tpu_torch.ops import _build, segsum

    # ---- 2. build
    t0 = time.perf_counter()
    lib_path, build_log = _build.build("segsum")
    segsum._entry()
    log(phase="build", kernel="segsum", seconds=time.perf_counter() - t0, library=lib_path.name)
    print(build_log.strip(), flush=True)

    # ---- 3. kernel vs plain on the card
    rng = np.random.default_rng(args.seed)
    max_err = 0
    for name, ids, valid, ints, counts, G in kernel_layouts(rng):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        max_err = max(max_err, check_kernel_vs_plain(
            segsum, t(ids), t(valid), {k: t(v) for k, v in ints.items()},
            {k: t(v) for k, v in counts.items()}, G))
        log(phase="kernel_check", layout=name, lanes=len(ids), segments=G, bit_equal=True)
    # ids out of range: the kernel counts a valid lane's and the wrapper
    # raises; an invalid lane's id is never read
    ids = torch.arange(1000, dtype=torch.int32, device=dev) % 7
    ids[500], ids[900] = 7, -3
    valid = torch.ones(1000, dtype=torch.bool, device=dev)
    valid[900] = False
    ones = {"v": torch.ones(1000, dtype=torch.int64, device=dev)}
    try:
        segsum.fused_segment_sums(ids, valid, ones, {}, 7)
    except ValueError:
        pass
    else:
        raise AssertionError("segsum kernel let a valid lane's out-of-range id through")
    valid[500] = False
    max_err = max(max_err, check_kernel_vs_plain(segsum, ids, valid, ones, {}, 7))
    log(phase="kernel_check", layout="ids_out_of_range", raised=True, bit_equal=True)

    # the decide's fused sweeps: edge layouts at the main path's shape, ragged
    # lane counts, and every input off the allocator's 16-byte alignment (a
    # slice one element into a larger tensor), which the kernel reads lane by
    # lane. Their own random stream keeps the world below as it was before
    # these checks existed.
    layout_rng = np.random.default_rng([args.seed, 1])
    for name, pods, nodes, G in decide_layouts(layout_rng):
        for offset in (0, 1) if name in ("contiguous", "lanes_4097") else (0,):
            p, n = sweep_tensors(pods, nodes, dev, offset)
            max_err = max(max_err, check_decide_vs_plain(segsum, p, n, G))
            unaligned = {"unaligned_inputs": "read by the kernel"} if offset else {}
            log(phase="kernel_check", entry="decide_sweeps", layout=name, pod_lanes=len(pods["valid"]),
                node_lanes=len(nodes["valid"]), groups=G, offset_elements=offset, **unaligned,
                bit_equal=True)
    for name, pods, nodes, G in decide_bad_layouts(layout_rng):
        p, n = sweep_tensors(pods, nodes, dev)
        try:
            segsum.decide_sweeps(p, n, G, n.valid.numel())
        except ValueError:
            log(phase="kernel_check", entry="decide_sweeps", layout=name, raised=True)
        else:
            raise AssertionError(f"decide_sweeps let {name} through")

    # ---- 4. main path
    t0 = time.perf_counter()
    world = build_world(rng, k8s, sem)
    ticks = [("healthy", world), ("tainted", tainted_tick(rng, world, k8s)),
             ("scale_down", scale_down_tick(world))]
    shape = (len(world), sum(len(n) for _, n, _, _ in world), sum(len(p) for p, _, _, _ in world))
    if shape != (GROUPS, NODES, PODS):
        raise AssertionError(f"world has (groups, nodes, pods) = {shape}")
    log(phase="world", seconds=time.perf_counter() - t0, groups=GROUPS, nodes=NODES, pods=PODS)
    expect = {"healthy": (False, 1), "tainted": (True, 1), "scale_down": (True, 2)}

    backend = make_backend("torch")
    assert backend.device.type == "cuda"
    outs = []
    segsum.LAUNCHES = 0
    per_tick_launches = []
    for name, inputs in ticks:
        before = segsum.LAUNCHES
        results = backend.decide(inputs, NOW)
        per_tick_launches.append(segsum.LAUNCHES - before)
        outs.append((name, results, backend.last_out, backend.last_ordered,
                     dict(backend.phase_seconds)))
    main_launches = segsum.LAUNCHES
    for (name, _, _, ordered, _), launches in zip(outs, per_tick_launches, strict=True):
        want_ordered, decides = expect[name]
        if ordered != want_ordered or launches != decides:
            raise AssertionError(
                f"tick {name}: ordered={ordered} with {launches} kernel launches; "
                f"expected ordered={want_ordered} and {decides}")
    log(phase="main_path", launches=main_launches, per_tick=dict(
        zip([n for n, _ in ticks], per_tick_launches, strict=True)))

    cpu_backend = make_backend("torch", device="cpu")
    for (name, results, out, ordered, phases), (_, inputs) in zip(outs, ticks, strict=True):
        cpu_results = cpu_backend.decide(inputs, NOW)
        got, want = decision_to_numpy(out), decision_to_numpy(cpu_backend.last_out)
        for field, w in want.items():
            g = got[field]
            if g.dtype != w.dtype or g.shape != w.shape or g.tobytes() != w.tobytes():
                raise AssertionError(f"tick {name}: field {field} differs from the cpu run")
        if ordered != cpu_backend.last_ordered:
            raise AssertionError(f"tick {name}: ordered differs from the cpu run")
        if [decision_key(r) for r in results] != [decision_key(r) for r in cpu_results]:
            raise AssertionError(f"tick {name}: GroupDecisions differ from the cpu run")
        deltas = got["nodes_delta"][:GROUPS]
        if not (np.isfinite(got["cpu_percent"]).all() and np.isfinite(got["mem_percent"]).all()):
            raise AssertionError(f"tick {name}: non-finite percents")
        log(phase="tick", tick=name, ordered=ordered, bit_equal_to_cpu=True,
            scale_up=int((deltas > 0).sum()), scale_down=int((deltas < 0).sum()),
            tainted=int(got["num_tainted"].sum()), reap=int(got["reap_mask"].sum()),
            statuses={s.name: int((got["status"][:GROUPS] == s).sum())
                      for s in sem.DecisionStatus},
            gpu_ms={k: v * 1e3 for k, v in phases.items()},
            cpu_ms={k: v * 1e3 for k, v in cpu_backend.phase_seconds.items()})
    if (outs[0][2].nodes_delta < 0).any() or not (outs[2][2].nodes_delta < 0).any():
        raise AssertionError("the healthy tick scaled down or the scale-down tick did not")

    # a small input with a known answer (the float-order case of the JAX
    # package's parity tests: ceil(543 * ((30.055... - 15) / 15)) = 545)
    nodes = [k8s.Node(name=f"fo-n{i}", cpu_allocatable_milli=10, mem_allocatable_bytes=10**6)
             for i in range(543)]
    pods = [k8s.Pod(name="fo-p", containers=[k8s.ResourceRequests(1632, 10**5)])]
    cfg = sem.GroupConfig(min_nodes=0, max_nodes=10**6, taint_lower_percent=1,
                          taint_upper_percent=2, scale_up_percent=15,
                          slow_removal_rate=1, fast_removal_rate=2)
    small = make_backend("torch").decide([(pods, nodes, cfg, sem.GroupState())], NOW)
    if small[0].decision.nodes_delta != 545:
        raise AssertionError(f"float-order case: delta {small[0].decision.nodes_delta} != 545")
    log(phase="small_reference", nodes_delta=545)

    # ---- 5. timings
    samples = {name: [] for name, _ in ticks}
    for _ in range(5):
        for name, inputs in ticks:
            backend.decide(inputs, NOW)
            samples[name].append(backend.phase_seconds)
    for name, rows in samples.items():
        log(phase="tick_timing", tick=name, device=torch.cuda.get_device_name(0),
            **{f"{k}_ms_median": statistics.median(r[k] for r in rows) * 1e3 for k in rows[0]})

    cluster = to_device(PaddedPacker().pack(ticks[0][1]), dev)
    p, n = cluster.pods, cluster.nodes
    P, N = p.valid.numel(), n.valid.numel()
    sites = {
        "pods": (*segsum.pod_sweep_inputs(p), GROUPS),
        "nodes": (*segsum.node_sweep_inputs(n), GROUPS),
        "node_pods": (*segsum.node_pods_sweep_inputs(p, n.group, N), N),
    }
    log(phase="main_path_shapes", pod_lanes=P, node_lanes=N, groups=GROUPS)
    site_rows, calls = {}, {}
    for name, (ids, valid, ints, counts, G) in sites.items():
        max_err = max(max_err, check_kernel_vs_plain(segsum, ids, valid, ints, counts, G))
        calls[name] = sweep_callables(segsum, ids, valid, ints, counts, G)
        kernel_fn, wrapper_fn, plain_fn, library_fn = calls[name]
        bound_ms, bound_by, nbytes = sweep_bound(ids, valid, ints, counts, G)
        site_rows[name] = dict(
            site=name, lanes=ids.numel(), valid_lanes=int(valid.sum()), segments=G,
            columns=len(ints) + len(counts), bytes=nbytes, bound_ms=bound_ms,
            bound_by=bound_by, ms=graph_ms(kernel_fn), plain_ms=graph_ms(plain_fn),
            library_ms=graph_ms(library_fn), launch_ms=device_ms(kernel_fn),
            wrapper_launch_ms=device_ms(wrapper_fn), plain_launch_ms=device_ms(plain_fn),
            library_launch_ms=device_ms(library_fn))

    # the decide's one launch: the three sites' sums from the raw arrays
    max_err = max(max_err, check_decide_vs_plain(segsum, p, n, GROUPS))
    decide_fn = decide_launcher(segsum, p, n, GROUPS)
    bad_ids = segsum.new_bad_ids(dev)
    decide_wrapper = lambda: segsum.decide_sweeps(p, n, GROUPS, N, bad_ids=bad_ids)  # noqa: E731
    decide_plain = lambda: segsum.decide_sweeps_plain(p, n, GROUPS, N)  # noqa: E731
    bound_ms, bound_by, nbytes = decide_bound(p, n, GROUPS)
    decide_row = dict(
        site="decide_sweeps", pod_lanes=P, node_lanes=N, valid_pods=int(p.valid.sum()),
        valid_nodes=int(n.valid.sum()), segments=GROUPS, bytes=nbytes, bound_ms=bound_ms,
        bound_by=bound_by, ms=graph_ms(decide_fn), plain_ms=graph_ms(decide_plain),
        # the one PyTorch call per site that computes its sums, summed
        library_ms=sum(r["library_ms"] for r in site_rows.values()),
        sites_ms=sum(r["ms"] for r in site_rows.values()),
        # the fixed cost of any one launch: PyTorch's own spin kernel, told
        # to spin for no cycles, timed the same way
        empty_launch_ms=graph_ms(lambda: torch.cuda._sleep(0)),
        launch_ms=device_ms(decide_fn), wrapper_launch_ms=device_ms(decide_wrapper),
        plain_launch_ms=device_ms(decide_plain))

    # ---- 6. profiles, after every timing, so that none of those runs with
    # the profiler's instrumentation attached
    for name, inputs in ticks:
        log(phase="decide_profile", tick=name,
            **decide_profile(backend, inputs, statistics.median(
                r["decide"] for r in samples[name]) * 1e3))
    for name, (kernel_fn, *_) in calls.items():
        site_rows[name]["kernel_profiler_ms"] = kernel_profiler_ms(kernel_fn)
        log(kernel_timing=site_rows[name])
    decide_row["kernel_profiler_ms"] = kernel_profiler_ms(decide_fn)
    log(kernel_timing=decide_row)

    # one decide launches the kernel once: the fused launch's numbers
    log(kernels=[{
        "name": "segsum",
        "route": "cuda",
        "source": "escalator_tpu_torch/ops/csrc/segsum.cu",
        "replaces": "escalator_tpu/ops/pallas_kernel.py:113",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": decide_row["ms"],
        "plain_ms": decide_row["plain_ms"],
        "bound_ms": decide_row["bound_ms"],
        "bound_by": decide_row["bound_by"],
        "library_ms": decide_row["library_ms"],
    }])
    print(card, flush=True)
    log(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                         "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
