"""The port's decide against the JAX package's ``kernel.decide_jit``.

Both impls of the JAX decide (``xla``: scatter sums; ``pallas``: the fused
segment-sum kernel, interpreted on the CPU) see the same packed numpy cluster
that the port sees through ``interop.cluster_from_numpy``. Every decide field
must be bit-equal (``tobytes()``): the sums are integer and every float64 op
runs in the same order, so no tolerance is needed. Every case pads to one
shape so the JAX side compiles once per impl and program.
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from escalator_tpu.core import semantics as sem  # noqa: E402
from escalator_tpu.core.arrays import pack_cluster  # noqa: E402
from escalator_tpu.ops import kernel as jkernel  # noqa: E402
from escalator_tpu.testsupport.builders import (  # noqa: E402
    NodeOpts,
    PodOpts,
    build_test_node,
    build_test_nodes,
    build_test_pod,
    build_test_pods,
)
from escalator_tpu_torch import interop  # noqa: E402
from escalator_tpu_torch.ops import kernel as tkernel  # noqa: E402
from tests.test_kernel_parity import NOW, random_group  # noqa: E402
from tests.test_torch_segsum import one_torch_thread  # noqa: E402,F401 (autouse)

PADS = dict(pad_pods=1024, pad_nodes=1024, pad_groups=32)
FIELDS = [f for f in jkernel.DecisionArrays.__dataclass_fields__]


def _random_clusters(seed):
    rng = random.Random(seed)
    return [random_group(rng, gi) for gi in range(24)]


def _emptiest_first():
    """Mixed-mode batch: oldest_first and emptiest_first groups, with pods on
    some nodes (tests/test_scale_down_selection.py)."""
    groups = []
    for selection, pods_on in (("oldest_first", (2, 0, 1, 0)),
                               ("emptiest_first", (3, 0, 2, 0))):
        cfg = sem.GroupConfig(
            min_nodes=0, max_nodes=100, taint_lower_percent=30,
            taint_upper_percent=45, scale_up_percent=70, slow_removal_rate=1,
            fast_removal_rate=2, soft_delete_grace_sec=300,
            hard_delete_grace_sec=900, scale_down_selection=selection)
        nodes = [build_test_node(NodeOpts(
            name=f"{selection}-n{i}", cpu=4000, mem=16 * 10**9,
            creation_time_ns=(i + 1) * 10**9)) for i in range(4)]
        pods = [build_test_pod(PodOpts(
            name=f"{selection}-p{i}-{j}", cpu=[100], mem=[10**8],
            node_name=nodes[i].name))
            for i, count in enumerate(pods_on) for j in range(count)]
        groups.append((pods, nodes, cfg, sem.GroupState()))
    return groups


def _above_max():
    cfg = sem.GroupConfig(min_nodes=0, max_nodes=2, taint_lower_percent=30,
                          taint_upper_percent=45, scale_up_percent=70,
                          slow_removal_rate=1, fast_removal_rate=2)
    nodes = [build_test_node(NodeOpts(name=f"n{i}", cpu=4000, mem=16 * 10**9))
             for i in range(4)]
    pods = [build_test_pod(PodOpts(name=f"p{i}", cpu=[500], mem=[10**9]))
            for i in range(3)]
    return [(pods, nodes, cfg, sem.GroupState())]


def _zero_threshold():
    cfg = sem.GroupConfig(min_nodes=0, max_nodes=10, taint_lower_percent=0,
                          taint_upper_percent=0, scale_up_percent=0,
                          slow_removal_rate=1, fast_removal_rate=2)
    return [(build_test_pods(1, PodOpts(cpu=[100], mem=[100])),
             build_test_nodes(1, NodeOpts(cpu=1000, mem=1000)), cfg, sem.GroupState())]


def _huge_delta():
    cfg = sem.GroupConfig(min_nodes=0, max_nodes=10, taint_lower_percent=30,
                          taint_upper_percent=45, scale_up_percent=1,
                          slow_removal_rate=1, fast_removal_rate=2)
    nodes = build_test_nodes(1, NodeOpts(cpu=1, mem=1, tainted=True, taint_time_sec=1))
    pods = build_test_pods(1, PodOpts(cpu=[10**15], mem=[10**15]))
    return [(pods, nodes, cfg, sem.GroupState())]


def _float_order():
    cfg = sem.GroupConfig(min_nodes=0, max_nodes=10**6, taint_lower_percent=1,
                          taint_upper_percent=2, scale_up_percent=15,
                          slow_removal_rate=1, fast_removal_rate=2)
    nodes = build_test_nodes(543, NodeOpts(cpu=10, mem=10**6))
    pods = build_test_pods(1, PodOpts(cpu=[1632], mem=[10**5]))
    return [(pods, nodes, cfg, sem.GroupState())]


CASES = {
    "random0": lambda: _random_clusters(0),
    "random1": lambda: _random_clusters(1),
    "random2": lambda: _random_clusters(2),
    "random3": lambda: _random_clusters(3),
    "emptiest_first": _emptiest_first,
    "above_max": _above_max,
    "zero_threshold": _zero_threshold,
    "huge_delta": _huge_delta,
    "float_order": _float_order,
}


def _assert_same(want, got: dict, ctx: str):
    for f in FIELDS:
        w = np.asarray(getattr(want, f))
        g = got[f]
        assert g.dtype == w.dtype, f"{ctx}: {f} dtype {g.dtype} != {w.dtype}"
        assert g.tobytes() == w.tobytes(), f"{ctx}: {f} differs"


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_decide_matches_jax(case, impl):
    cluster_np = pack_cluster(CASES[case](), **PADS)
    cluster_t = interop.cluster_from_numpy(cluster_np, device="cpu")
    for with_orders in (True, False):
        want = jkernel.decide_jit(cluster_np, np.int64(NOW), impl=impl,
                                  with_orders=with_orders)
        got = interop.decision_to_numpy(
            tkernel.decide(cluster_t, NOW, with_orders=with_orders))
        _assert_same(want, got, f"{case}/{impl}/with_orders={with_orders}")


@pytest.mark.parametrize("case", ["random0", "emptiest_first", "above_max", "float_order"])
def test_lazy_orders_decide_matches_jax(case):
    """Same gate decision (ordered or not), same calls, same arrays."""
    cluster_np = pack_cluster(CASES[case](), **PADS)
    cluster_t = interop.cluster_from_numpy(cluster_np, device="cpu")
    tainted_any = bool((cluster_np.nodes.valid & cluster_np.nodes.tainted).any())
    jcalls, tcalls = [], []

    def jdispatch(w):
        jcalls.append(w)
        return jkernel.decide_jit(cluster_np, np.int64(NOW), with_orders=w)

    def tdispatch(w):
        tcalls.append(w)
        return tkernel.decide(cluster_t, NOW, with_orders=w)

    want, want_ordered = jkernel.lazy_orders_decide(jdispatch, tainted_any)
    got, got_ordered = tkernel.lazy_orders_decide(tdispatch, tainted_any)
    assert (got_ordered, tcalls) == (want_ordered, jcalls)
    _assert_same(want, interop.decision_to_numpy(got), case)


def test_decide_on_sparse_interleaved_layout():
    """A layout the packer never makes (groups interleaved, invalid lanes
    scattered) still decides bit-equal to the JAX package."""
    from escalator_tpu.core.arrays import (
        NO_TAINT_TIME, ClusterArrays, GroupArrays, NodeArrays, PodArrays,
    )

    rng = np.random.default_rng(3)
    G, P, N = 32, 1024, 1024
    tainted = rng.random(N) < 0.3
    cluster_np = ClusterArrays(
        groups=GroupArrays(
            min_nodes=rng.integers(0, 3, G).astype(np.int32),
            max_nodes=np.full(G, 10**6, np.int32),
            taint_lower=np.full(G, 30, np.int32),
            taint_upper=np.full(G, 45, np.int32),
            scale_up_thr=np.full(G, 70, np.int32),
            slow_rate=np.ones(G, np.int32),
            fast_rate=np.full(G, 2, np.int32),
            locked=rng.random(G) < 0.1,
            requested_nodes=rng.integers(0, 5, G).astype(np.int32),
            cached_cpu_milli=np.full(G, 4000, np.int64),
            cached_mem_bytes=np.full(G, 16 * 10**9, np.int64),
            soft_grace_sec=np.full(G, 300, np.int64),
            hard_grace_sec=np.full(G, 900, np.int64),
            emptiest=rng.random(G) < 0.5,
            valid=np.ones(G, bool),
        ),
        pods=PodArrays(
            group=rng.integers(0, G, P).astype(np.int32),
            cpu_milli=rng.integers(0, 16000, P).astype(np.int64),
            mem_bytes=rng.integers(0, 64 * 10**9, P).astype(np.int64),
            node=rng.integers(-1, N, P).astype(np.int32),
            valid=rng.random(P) < 0.95,
        ),
        nodes=NodeArrays(
            group=rng.integers(0, G, N).astype(np.int32),
            cpu_milli=np.full(N, 4000, np.int64),
            mem_bytes=np.full(N, 16 * 10**9, np.int64),
            creation_ns=rng.integers(1, 10**15, N).astype(np.int64),
            tainted=tainted,
            cordoned=(~tainted) & (rng.random(N) < 0.05),
            no_delete=rng.random(N) < 0.02,
            taint_time_sec=np.where(
                tainted, NOW - rng.integers(0, 2000, N), NO_TAINT_TIME).astype(np.int64),
            valid=rng.random(N) < 0.97,
        ),
    )
    want = jkernel.decide_jit(cluster_np, np.int64(NOW))
    got = tkernel.decide(interop.cluster_from_numpy(cluster_np, device="cpu"), NOW)
    _assert_same(want, interop.decision_to_numpy(got), "interleaved")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_decide_sweeps_match_jax_aggregates(case, impl):
    """The decide's one fused sweep (its plain version on the CPU), and the
    port's per-site ``aggregate_pods`` + ``aggregate_nodes``, against the JAX
    package's, bit for bit."""
    from escalator_tpu_torch.ops import segsum
    from tests.test_torch_segsum import _jax_aggregates

    cluster_np = pack_cluster(CASES[case](), **PADS)
    c = interop.cluster_from_numpy(cluster_np, device="cpu")
    G, N = PADS["pad_groups"], PADS["pad_nodes"]
    got = segsum.decide_sweeps(c.pods, c.nodes, G, N)
    # the per-site counterparts of the JAX functions, on the generic entry
    per_site = (*tkernel.aggregate_pods(c.pods, c.nodes.group, G, N),
                *tkernel.aggregate_nodes(c.nodes, G))
    want = _jax_aggregates(impl)(vars(cluster_np.pods), vars(cluster_np.nodes), G, N)
    assert tuple(got) == segsum.DECIDE_SUMS
    for name, site, w in zip(segsum.DECIDE_SUMS, per_site, want, strict=True):
        w = np.asarray(w).tobytes()
        assert got[name].numpy().tobytes() == w, f"{case}/{impl}: {name}"
        assert site.numpy().tobytes() == w, f"{case}/{impl}: per-site {name}"


def test_decide_runs_one_fused_sweep(monkeypatch):
    """decide sums through decide_sweeps once, with a shared counter, and
    never through the per-site aggregate functions."""
    from escalator_tpu_torch.ops import segsum

    calls = []
    fused = segsum.decide_sweeps

    def counting(*args, **kwargs):
        calls.append(kwargs.get("bad_ids") is not None)
        return fused(*args, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("decide called a per-site aggregate")

    monkeypatch.setattr(segsum, "decide_sweeps", counting)
    for name in ("aggregate_pods", "aggregate_nodes", "node_pods_remaining_sweep"):
        monkeypatch.setattr(tkernel, name, refuse)
    c = interop.cluster_from_numpy(pack_cluster(CASES["random0"](), **PADS), device="cpu")
    for with_orders in (True, False):
        tkernel.decide(c, NOW, with_orders=with_orders)
    assert calls == [True, True]
