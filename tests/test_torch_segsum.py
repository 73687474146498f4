"""The port's segment sum against the Pallas kernel and a numpy reference.

On the CPU the wrapper runs its plain version (an int64 ``index_add_`` per
column); the CUDA kernel is held to that plain version on the card by
``chip_smoke.py``. Here the plain version meets the JAX package's
``pallas_kernel.fused_segment_sums`` (interpreted on the CPU) and
``np.add.at`` on the layouts of tests/test_pallas_kernel.py. Bit-equality: the
sums are integer.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from escalator_tpu.ops import pallas_kernel as pk  # noqa: E402
from escalator_tpu_torch.ops import segsum  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread while a port test file runs: the suite runs
    files side by side in worker processes, and torch's default of a thread
    per core would crowd the other files' timing gates. Test files of the
    port import this fixture."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _sorted_ids(rng, P, G):
    counts = rng.multinomial(P, np.ones(G) / G)
    return np.repeat(np.arange(G, dtype=np.int32), counts)


def _sorted(P, G):
    rng = np.random.default_rng(P * 31 + G)
    ids = _sorted_ids(rng, P, G)
    valid = rng.random(P) < 0.9
    cpu = rng.integers(0, 2**40, P).astype(np.int64) * valid
    mem = rng.integers(0, 2**47, P).astype(np.int64) * valid
    return ids, valid, {"cpu": cpu, "mem": mem}, {"cnt": valid.copy()}, G


def _unsorted():
    rng = np.random.default_rng(7)
    P, G = 4000, 1024
    ids = rng.integers(0, G, P).astype(np.int32)
    return ids, np.ones(P, bool), {"cpu": rng.integers(0, 2**40, P).astype(np.int64)}, {}, G


def _slot_reuse():
    rng = np.random.default_rng(11)
    P, G = 12000, 2048
    ids = _sorted_ids(rng, P, G)
    valid = np.ones(P, bool)
    freed = rng.random(P) < 0.15
    valid[freed] = False
    reused = freed & (rng.random(P) < 0.5)
    ids[reused] = rng.integers(0, G, int(reused.sum())).astype(np.int32)
    valid[reused] = True
    cpu = rng.integers(0, 2**40, P).astype(np.int64) * valid
    mem = rng.integers(0, 2**47, P).astype(np.int64) * valid
    return ids, valid, {"cpu": cpu, "mem": mem}, {"cnt": valid.copy()}, G


def _tiny_groups():
    rng = np.random.default_rng(13)
    G = 4096
    ids = rng.permutation(G).astype(np.int32)
    return ids, np.ones(G, bool), {"cpu": rng.integers(0, 2**40, G).astype(np.int64)}, {}, G


def _big_values():
    rng = np.random.default_rng(5)
    ids = np.sort(rng.integers(0, 4, 600)).astype(np.int32)
    big = np.full(600, 2**50, np.int64) + rng.integers(0, 2**20, 600)
    return ids, np.ones(600, bool), {"v": big}, {}, 4


def _negative_values():
    rng = np.random.default_rng(6)
    P, G = 3000, 37
    ids = _sorted_ids(rng, P, G)
    vals = rng.integers(-(2**62), 2**62, P).astype(np.int64)
    return ids, np.ones(P, bool), {"v": vals, "w": -vals}, {"cnt": rng.random(P) < 0.5}, G


def _empty_gap():
    P = 1000
    ids = np.concatenate([np.zeros(P // 2, np.int32), np.full(P - P // 2, 1900, np.int32)])
    return ids, np.ones(P, bool), {"cpu": np.full(P, 12345, np.int64)}, {}, 2048


LAYOUTS = {
    "sorted-1x1": lambda: _sorted(1, 1),
    "sorted-100x4": lambda: _sorted(100, 4),
    "sorted-1333x7": lambda: _sorted(1333, 7),
    "sorted-5000x300": lambda: _sorted(5000, 300),
    "unsorted": _unsorted,
    "slot-reuse": _slot_reuse,
    "tiny-groups": _tiny_groups,
    "values-ge-2^48": _big_values,
    "negative-values": _negative_values,
    "empty-gap": _empty_gap,
}


def _numpy_ref(ids, valid, cols, G):
    out = {}
    for name, col in cols.items():
        out[name] = np.zeros(G, np.int64)
        np.add.at(out[name], ids[valid], col.astype(np.int64)[valid])
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plain_matches_pallas_and_numpy(layout):
    ids, valid, int_cols, cnt_cols, G = LAYOUTS[layout]()
    before = segsum.LAUNCHES
    got = segsum.fused_segment_sums(
        torch.from_numpy(ids), torch.from_numpy(valid),
        {k: torch.from_numpy(v) for k, v in int_cols.items()},
        {k: torch.from_numpy(v) for k, v in cnt_cols.items()},
        num_segments=G,
    )
    assert segsum.LAUNCHES == before  # CPU tensors never reach the kernel
    # the Pallas kernel's contract: values pre-masked by valid
    pallas = pk.fused_segment_sums(
        jnp.asarray(ids), jnp.asarray(valid),
        {k: jnp.asarray(v * valid) for k, v in int_cols.items()},
        {k: jnp.asarray(v & valid) for k, v in cnt_cols.items()},
        num_segments=G, interpret=True,
    )
    want = _numpy_ref(ids, valid, {**int_cols, **cnt_cols}, G)
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name].numpy()
        assert g.dtype == np.int64
        assert g.tobytes() == w.tobytes(), name
        assert np.asarray(pallas[name]).tobytes() == w.tobytes(), name


def _args(P=8, G=4):
    ids = torch.arange(P, dtype=torch.int32) % G
    return ids, torch.ones(P, dtype=torch.bool), {"v": torch.arange(P, dtype=torch.int64)}, {}


@pytest.mark.parametrize("bad,error", [
    ("ids_int64", TypeError), ("ids_out_of_range", ValueError), ("negative_id", ValueError),
    ("int_column_int32", TypeError), ("count_column_int", TypeError), ("shape", TypeError),
    ("non_contiguous", ValueError), ("too_many_columns", ValueError),
])
def test_wrapper_rejects_bad_input(bad, error):
    ids, valid, ints, counts = _args()
    if bad == "ids_int64":
        ids = ids.to(torch.int64)
    elif bad == "ids_out_of_range":
        ids = ids.clone()
        ids[3] = 4
    elif bad == "negative_id":
        ids = ids.clone()
        ids[0] = -1
    elif bad == "int_column_int32":
        ints = {"v": ints["v"].to(torch.int32)}
    elif bad == "count_column_int":
        counts = {"c": torch.ones(8, dtype=torch.int64)}
    elif bad == "shape":
        valid = torch.ones(7, dtype=torch.bool)
    elif bad == "non_contiguous":
        ints = {"v": torch.arange(16, dtype=torch.int64)[::2]}
    elif bad == "too_many_columns":
        ints = {f"v{i}": ints["v"] for i in range(segsum.MAX_INT_COLUMNS + 1)}
    with pytest.raises(error):
        segsum.fused_segment_sums(ids, valid, ints, counts, num_segments=4)


def test_wrapper_refuses_devices_without_an_implementation():
    ids, valid, ints, counts = _args()
    meta = {k: v.to("meta") for k, v in ints.items()}
    with pytest.raises(ValueError, match="no segment-sum implementation"):
        segsum.fused_segment_sums(ids.to("meta"), valid.to("meta"), meta, {}, num_segments=4)


def test_invalid_lanes_ids_are_never_read():
    """An invalid lane may carry any id, even one out of range."""
    ids, valid, ints, counts = _args()
    ids = ids.clone()
    ids[2], ids[5] = -7, 99
    valid = valid.clone()
    valid[2] = valid[5] = False
    want = _numpy_ref(ids.numpy(), valid.numpy(), {"v": ints["v"].numpy()}, 4)
    for fn in (segsum.fused_segment_sums, segsum.fused_segment_sums_plain):
        got = fn(ids, valid, ints, counts, 4)
        assert got["v"].numpy().tobytes() == want["v"].tobytes()


@pytest.mark.parametrize("count,raises", [(0, False), (1, True), (3, True)])
def test_check_bad_ids_raises_on_a_count(count, raises):
    """The counter a caller shares across launches (the kernel adds one per
    valid lane out of range) raises once read back, unless it is zero."""
    counter = segsum.new_bad_ids("cpu")
    counter += count
    if raises:
        with pytest.raises(ValueError, match=f"{count} valid lanes"):
            segsum.check_bad_ids(counter)
    else:
        segsum.check_bad_ids(counter)


def test_shared_counter_on_the_cpu():
    """On the CPU a bad id raises at once, whether or not a counter is passed,
    and a good call leaves the counter at zero; a malformed counter is refused."""
    ids, valid, ints, counts = _args()
    counter = segsum.new_bad_ids("cpu")
    segsum.fused_segment_sums(ids, valid, ints, counts, 4, bad_ids=counter)
    assert int(counter) == 0
    bad = ids.clone()
    bad[1] = 4
    with pytest.raises(ValueError, match="outside"):
        segsum.fused_segment_sums(bad, valid, ints, counts, 4, bad_ids=counter)
    with pytest.raises(TypeError, match="bad_ids"):
        segsum.fused_segment_sums(ids, valid, ints, counts, 4,
                                  bad_ids=torch.zeros(1, dtype=torch.int32))


# ---------------------------------------------------------------- decide_sweeps

import jax  # noqa: E402

import chip_smoke  # noqa: E402
from escalator_tpu.core import arrays as jarrays  # noqa: E402
from escalator_tpu.ops import kernel as jkernel  # noqa: E402

#: the edge layouts of chip_smoke.decide_layouts, at a small size
SMALL = dict(P=1024, N=1024, G=32, lane_counts=(1, 3, 33, 257))
DECIDE_LAYOUTS = [name for name, *_ in chip_smoke.decide_layouts(np.random.default_rng(0), **SMALL)]


def _decide_layout(name):
    for layout in chip_smoke.decide_layouts(np.random.default_rng(0), **SMALL):
        if layout[0] == name:
            return layout[1:]
    raise KeyError(name)


def _jax_fields(pods, nodes):
    """The numpy layout as the fields of the JAX package's PodArrays /
    NodeArrays (node fields the sweeps do not read are zero)."""
    N = len(nodes["valid"])
    extra = dict(creation_ns=np.zeros(N, np.int64), no_delete=np.zeros(N, bool),
                 taint_time_sec=np.zeros(N, np.int64))
    return dict(pods), {**nodes, **extra}


@functools.lru_cache(maxsize=None)
def _jax_aggregates(impl):
    """JAX ``aggregate_pods`` + ``aggregate_nodes`` on PodArrays / NodeArrays
    fields: the ten sums in ``segsum.DECIDE_SUMS`` order."""
    def sums(pod_fields, node_fields, G, N):
        pods, nodes = jarrays.PodArrays(**pod_fields), jarrays.NodeArrays(**node_fields)
        return (*jkernel.aggregate_pods(pods, nodes.group, G, N, impl),
                *jkernel.aggregate_nodes(nodes, G, impl))
    return jax.jit(sums, static_argnums=(2, 3))


def _assert_decide_sweeps_match_jax(p, n, jp, jn, G, impl):
    N = n.valid.numel()
    before = segsum.LAUNCHES
    got = segsum.decide_sweeps(p, n, G, N)
    assert segsum.LAUNCHES == before  # CPU tensors never reach the kernel
    plain = segsum.decide_sweeps_plain(p, n, G, N)
    want = _jax_aggregates(impl)(jp, jn, G, N)
    assert tuple(got) == tuple(plain) == segsum.DECIDE_SUMS
    for name, w in zip(segsum.DECIDE_SUMS, want, strict=True):
        w = np.asarray(w)
        assert got[name].numpy().tobytes() == w.tobytes(), name
        assert plain[name].numpy().tobytes() == w.tobytes(), name


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("layout", DECIDE_LAYOUTS)
def test_decide_sweeps_match_jax_aggregates_on_edge_layouts(layout, impl):
    """pods off a node, on another group's node, on an invalid node lane,
    garbage ids in padding lanes, values >= 2^48 and negative, every node
    tainted and/or cordoned, no valid lane, G = N = 1, uncounted pods on a
    node >= N (dropped), ragged lane counts: the one sweep on the CPU is
    bit-equal to the JAX package's two."""
    pods, nodes, G = _decide_layout(layout)
    p, n = chip_smoke.sweep_tensors(pods, nodes, "cpu")
    _assert_decide_sweeps_match_jax(p, n, *_jax_fields(pods, nodes), G, impl)


@pytest.mark.parametrize("layout", ["pod_group_ge_G", "node_group_ge_G",
                                    "counted_pod_on_node_ge_N"])
def test_decide_sweeps_raise_on_ids_out_of_range(layout):
    """A valid pod or node with group >= G, or a counted pod on a node >= N,
    raises; with a counter passed it raises before touching it."""
    layouts = {name: rest for name, *rest in chip_smoke.decide_bad_layouts(np.random.default_rng(0))}
    pods, nodes, G = layouts[layout]
    p, n = chip_smoke.sweep_tensors(pods, nodes, "cpu")
    counter = segsum.new_bad_ids("cpu")
    with pytest.raises(ValueError, match="outside"):
        segsum.decide_sweeps(p, n, G, n.valid.numel(), bad_ids=counter)
    assert int(counter) == 0


def _small_decide_inputs():
    pods, nodes = chip_smoke.sweep_arrays(np.random.default_rng(4), 64, 32, 4)
    return (*chip_smoke.sweep_tensors(pods, nodes, "cpu"), 4, 32)


@pytest.mark.parametrize("bad,error", [
    ("pod_group_int64", TypeError), ("node_cpu_int32", TypeError), ("tainted_uint8", TypeError),
    ("pod_shape", TypeError), ("N_not_node_lanes", TypeError), ("N_zero", ValueError),
    ("negative_G", ValueError), ("non_contiguous", ValueError), ("counter_int32", TypeError),
])
def test_decide_sweeps_reject_bad_input(bad, error):
    p, n, G, N = _small_decide_inputs()
    kwargs = {}
    if bad == "pod_group_int64":
        p.group = p.group.to(torch.int64)
    elif bad == "node_cpu_int32":
        n.cpu_milli = n.cpu_milli.to(torch.int32)
    elif bad == "tainted_uint8":
        n.tainted = n.tainted.to(torch.uint8)
    elif bad == "pod_shape":
        p.node = p.node[:-1]
    elif bad == "N_not_node_lanes":
        N += 1
    elif bad == "N_zero":
        N = 0
    elif bad == "negative_G":
        G = -1
    elif bad == "non_contiguous":
        p.cpu_milli = torch.stack([p.cpu_milli, p.cpu_milli], 1)[:, 0]
    elif bad == "counter_int32":
        kwargs["bad_ids"] = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(error):
        segsum.decide_sweeps(p, n, G, N, **kwargs)


def test_decide_sweeps_refuse_devices_without_an_implementation():
    p, n, G, N = _small_decide_inputs()
    for section in (p, n):
        for name, value in vars(section).items():
            if value is not None:
                setattr(section, name, value.to("meta"))
    with pytest.raises(ValueError, match="no segment-sum implementation"):
        segsum.decide_sweeps(p, n, G, N)
