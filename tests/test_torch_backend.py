"""The port's packer and ``TorchBackend`` against the JAX package.

- ``pack_cluster`` of the port equals the JAX one field by field on the same
  objects (the port reads pods and nodes by attribute).
- ``TorchBackend(device="cpu")`` gives the same ``GroupDecision``s as the JAX
  package's ``JaxBackend``.
- Plugged into the controller of tests/test_controller.py, it reproduces the
  golden multi-tick trajectories of tests/test_backend_differential.py and
  passes the controller scenarios. The controller compares statuses with the
  JAX package's ``DecisionStatus``; the port's has the same integer values.
"""

import random
from dataclasses import fields

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from escalator_tpu.controller.backend import JaxBackend  # noqa: E402
from escalator_tpu.core import arrays as jarrays  # noqa: E402
from escalator_tpu.core import semantics as sem  # noqa: E402
from escalator_tpu_torch.controller.backend import TorchBackend, make_backend  # noqa: E402
from escalator_tpu_torch.core import arrays as tarrays  # noqa: E402
from tests import test_backend_differential as differential  # noqa: E402
from tests import test_controller as controller_scenarios  # noqa: E402
from tests.test_kernel_parity import NOW, random_group  # noqa: E402
from tests.test_torch_segsum import one_torch_thread  # noqa: E402,F401 (autouse)


def _groups(seed, count=12):
    rng = random.Random(seed)
    return [random_group(rng, gi) for gi in range(count)]


def _dry_view(groups, seed):
    """Dry-mode flags and taint trackers naming some of each group's nodes."""
    rng = random.Random(seed)
    flags = [rng.random() < 0.5 for _ in groups]
    trackers = [[n.name for n in nodes if rng.random() < 0.3] for _, nodes, _, _ in groups]
    return flags, trackers


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dry", [False, True])
def test_pack_cluster_matches_jax(seed, dry):
    groups = _groups(seed)
    flags, trackers = _dry_view(groups, seed) if dry else (None, None)
    pads = dict(pad_pods=512, pad_nodes=512, pad_groups=16)
    want = jarrays.pack_cluster(groups, flags, trackers, **pads)
    got = tarrays.pack_cluster(groups, flags, trackers, **pads)
    for section in ("groups", "pods", "nodes"):
        w, g = getattr(want, section), getattr(got, section)
        for f in fields(g):
            a, b = getattr(w, f.name), getattr(g, f.name)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f"{section}.{f.name}"


def _decision_key(gd):
    d = gd.decision
    return (
        {f.name: (int(v) if f.name == "status" else v)
         for f in fields(d) for v in [getattr(d, f.name)]},
        [n.name for n in gd.scale_down_order],
        [n.name for n in gd.untaint_order],
        [n.name for n in gd.reap_nodes],
        [n.name for n in gd.cordoned_nodes],
        gd.node_pods_remaining,
    )


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_torch_backend_matches_jax_backend(seed):
    groups = _groups(seed)
    flags, trackers = _dry_view(groups, seed)
    want = JaxBackend(impl="xla", overlap=False).decide(groups, NOW, flags, trackers)
    got = TorchBackend(device="cpu").decide(groups, NOW, flags, trackers)
    assert [_decision_key(g) for g in got] == [_decision_key(w) for w in want]


def test_torch_backend_records_its_decide():
    backend = make_backend("torch", device="cpu")
    backend.decide(_groups(6), NOW)
    assert backend.last_ordered is not None
    assert backend.last_out.status.dtype == torch.int32
    assert set(backend.phase_seconds) == {"pack", "to_device", "decide", "unpack"}


def test_packing_aware_group_is_refused():
    pods, nodes, cfg, state = _groups(7, count=1)[0]
    cfg.packing_aware = True
    with pytest.raises(NotImplementedError, match="binpack"):
        TorchBackend(device="cpu").decide([(pods, nodes, cfg, state)], NOW)


def test_make_backend_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown backend"):
        make_backend("jax", device="cpu")


@pytest.mark.parametrize("seed", differential.SEEDS)
def test_controller_trajectory_matches_golden(seed):
    want = differential._golden(seed)
    got = differential._trajectory(seed, lambda: TorchBackend(device="cpu"))
    assert got == want


SCENARIOS = [
    "test_scale_up_increases_provider",
    "test_locked_group_returns_requested",
    "test_convergence_after_cloud_fulfills",
    "test_scale_up_untaints_first",
    "test_scale_down_taints_oldest",
    "test_scale_down_respects_min",
    "test_reaper_deletes_after_grace",
    "test_reaper_respects_no_delete_annotation",
    "test_dry_mode_mutates_nothing",
    "test_forced_min_scale_up_untaints",
    "test_forced_min_scale_up_via_provider",
    "test_scale_up_from_zero_without_cache",
    "test_scale_up_from_zero_with_cache",
    "test_lister_error_skips_group",
    "test_provider_refresh_retries",
    "test_multi_tick_scale_down_lifecycle",
]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_controller_scenario(scenario):
    getattr(controller_scenarios, scenario)(TorchBackend(device="cpu"))


def test_decision_status_values_match_jax():
    from escalator_tpu_torch.core import semantics as tsem

    assert {s.name: int(s) for s in tsem.DecisionStatus} == {
        s.name: int(s) for s in sem.DecisionStatus}
    assert np.float64(tsem.MAX_FLOAT64) == np.float64(sem.MAX_FLOAT64)
