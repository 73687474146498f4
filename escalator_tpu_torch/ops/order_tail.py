"""The combined node-ordering sort (port of ``escalator_tpu/ops/order_tail.py:68-128``).

Every lane carries a selection-class major key — tainted first, untainted
second, everything else last — so one lexicographic sort puts the tainted
block (group asc, creation desc: the untaint order, reference
pkg/controller/sort.go:27-39) at the front and the untainted block (group asc,
victim primary, creation asc: the scale-down order, sort.go:12-24) right after
it.

The JAX package sorts the four keys with one unstable ``lax.sort``; the last
key is a unique lane key, so its result is the lexicographic order. Here that
order comes from stable sorts chained from the least significant key up, which
gives the same permutation.
"""

from __future__ import annotations

from typing import Tuple

import torch

from escalator_tpu_torch.device import I64


def node_selection_masks(valid, group, tainted, cordoned):
    """How node lanes classify for ordering/selection:
    ``(key_group, untainted_sel, tainted_sel)`` with invalid lanes keyed to group 0."""
    key_group = torch.where(valid, group, torch.zeros_like(group))
    untainted_sel = valid & ~tainted & ~cordoned
    tainted_sel = valid & tainted & ~cordoned
    return key_group, untainted_sel, tainted_sel


def order_sort_keys(
    group: torch.Tensor,           # int [L] group id per lane (invalid lanes -> 0)
    tainted_sel: torch.Tensor,     # bool [L]
    untainted_sel: torch.Tensor,   # bool [L]
    victim_primary: torch.Tensor,  # int64 [L] pods-remaining for emptiest_first, else 0
    creation_ns: torch.Tensor,     # int64 [L]
    num_groups: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The per-lane sort keys ``(major, k1, k2)``; ``major = class * G + group``."""
    zero = torch.zeros((), dtype=I64, device=group.device)
    one = torch.ones((), dtype=I64, device=group.device)
    two = torch.full((), 2, dtype=I64, device=group.device)
    lane_class = torch.where(tainted_sel, zero, torch.where(untainted_sel, one, two))
    major = lane_class * num_groups + group.to(I64)
    k1 = torch.where(tainted_sel, -creation_ns, victim_primary)
    k2 = torch.where(tainted_sel, zero, creation_ns)
    return major, k1, k2


def combined_order_sort(
    group: torch.Tensor,
    tainted_sel: torch.Tensor,
    untainted_sel: torch.Tensor,
    victim_primary: torch.Tensor,
    creation_ns: torch.Tensor,
    num_groups: int,
    lane_key: torch.Tensor,        # int64 [L] unique tie-break / payload (global index)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lanes sorted by ``(major, k1, k2, lane_key)``. Returns
    ``(sorted_major, sorted_lane_key)``."""
    major, k1, k2 = order_sort_keys(
        group, tainted_sel, untainted_sel, victim_primary, creation_ns, num_groups,
    )
    perm = torch.argsort(lane_key, stable=True)
    for key in (k2, k1, major):
        perm = perm[torch.argsort(key[perm], stable=True)]
    return major[perm], lane_key[perm]
