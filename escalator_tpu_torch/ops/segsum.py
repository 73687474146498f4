"""Exact int64 per-segment sums of several columns in one sweep.

The port of ``escalator_tpu/ops/pallas_kernel.py`` ``fused_segment_sums``
(:177), whose Pallas kernel ``_agg_kernel`` (:113) this module's CUDA kernel,
``csrc/segsum.cu``, replaces. Same call signature and same output dict.

- A tensor on the card goes to the CUDA kernel: one launch sums every column,
  each warp merging its runs of equal ids before one 64-bit ``atomicAdd`` per
  run and column. Integer addition mod 2^64 is associative, so the result is
  bit-equal to :func:`fused_segment_sums_plain` on every input.
- A tensor on the CPU goes to :func:`fused_segment_sums_plain`, an int64
  ``index_add_`` per column. Any other device raises.

The id of every valid lane must lie in ``[0, num_segments)``; invalid lanes'
ids are never read. On the CPU the wrapper checks that before it sums. On the
card the kernel counts the valid lanes out of range into a one-element int64
tensor (``bad_ids``), and :func:`check_bad_ids` reads it back and raises: the
wrapper does that after its own launch, or a caller that passes its own
counter does it once for several launches, as the decide does.

Bound: bytes (each lane's valid flag, each valid lane's id and columns read
once, the ``[num_segments, columns]`` int64 output written once); the
source's note gives the numbers at the north-star shape.

``LAUNCHES`` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional

import torch

from escalator_tpu_torch.device import I32, I64
from escalator_tpu_torch.ops import _build

#: kernel launches so far in this process
LAUNCHES = 0

#: column capacity of one launch (int64 columns, count columns)
MAX_INT_COLUMNS = 8
MAX_COUNT_COLUMNS = 8

_PTRS = ctypes.c_void_p * max(MAX_INT_COLUMNS, MAX_COUNT_COLUMNS)


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
    if bad_ids is not None and (bad_ids.dtype != I64 or bad_ids.shape != (1,)
                                or bad_ids.device != ids.device):
        raise TypeError(f"bad_ids must be an int64 tensor of shape (1,) on {ids.device}")
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
