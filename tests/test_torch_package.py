"""Package rules of the port: what it may import, and where it runs.

The port (``escalator_tpu_torch/`` and ``chip_smoke.py``) imports no ``jax``,
nothing of the JAX package, and none of ``yaml``, ``prometheus_client`` or
``grpc``, which the GPU machine does not have. Its entry points default to
``cuda:0`` and raise when CUDA is missing.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "escalator_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "escalator_tpu", "yaml", "prometheus_client", "grpc")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_nothing_forbidden(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    modules = [
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT_FILES
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, check=False)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_entry_points_need_cuda_by_default(monkeypatch):
    from escalator_tpu_torch.controller.backend import make_backend
    from escalator_tpu_torch.device import resolve_device
    from escalator_tpu_torch.interop import cluster_from_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_backend("torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cluster_from_numpy(object())
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_to_run_without_a_card():
    """No card: non-zero exit and no result line."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=120, check=False)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_chip_smoke_bound_counts_what_the_sweep_must_read():
    """The smoke's bound reads the valid flag of every lane but the id and the
    columns of the valid lanes only, each distinct tensor once."""
    chip_smoke = _chip_smoke()
    valid = torch.tensor([1, 0, 0, 1, 0, 0, 1, 0], dtype=torch.bool)
    ids = torch.zeros(8, dtype=torch.int32)
    ints = {"v": torch.ones(8, dtype=torch.int64)}
    counts = {"n": valid, "c": torch.ones(8, dtype=torch.bool)}
    bound_ms, bound_by, nbytes = chip_smoke.sweep_bound(ids, valid, ints, counts, 4)
    # 8 valid flags + 3 valid lanes x (4 B id + 8 B int + 1 B count) + 4 x 3 x 8 B out
    assert nbytes == 8 + 3 * 13 + 96
    assert bound_by == "bytes"
    assert bound_ms == nbytes / chip_smoke.PEAK_BYTES_PER_S * 1e3


def test_chip_smoke_decide_bound_counts_what_the_fused_launch_must_read():
    """The fused launch's bound reads every pod and node lane's valid flag, a
    valid pod's group, node, cpu and mem, a valid node's group, two flags,
    cpu and mem, and writes the [9, G] and [N] sums once."""
    chip_smoke = _chip_smoke()
    from escalator_tpu_torch.core.arrays import NodeArrays, PodArrays

    pv = torch.tensor([1, 1, 0, 1, 0, 0], dtype=torch.bool)
    nv = torch.tensor([1, 0, 1, 0], dtype=torch.bool)
    i32, i64, b = (lambda k, dt=dt: torch.zeros(k, dtype=dt)
                   for dt in (torch.int32, torch.int64, torch.bool))
    p = PodArrays(group=i32(6), cpu_milli=i64(6), mem_bytes=i64(6), node=i32(6), valid=pv)
    n = NodeArrays(group=i32(4), cpu_milli=i64(4), mem_bytes=i64(4), creation_ns=i64(4),
                   tainted=b(4), cordoned=b(4), no_delete=b(4), taint_time_sec=i64(4), valid=nv)
    bound_ms, bound_by, nbytes = chip_smoke.decide_bound(p, n, 3)
    # 6 + 4 valid flags, 3 pods x (4 + 4 + 8 + 8) B, 2 nodes x (4 + 1 + 1 + 8 + 8) B,
    # (9 x 3 + 4) x 8 B out
    assert nbytes == 10 + 3 * 24 + 2 * 22 + (9 * 3 + 4) * 8
    assert bound_by == "bytes"
    assert bound_ms == nbytes / chip_smoke.PEAK_BYTES_PER_S * 1e3
