"""The port stands alone: no module of kueue_oss_tpu_torch/ and not
chip_smoke.py imports jax, jaxlib or the JAX package, and the port
imports and drains (lean, FULL, fair sharing and admission fair
sharing) with those modules blocked."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "kueue_oss_tpu"}


def _sources():
    # _build/ holds generated kernel builds (gitignored), not sources
    files = sorted(p for p in (ROOT / "kueue_oss_tpu_torch").rglob("*.py")
                   if "_build" not in p.relative_to(ROOT).parts)
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {str(p.relative_to(ROOT)) for p in _sources()}
    assert "kueue_oss_tpu_torch/solver/engine.py" in names
    assert "kueue_oss_tpu_torch/solver/full_kernels.py" in names
    assert "kueue_oss_tpu_torch/core/eviction.py" in names
    assert "kueue_oss_tpu_torch/solver/fair_kernels.py" in names
    assert "kueue_oss_tpu_torch/core/afs.py" in names
    assert "chip_smoke.py" in names
    # the exact-name comparison lets the port's own name through
    assert "kueue_oss_tpu_torch" not in FORBIDDEN


def test_port_drains_with_jax_blocked():
    script = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "kueue_oss_tpu"):
            sys.modules[name] = None  # any import of them now fails
        from kueue_oss_tpu_torch.api import types
        from kueue_oss_tpu_torch.core.queue_manager import QueueManager
        from kueue_oss_tpu_torch.core.store import Store
        from kueue_oss_tpu_torch.scenarios import tas_drain_store
        from kueue_oss_tpu_torch.solver.engine import SolverEngine
        import chip_smoke  # noqa: F401

        store = tas_drain_store(types, Store, n_racks=2, n_hosts=4,
                                n_cohorts=1, n_cqs=2, n_workloads=40)
        result = SolverEngine(store, QueueManager(store),
                              device="cpu").drain()
        assert result.admitted > 0, result
        # and the FULL drain (preemption), through its eviction path
        from kueue_oss_tpu_torch.scenarios import baseline_preempt_store
        store, wave1, wave2 = baseline_preempt_store(
            types, Store, n_cohorts=1, cqs_per_cohort=2, scale=0.05)
        engine = SolverEngine(store, QueueManager(store), device="cpu")
        for wave in (wave1, wave2):
            for wl in wave:
                store.add_workload(wl)
            full = engine.drain()
        assert full.evicted > 0, full
        # fair sharing and admission fair sharing
        from kueue_oss_tpu_torch.core.afs import AfsManager
        from kueue_oss_tpu_torch.scenarios import (
            afs_baseline_store, fair_reclaim_store)
        store, wave1, wave2 = fair_reclaim_store(
            types, Store, n_cohorts=1, scale=0.05)
        engine = SolverEngine(store, QueueManager(store), device="cpu",
                              enable_fair_sharing=True)
        for wave in (wave1, wave2):
            for wl in wave:
                store.add_workload(wl)
            fair = engine.drain()
        assert fair.full_stats.entry_picks > 0, fair
        store, afs, backlog = afs_baseline_store(
            types, Store, AfsManager, n_cohorts=1, scale=0.05)
        for wl in backlog:
            store.add_workload(wl)
        afs_result = SolverEngine(store, QueueManager(store, afs=afs),
                                  device="cpu").drain(now=60.0)
        assert afs_result.admitted > 0, afs_result
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "kueue_oss_tpu")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print("admitted", result.admitted)
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "admitted" in proc.stdout
