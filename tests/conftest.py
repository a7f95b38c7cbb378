"""Shared test fixtures: subprocess runner for multi-device programs,
smoke-model factories, and the tier-2 gate.

Tier structure:
  * tier-1 — everything collected by plain ``pytest -q`` (fast; the
    CI matrix runs it on legacy AND modern jax).
  * tier-2 — ``@pytest.mark.tier2`` convergence-harness tests (8-way
    simulated cluster, hundreds of real training steps). Skipped by
    default; enable with ``--run-tier2`` or ``RUN_TIER2=1``.

Multi-device tests need ``--xla_force_host_platform_device_count`` set
before jax initializes, so they run their programs in a subprocess via the
``run_prog`` fixture (the main pytest process keeps its single-device
view, per the project rule of never forcing device counts globally).
"""
import dataclasses
import os
import subprocess
import sys

import pytest

from harness.cluster import subprocess_env

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


def pytest_addoption(parser):
    parser.addoption(
        "--run-tier2", action="store_true", default=False,
        help="run tier-2 convergence-harness tests (slow, 8-way simulated "
             "cluster)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "tier2: slow simulated-cluster convergence tests (enable with "
        "--run-tier2 or RUN_TIER2=1)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the PyTorch port's kernels); the test "
        "skips itself when torch.cuda.is_available() is false")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--run-tier2") or os.environ.get("RUN_TIER2") == "1":
        return
    skip = pytest.mark.skip(
        reason="tier-2: enable with --run-tier2 or RUN_TIER2=1")
    for item in items:
        if "tier2" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def run_prog():
    """Run a standalone test program in a subprocess with src+tests on
    PYTHONPATH; asserts exit 0 and an ``OK`` line on stdout."""
    def _run(prog_path: str, *args: str, timeout: int = 900) -> str:
        proc = subprocess.run(
            [sys.executable, prog_path, *args],
            capture_output=True, text=True, env=subprocess_env(),
            timeout=timeout)
        if proc.returncode != 0:
            raise AssertionError(
                f"{os.path.basename(prog_path)} {' '.join(args)} failed:\n"
                f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr[-3000:]}")
        assert "OK" in proc.stdout
        return proc.stdout
    return _run


@pytest.fixture(autouse=True, scope="module")
def _bound_jax_executable_cache():
    """Drop jax's compiled-executable caches after every test module.

    The full suite compiles thousands of distinct programs in one
    process; left unbounded, the accumulated executables eventually
    segfault XLA:CPU inside ``backend_compile`` (observed at
    ``moe.py _dispatch_scatter`` via test_model_invariants — the
    victim, not the culprit: every module passes in isolation).
    Per-module cache clearing keeps in-process state bounded; tests
    that assert on cache/compile behavior do so within one module.
    """
    yield
    import jax
    jax.clear_caches()


@pytest.fixture
def smoke_config():
    """``smoke_config(arch, **overrides)`` — reduced ModelConfig."""
    from repro.configs import get_config

    def _cfg(arch: str, **overrides):
        cfg = get_config(arch, smoke=True)
        return dataclasses.replace(cfg, **overrides) if overrides else cfg
    return _cfg


@pytest.fixture
def smoke_model(smoke_config):
    """``smoke_model(arch, **overrides)`` — Model over the smoke config."""
    from repro.models.registry import get_model

    def _model(arch: str, **overrides):
        return get_model(smoke_config(arch, **overrides))
    return _model
