import os
import random
import signal
import sys
import threading

# tests must see the default single CPU device (the 512-device override is
# the dry-run's business only — see src/repro/launch/dryrun.py); multi-device
# tests run in subprocesses that set XLA_FLAGS themselves.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
# the repo root, so tests can import the benchmarks package (the chaos
# tier drives traffic through benchmarks.loadgen)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
# the tests dir itself, for shared helpers (_hypo_compat)
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np   # noqa: E402
import pytest        # noqa: E402

# per-test wall-clock budget: generous for a single test, small enough
# that one wedged test cannot eat the quick lane's ~5-minute budget.
# Subprocess-mesh tests (all @slow) get a larger ceiling; override any
# test with @pytest.mark.timeout(seconds).
QUICK_TIMEOUT_S = 120
SLOW_TIMEOUT_S = 900


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running tests (subprocess meshes, large corpora); "
        "deselect with -m 'not slow' for the quick CI lane")
    config.addinivalue_line(
        "markers",
        "chaos: fault-injection serving-plane tests (replica kill / slow / "
        "partition under traffic); run in ci.sh --full, deselect with "
        "-m 'not chaos' for the quick lane")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's hand-written kernels); skips "
        "where there is none")
    config.addinivalue_line(
        "markers",
        "timeout(seconds): per-test wall-clock limit enforced via SIGALRM "
        f"(defaults: {QUICK_TIMEOUT_S}s, {SLOW_TIMEOUT_S}s for "
        "@slow/@chaos)")


@pytest.fixture(autouse=True)
def _deterministic_seeds():
    """Pin the global RNGs per test so runs are reproducible regardless of
    execution order (explicit default_rng(seed) uses are unaffected)."""
    random.seed(0)
    np.random.seed(0)
    yield


@pytest.fixture(autouse=True)
def _per_test_timeout(request):
    """SIGALRM-based per-test timeout (pytest-timeout is not available in
    the hermetic CI container). No-op off the main thread / off POSIX."""
    marker = request.node.get_closest_marker("timeout")
    if marker is not None:
        seconds = int(marker.args[0])
    elif (request.node.get_closest_marker("slow") is not None
          or request.node.get_closest_marker("chaos") is not None):
        seconds = SLOW_TIMEOUT_S
    else:
        seconds = QUICK_TIMEOUT_S
    if (not hasattr(signal, "SIGALRM")
            or threading.current_thread() is not threading.main_thread()):
        yield
        return

    def _on_timeout(signum, frame):
        pytest.fail(f"test exceeded the {seconds}s per-test timeout",
                    pytrace=False)

    old = signal.signal(signal.SIGALRM, _on_timeout)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
