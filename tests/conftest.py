"""Shared pytest configuration: the ``slow`` marker and ``--runslow`` gate.

Cluster-scale tests (the 1000-VM burst) are marked ``@pytest.mark.slow``
and skipped by default; run them with::

    PYTHONPATH=src python -m pytest --runslow -q

``scripts/ci.sh`` wraps the default (fast) tier-1 invocation so CI and
humans run exactly the same command.
"""
import pytest


def pytest_addoption(parser):
    parser.addoption(
        "--runslow",
        action="store_true",
        default=False,
        help="also run tests marked slow (e.g. the 1000-VM scale burst)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: cluster-scale test, skipped unless --runslow is given"
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips inside the test where "
        "torch.cuda.is_available() is false",
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="slow test: pass --runslow to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)
