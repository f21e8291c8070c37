"""The suite's one thread rule, held: the root ``conftest.py`` gives each
pytest-xdist worker ``max(1, cores // workers)`` intra-op threads as
``OMP_NUM_THREADS``, keeps a value the caller set, and leaves the environment
as it found it outside xdist.

The first tests read the process they run in, whichever mode that is; the
last run the rule in fresh interpreters under each mode's environment, so
every branch is held whether or not this file runs under xdist."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

CONFTEST = Path(__file__).resolve().parent.parent / "conftest.py"
CORES = len(os.sched_getaffinity(0))


@pytest.fixture
def rule(request):
    """The root conftest module as pytest loaded it."""
    for plugin in request.config.pluginmanager.get_plugins():
        path = getattr(plugin, "__file__", None)
        if path and Path(path).resolve() == CONFTEST:
            return plugin
    raise AssertionError(f"{CONFTEST} was not loaded")


def _expected_env(rule):
    """``OMP_NUM_THREADS`` as the rule should have left it in this process."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if rule.CALLER_OMP_NUM_THREADS is not None or not workers:
        return rule.CALLER_OMP_NUM_THREADS
    return str(max(1, CORES // int(workers)))


def test_this_process_follows_the_rule(rule):
    want = _expected_env(rule)
    assert os.environ.get("OMP_NUM_THREADS") == want
    if want is not None and want.isdigit():
        assert torch.get_num_threads() == int(want)


def test_the_blas_pool_follows_the_rule(rule):
    want = _expected_env(rule)
    if want is None or not want.isdigit():
        return
    try:
        from threadpoolctl import threadpool_info
    except ImportError:
        return
    import numpy  # noqa: F401  (loads the BLAS whose pool is read)

    pools = [p["num_threads"] for p in threadpool_info() if p["user_api"] == "blas"]
    assert pools and set(pools) == {int(want)}, threadpool_info()


def test_a_subprocess_inherits_the_thread_count():
    code = "import os; print(os.environ.get('OMP_NUM_THREADS'))"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True).stdout.strip()
    assert out == str(os.environ.get("OMP_NUM_THREADS"))


def _run_rule(env: dict, torch_at=None) -> dict:
    """The rule in a fresh interpreter with ``env``, torch imported before
    or after it (or not at all); ``OMP_NUM_THREADS`` and torch's pool after."""
    code = "\n".join([
        "import json, os, runpy",
        "import torch" if torch_at == "before" else "",
        f"runpy.run_path({str(CONFTEST)!r})",
        "import torch" if torch_at == "after" else "",
        "print(json.dumps({'env': os.environ.get('OMP_NUM_THREADS'),",
        "                  'torch': torch.get_num_threads() if 'torch' in dir() else None}))",
    ])
    base = {k: v for k, v in os.environ.items()
            if k not in ("OMP_NUM_THREADS", "PYTEST_XDIST_WORKER_COUNT")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env={**base, **env})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("workers, torch_at", [(2, "before"), (6, "after"), (4 * CORES, None)])
def test_a_worker_gets_its_share_of_the_cores(workers, torch_at):
    share = max(1, CORES // workers)
    got = _run_rule({"PYTEST_XDIST_WORKER_COUNT": str(workers)}, torch_at)
    assert got == {"env": str(share), "torch": share if torch_at else None}


def test_a_value_the_caller_set_is_kept():
    got = _run_rule({"PYTEST_XDIST_WORKER_COUNT": "2", "OMP_NUM_THREADS": "3"})
    assert got == {"env": "3", "torch": None}


def test_outside_xdist_the_environment_is_left_alone():
    assert _run_rule({}) == {"env": None, "torch": None}
