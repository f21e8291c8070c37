"""``examples/torch_elastic_train.py`` on the CPU with ``jax`` and ``repro``
absent: it ends with ``OK``, training resumes from its step-10 checkpoint
after the failure at step 15, and section 3's serialized bytes are those of
the JAX package's ``faasnet_rounds(32, 32)`` and ``binomial_rounds(32)``."""
import math
import re
import subprocess
import sys
from pathlib import Path

from repro.distributed.broadcast import binomial_rounds, faasnet_rounds

ROOT = Path(__file__).resolve().parent.parent


def test_elastic_train_example_runs_with_jax_and_reference_blocked(tmp_path):
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.argv = ['torch_elastic_train.py', '--device', 'cpu',\n"
        f"            '--ckpt-dir', {str(tmp_path)!r}]\n"
        "runpy.run_path('examples/torch_elastic_train.py', run_name='__main__')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "OK"
    assert "injected failure at step 15 -> restarting from latest checkpoint" in out.stdout
    resumed = re.search(r"resumed from step (\d+), finished at (\d+), loss (\S+)", out.stdout)
    assert resumed and resumed.group(1, 2) == ("10", "20")
    assert math.isfinite(float(resumed.group(3)))
    payload = 2e9
    want = {
        "naive (registry analogue)": 31 * payload,
        "allgather": 32 * payload,
        "binomial tree": len(binomial_rounds(32)) * payload,
        "FaaSNet pipelined tree": len(faasnet_rounds(32, 32)) * payload / 32,
        "+ int8 compression": len(faasnet_rounds(32, 32)) * payload / 64,
    }
    got = {m.group(1).strip(): float(m.group(2)) for m in
           re.finditer(r"^\s+(.+?)\s+serialized\s+(\S+) GB", out.stdout, re.M)}
    assert got == {k: round(v / 1e9, 4) for k, v in want.items()}
