"""The device a benchmark of ``benchmarks_torch/`` runs on.

Every script there takes ``--device`` (``cuda`` by default), checks it with
:func:`require` before its first run, counts K1's launches of each run with
:func:`k1_launches`, and writes :func:`describe`'s block into its artifact
under ``device``: the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints them
(``"cpu"`` for both on the CPU), the torch version and those launch counts.
"""
from __future__ import annotations

import contextlib
import subprocess

import torch


def require(device: str) -> None:
    """Raise when ``device`` is a CUDA device and CUDA is not available.

    On a card, also build and load the cap-chain kernel library (K1) and
    start CUDA, so that no timed run pays for ``nvcc`` or the context.
    """
    if torch.device(device).type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"asked for device {device!r}, but CUDA is not available; "
            "pass --device cpu to run the kernels' plain versions"
        )
    from repro_torch.kernels import _build

    torch.cuda.init()
    _build.library("cap_chain")


def describe(device: str, launches: dict) -> dict:
    """The artifact's ``device`` block: the card, torch, K1's launches."""
    block = {"name": "cpu", "power_limit": "cpu", "torch": torch.__version__}
    if torch.device(device).type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        name, power = (s.strip() for s in smi.rsplit(",", 1))
        block.update(name=name, power_limit=power, cuda=torch.version.cuda)
    return {**block, "k1_launches": dict(launches)}


@contextlib.contextmanager
def k1_launches(into: dict, run: str):
    """Add K1's launches inside the block to ``into[run]``.

    The count is a difference of the wrapper's counter, which is never
    reset here, so a caller may also read it around a whole script.  The
    plain version on the CPU counts nothing.
    """
    from repro_torch.kernels import cap_chain

    before = cap_chain.cap_chain_rates.launches
    try:
        yield
    finally:
        into[run] = into.get(run, 0) + cap_chain.cap_chain_rates.launches - before
