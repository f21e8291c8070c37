"""The port's broadcast dry run held against the JAX package's.

For granite_moe_1b on the production (16, 16) mesh, 32 blocks, the four
schedules and int8 ``pipelined``: every deterministic field of
``run_one``'s result equals the reference's, ``collective_ops`` equals the
op counts the reference parses from its compiled HLO, and
``collective_bytes`` equals the reference's HLO bytes, halved for bf16:
XLA's CPU backend widens a bf16 collective to f32 (its optimized HLO reads
``f32[...] collective-permute(convert(...))``), so the reference counts
twice the bytes a card would move; int8 is not widened.

The reference runs once, in a subprocess: importing
``repro.launch.broadcast_dryrun`` forces 512 host devices through
``XLA_FLAGS``, which must not reach this process.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.distributed.broadcast import binomial_rounds, faasnet_rounds
from repro_torch.launch import broadcast_dryrun
from repro_torch.launch.hlo_analysis import LINK_BW

ROOT = Path(__file__).resolve().parent.parent
ARCH, MESH, BLOCKS = "granite_moe_1b", "single", 32
VARIANTS = [("naive", False), ("allgather", False), ("binomial", False), ("pipelined", False),
            ("pipelined", True)]
DETERMINISTIC = ("arch", "mesh", "schedule", "dp", "n_blocks", "payload_gb",
                 "per_device_shard_gb", "rounds", "serialized_bytes_per_link")

SCRIPT = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
from repro.launch import broadcast_dryrun  # forces 512 host devices first
out = [broadcast_dryrun.run_one(a, m, s, b, sys.argv[2], compress=c)
       for a, m, s, b, c in json.loads(sys.argv[3])]
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("broadcast_dryrun_ref")
    todo = [(ARCH, MESH, s, BLOCKS, c) for s, c in VARIANTS]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT / "src"), str(out),
                           json.dumps(todo)], capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("i", range(len(VARIANTS)),
                         ids=[s + ("_int8" if c else "") for s, c in VARIANTS])
def test_run_one_matches_reference(ref, tmp_path, i):
    schedule, compress = VARIANTS[i]
    want = ref[i]
    got = broadcast_dryrun.run_one(ARCH, MESH, schedule, BLOCKS, str(tmp_path), compress=compress)
    for key in DETERMINISTIC:
        assert got[key] == want[key], key
    assert got["collective_ops"] == want["hlo_collective_ops"]
    widening = 1 if compress else 2  # XLA's CPU backend runs bf16 collectives in f32
    assert got["collective_bytes"] * widening == want["hlo_collective_bytes"]
    assert got["modeled_time_s"] == got["serialized_bytes_per_link"] / LINK_BW
    written = tmp_path / f"{ARCH}__{MESH}__{got['schedule']}__b{BLOCKS}.json"
    assert json.loads(written.read_text()) == got


@pytest.mark.parametrize("mesh_kind, dp", [("single", 16), ("multi", 32)])
def test_rounds_follow_the_ports_round_lists(tmp_path, mesh_kind, dp):
    def rounds(schedule):
        return broadcast_dryrun.run_one(ARCH, mesh_kind, schedule, BLOCKS, str(tmp_path))["rounds"]

    assert rounds("pipelined") == len(faasnet_rounds(dp, BLOCKS))
    assert rounds("binomial") == len(binomial_rounds(dp))
    assert rounds("naive") == dp - 1
    assert rounds("allgather") == 1


def test_unknown_schedule_raises(tmp_path):
    with pytest.raises(ValueError):
        broadcast_dryrun.run_one(ARCH, MESH, "ring", BLOCKS, str(tmp_path))
