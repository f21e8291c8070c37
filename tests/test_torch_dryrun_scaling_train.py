"""The dry run's layer extrapolation of a train step is exact.

For all ten smoke configs, each deepened so that its periodic stage repeats
five times (whisper: 5 decoder and 6 encoder layers), one microbatch: the
counts extrapolated from layer counts 2, 3 and 4 (a train step's bytes are
quadratic in the repeats: the backward of each repeat's slice of a stacked
param writes a zero-filled gradient of the whole stack) equal an unscaled
trace's, integer for integer, ZeRO-1 and tensor-parallel collectives
included.  The helpers and
the other kinds are in ``test_torch_dryrun_scaling.py``.
"""
import pytest

from repro_torch.configs import ARCH_IDS
from test_torch_dryrun_scaling import DEEPER, _assert_exact, _lower, smoke  # noqa: F401


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_layer_extrapolation_is_exact(arch):
    lowered = _lower(arch, "train", n_micro=1, n_layers=DEEPER[arch][0])
    assert lowered.variables and "n_micro" not in lowered.variables
    assert all(degree == 2 for _, _, degree in lowered.variables.values())
    counts = _assert_exact(lowered)
    assert counts["count:reduce-scatter"] > 0 and counts["count:all-gather"] > 0
    assert counts["zero1:count:reduce-scatter"] == counts["count:reduce-scatter"]
    assert counts["tp:count:all-reduce"] > 0
