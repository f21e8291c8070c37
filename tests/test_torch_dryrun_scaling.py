"""The dry run's extrapolation is exact.

``launch/dryrun.py`` traces a cell at a few layer counts and at one and
two microbatches and extrapolates its counts (FLOPs, bytes, ZeRO-1 and
tensor-parallel collectives, prefill output bytes) to the full cell.  Here
the extrapolated counts equal an unscaled trace's, integer for integer, on
meta tensors, the tensor-parallel ones non-zero on the mesh's model axis of 2:

* every layer count, for all ten smoke configs, prefill and decode, each
  deepened so that its periodic stage repeats four times (nodes 2, 3;
  whisper with 4 and 5 decoder and encoder layers); the train step's layer
  counts are in ``test_torch_dryrun_scaling_train.py``;
* the microbatch count, every smoke config's train step in three
  microbatches (nodes 1, 2);
* both at once, deepseek_7b and granite_moe_1b;
* the grid is refused where a layer count of it would change which leaves
  the ZeRO-1 rule splits; traces are shared across meshes with the same
  model axis.

The mesh is (8, 2): no layer count traced or deepened here divides by dp 8.
"""
import math

import pytest

import repro_torch.configs
from repro_torch.configs import ARCH_IDS, ShapeConfig, get_smoke
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh

MESH = (8, 2)
KINDS = ("train", "prefill", "decode")
# n_layers giving the periodic stage five repeats (train) or four
DEEPER = {"stablelm_12b": (5, 4), "deepseek_7b": (5, 4), "gemma3_1b": (30, 24),
          "internlm2_20b": (5, 4), "jamba_v01_52b": (40, 32), "deepseek_moe_16b": (13, 13),
          "granite_moe_1b": (5, 4), "mamba2_130m": (5, 4), "llava_next_mistral_7b": (5, 4),
          "whisper_medium": (5, 4)}


@pytest.fixture(autouse=True)
def smoke(monkeypatch):
    """The dry run's configs are the smoke configs."""
    monkeypatch.setattr(repro_torch.configs, "get_config", get_smoke)


def _deeper(arch: str, n_layers: int | None) -> dict:
    """Overrides deepening the smoke config (whisper's encoder one deeper)."""
    if n_layers is None:
        return {}
    extra = {"encdec.encoder_layers": n_layers + 1} if get_smoke(arch).encdec else {}
    return {"n_layers": n_layers, **extra}


def _lower(arch, kind, n_micro, n_layers=None, mesh=MESH):
    shape = ShapeConfig(kind, 64, 2 * n_micro * 4 if kind == "train" else 8, kind)
    axes = ("data", "model") if len(mesh) == 2 else ("pod", "data", "model")
    lowered, _, _ = dryrun.lower_cell(arch, shape, make_mesh(mesh, axes, device="meta"),
                                      n_micro=n_micro, overrides=_deeper(arch, n_layers))
    return lowered


def _assert_exact(lowered):
    scaled, n_scaled = dryrun.trace_counts(lowered, scale=True)
    unscaled, n_unscaled = dryrun.trace_counts(lowered, scale=False)
    assert n_scaled == math.prod(d + 1 for _, _, d in lowered.variables.values())
    assert n_unscaled == 1
    assert scaled == unscaled
    return scaled


LAYER_CASES = [(a, k) for a in ARCH_IDS for k in ("prefill", "decode")]


@pytest.mark.parametrize("arch, kind", LAYER_CASES, ids=[f"{a}-{k}" for a, k in LAYER_CASES])
def test_layer_extrapolation_is_exact(arch, kind):
    depth = DEEPER[arch][0 if kind == "train" else 1]
    lowered = _lower(arch, kind, n_micro=1, n_layers=depth)
    assert lowered.variables and "n_micro" not in lowered.variables
    counts = _assert_exact(lowered)
    assert counts["tp:count:all-reduce"] > 0 and counts["tp:bytes:all-reduce"] > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_microbatch_extrapolation_is_exact(arch):
    lowered = _lower(arch, "train", n_micro=3)
    assert lowered.variables == {"n_micro": (1, 3, 1)}
    counts = _assert_exact(lowered)
    assert counts["tp:count:all-reduce"] > 0


@pytest.mark.parametrize("arch", ["deepseek_7b", "granite_moe_1b"])
def test_layers_and_microbatches_together(arch):
    lowered = _lower(arch, "train", n_micro=3, n_layers=5)
    assert "n_micro" in lowered.variables and len(lowered.variables) >= 2
    counts = _assert_exact(lowered)
    assert counts["tp:count:all-reduce"] > 0


def test_scaling_refuses_a_grid_that_splits_other_leaves():
    """jamba's smoke config at 5 repeats of its 8-layer pattern on dp 4: some
    stacked leaves divide by 4 only along their repeat dim, which the grid's
    4 repeats split and the full 5 do not."""
    lowered = _lower("jamba_v01_52b", "train", n_micro=2, n_layers=40, mesh=(4, 2))
    with pytest.raises(ValueError, match="trace unscaled"):
        dryrun.trace_counts(lowered)


def test_traces_are_shared_across_meshes_with_the_same_model_axis():
    cache: dict = {}
    for mesh, want_taken in (((4, 2), 2), ((2, 2, 2), 0)):
        lowered = _lower("deepseek_7b", "train", n_micro=4, n_layers=2, mesh=mesh)
        shared, taken = dryrun.trace_counts(lowered, traces=cache)
        assert taken == want_taken
        assert shared == dryrun.trace_counts(lowered)[0]
