"""The port's mesh layer held against the JAX package's.

* ``ShardingRules``: every param spec, ZeRO-1 optimizer-state spec, batch
  spec and (for prefill and decode cells) cache spec of every cell of
  ``configs.cells()``, on the production (16, 16) and (2, 16, 16) meshes,
  equal to the reference's on ``compat.abstract_mesh``, path for path.  No
  device is needed: the reference's shapes come from ``jax.eval_shape``,
  the port's from ``device="meta"`` tensors.  Each cell's config is the
  reference dry run's (``launch/dryrun.py::_cfg_for``: ``chunked``
  attention, grouped GQA decode, an int8 KV cache for decode cells),
  replicated here, since importing that module sets ``XLA_FLAGS``.
  jax 0.9's ``PartitionSpec`` turns a one-name tuple ``("data",)`` into
  ``"data"``; the port keeps the tuple, so both sides are compared after
  that normalisation.
* ``_translate`` for every logical name of ``logical_mapping()``, ``None``
  and an unknown name.
* ``constrain``: the same tensor object outside a context, inside one, with
  a rank that does not match; nested contexts restore the outer one; a
  spec naming an axis the mesh lacks, naming one twice, or longer than the
  tensor's rank raises.
"""
import dataclasses
import functools

import jax
import pytest
import torch

from repro.compat import abstract_mesh
from repro.configs import SHAPES, cells
from repro.configs import get_config as jget_config
from repro.data.synthetic import batch_specs as jbatch_specs
from repro.distributed import api as japi
from repro.distributed.sharding import ShardingRules as JRules
from repro.models import model_for as jmodel_for
from repro.optim.adamw import init_opt_state as jinit_opt_state
from repro_torch.configs import get_config
from repro_torch.data.synthetic import batch_specs
from repro_torch.distributed import api
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import NamedSharding, PartitionSpec, make_mesh, make_production_mesh
from repro_torch.models import model_for
from repro_torch.models.params import MetaGenerator, tree_leaves_with_path
from repro_torch.optim.adamw import init_opt_state

MESHES = {"16x16": False, "2x16x16": True}
CELLS = cells()


def _cfg_for(get, arch: str, kind: str):
    """``launch/dryrun.py::_cfg_for`` with no overrides."""
    kv = "int8" if kind == "decode" else "bf16"
    return dataclasses.replace(get(arch), attn_impl="chunked", kv_cache_dtype=kv,
                               gqa_decode="grouped")


def _norm(entry):
    """jax 0.9's normalisation of one ``PartitionSpec`` entry."""
    return entry[0] if isinstance(entry, tuple) and len(entry) == 1 else entry


def _specs(pairs) -> list:
    """(path as strings, spec entries normalised) for every leaf."""
    return [(tuple(str(k) for k in path), tuple(_norm(e) for e in s.spec)) for path, s in pairs]


def _jpairs(tree) -> list:
    out = []
    for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(k.key if hasattr(k, "key") else str(k.idx) for k in path)
        out.append((keys, s))
    return out


@functools.lru_cache(maxsize=None)
def _ref_rules(multi_pod: bool):
    shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else (
        (16, 16), ("data", "model"))
    return abstract_mesh(shape, axes)


@functools.lru_cache(maxsize=None)
def _port_mesh(multi_pod: bool):
    return make_production_mesh(multi_pod=multi_pod, device="cpu")


@functools.lru_cache(maxsize=None)
def _param_shapes(arch: str):
    """The reference's params and ZeRO-1 state as shape structs, the port's as
    meta tensors."""
    jparams = jax.eval_shape(jmodel_for(jget_config(arch)).init, jax.random.key(0))
    tparams = model_for(get_config(arch)).init(MetaGenerator())
    return (jparams, jax.eval_shape(jinit_opt_state, jparams)), (tparams, init_opt_state(tparams))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch, shape_name", [(a, s) for a, s, _ in CELLS],
                         ids=[f"{a}-{s}" for a, s, _ in CELLS])
def test_specs_equal_reference(arch, shape_name, mesh_name):
    multi_pod = MESHES[mesh_name]
    shape = SHAPES[shape_name]
    jcfg, tcfg = (_cfg_for(get, arch, shape.kind) for get in (jget_config, get_config))
    jrules = JRules(jcfg, _ref_rules(multi_pod))
    trules = ShardingRules(tcfg, _port_mesh(multi_pod))
    assert trules.dp == jrules.dp and trules.tp == jrules.tp and trules.dp_size == jrules.dp_size
    (jparams, jopt), (tparams, topt) = _param_shapes(arch)

    want = _specs(_jpairs(jrules.params_shardings(jparams)))
    got = _specs(tree_leaves_with_path(trules.params_shardings(tparams)))
    assert len(want) > 0 and got == want
    want = _specs(_jpairs(jrules.opt_shardings(jopt)))
    got = _specs(tree_leaves_with_path(trules.opt_shardings(topt)))
    assert got == want

    jb = jbatch_specs(jcfg, shape.seq_len, shape.global_batch, kind=shape.kind)
    tb = batch_specs(tcfg, shape.seq_len, shape.global_batch, kind=shape.kind)
    assert list(tb) == list(jb)
    for k in jb:
        assert tuple(tb[k].shape) == jb[k].shape
        assert _specs([((), trules.batch_shardings(tb)[k])]) == \
            _specs([((), jrules.batch_shardings(jb)[k])]), k

    if shape.kind == "train":
        return
    jcache = jax.eval_shape(lambda: jmodel_for(jcfg).init_cache(shape.global_batch, shape.seq_len))
    tcache = model_for(tcfg).init_cache(shape.global_batch, shape.seq_len, device="meta")
    want = _specs(_jpairs(jrules.cache_shardings(jcache)))
    got = _specs(tree_leaves_with_path(trules.cache_shardings(tcache)))
    assert len(want) > 0 and got == want
    assert [tuple(x.shape) for _, x in tree_leaves_with_path(tcache)] == \
        [x.shape for x in jax.tree.leaves(jcache)]


def test_one_name_tuples_kept_whole():
    """The port returns the reference code's ``("data",)``; jax 0.9 prints it
    as ``"data"``.  Equal entry by entry after the normalisation, and unequal
    to a spec that splits over a different axis."""
    rules = ShardingRules(get_config("stablelm_12b"), _port_mesh(False))
    base = rules.param_spec(("attn", "wq"), (5120, 32, 160))
    assert base == PartitionSpec(None, "model", None)
    z = rules.zero1_spec(base, (5120, 32, 160))
    assert z == PartitionSpec(("data",), "model", None) and z[0] == ("data",)
    assert rules.batch_spec("tokens", (256, 4096)) == PartitionSpec(("data",), None)
    multi = ShardingRules(get_config("stablelm_12b"), _port_mesh(True))
    assert multi.batch_spec("tokens", (256, 4096)) == PartitionSpec(("pod", "data"), None)
    assert PartitionSpec(("data",)) != PartitionSpec(("model",))
    assert PartitionSpec() != PartitionSpec(None) != PartitionSpec(None, None)


# ----------------------------------------------------------------------
# api: _translate, the context, constrain
# ----------------------------------------------------------------------
@pytest.mark.parametrize("multi_pod", [False, True], ids=list(MESHES))
def test_translate_equals_reference(multi_pod):
    cfg = "granite_moe_1b"
    jmap = JRules(jget_config(cfg), _ref_rules(multi_pod)).logical_mapping()
    tmap = ShardingRules(get_config(cfg), _port_mesh(multi_pod)).logical_mapping()
    assert tmap == jmap
    for name in [*jmap, None, "expert"]:
        assert api._translate(name, tmap) == japi._translate(name, jmap), name
    assert api._translate("expert", tmap) is None


def test_constrain_returns_the_same_tensor():
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    mapping = ShardingRules(get_config("granite_moe_1b"), mesh).logical_mapping()
    x = torch.randn(4, 3, 8)
    assert api.active_mesh() is None
    assert api.constrain(x, ("data", None, None)) is x
    with api.sharding_context(mesh, mapping):
        assert api.active_mesh() is mesh
        assert api.constrain(x, ("data", None, "model")) is x
        assert api.constrain(x, ("data", None)) is x  # rank mismatch: skipped
        assert api.constrain(x, ("model", "data", None)) is x
        inner = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
        with api.sharding_context(inner, {"data": ("pod", "data"), "model": ("model",)}):
            assert api.active_mesh() is inner
            assert api.constrain(x, ("data", None, "model")) is x
        assert api.active_mesh() is mesh
    assert api.active_mesh() is None


def test_context_restored_after_an_error():
    mesh = make_mesh((2, 1), ("data", "model"), device="cpu")
    with pytest.raises(RuntimeError):
        with api.sharding_context(mesh, {"data": ("data",)}):
            raise RuntimeError("inside")
    assert api.active_mesh() is None


def test_missing_or_repeated_axis_raises():
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    x = torch.zeros(4, 8)
    with api.sharding_context(mesh, {"data": ("pod", "data"), "model": ("model",)}):
        with pytest.raises(ValueError, match="pod"):
            api.constrain(x, ("data", None))
    with api.sharding_context(mesh, {"data": ("data",), "model": ("data",)}):
        with pytest.raises(ValueError, match="twice"):
            api.constrain(x, ("data", "model"))
    with pytest.raises(ValueError, match="expert"):
        NamedSharding(mesh, PartitionSpec("expert", None))
    with pytest.raises(ValueError, match="rank"):
        api.with_sharding_constraint(x, NamedSharding(mesh, PartitionSpec("data", None, None)))
    y = torch.zeros(4, 8, 2)
    assert api.with_sharding_constraint(y, NamedSharding(mesh, PartitionSpec("data"))) is y
    with pytest.raises(TypeError):
        PartitionSpec(3)
