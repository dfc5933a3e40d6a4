"""The port's sharding rules (``repro_torch/launch/{mesh,sharding,
shardctx}.py``) against the reference's ``repro/launch/sharding.py``:
every spec equal, leaf for leaf and path for path, for all ten
architectures on the production meshes (16 x 16 and 2 x 16 x 16, the
reference's as ``jax.sharding.AbstractMesh``, the port's its own).  The
reference's trees come from ``jax.eval_shape``, the port's are ``meta``
tensors."""
import dataclasses

import jax
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import base as ref_cfg
from repro.launch import policy as ref_policy, sharding as ref_sharding
from repro.models import model as ref_model
from repro.train import optimizer as ref_opt

from repro_torch.configs import base as cfgbase
from repro_torch.launch import mesh as mesh_mod, policy, sharding, shardctx
from repro_torch.models import model
from repro_torch.train import optimizer as opt_mod, tree as tree_mod
from _torch_threads import one_intra_op_thread  # noqa: F401

MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    sizes, names = MESHES[name]
    return JaxAbstractMesh(sizes, names), mesh_mod.AbstractMesh(sizes, names)


def _norm(spec):
    """A spec as a plain tuple; a one-name tuple entry as the name (JAX's
    ``PartitionSpec`` stores ``("data",)`` as ``"data"``)."""
    return tuple(s[0] if isinstance(s, tuple) and len(s) == 1 else s
                 for s in spec)


def _ref_specs(tree):
    """{keystr path: spec} of a tree of the reference's NamedShardings."""
    return {jax.tree_util.keystr(p): _norm(s.spec) for p, s in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_specs(tree):
    return {p: _norm(s) for p, s in tree_mod.flatten(tree)}


_STRUCTS = {}


def _structs(arch):
    """(reference params and optimizer structs, the port's meta params and
    optimizer state) of the full-size configuration."""
    if arch not in _STRUCTS:
        rcfg, cfg = ref_cfg.get_config(arch), cfgbase.get_config(arch)
        params_s = jax.eval_shape(
            lambda: ref_model.init_params(jax.random.key(0), rcfg))
        opt_s = jax.eval_shape(lambda: ref_opt.init(rcfg.optimizer, params_s))
        params = model.init_params(cfg, device="meta")
        _STRUCTS[arch] = (params_s, opt_s, params,
                          opt_mod.init(cfg.optimizer, params))
    return _STRUCTS[arch]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", cfgbase.ARCH_NAMES)
def test_param_and_opt_specs_equal_the_reference(arch, mesh):
    """``param_shardings`` and ``opt_shardings``: the same leaves at the
    same paths with the same shapes, and the same spec at each."""
    jmesh, pmesh = _meshes(mesh)
    rcfg, cfg = ref_cfg.get_config(arch), cfgbase.get_config(arch)
    params_s, opt_s, params, opt_state = _structs(arch)
    for ref_tree, port_tree, ref_fn, port_fn in (
            (params_s, params, ref_sharding.param_shardings,
             sharding.param_shardings),
            (opt_s, opt_state, ref_sharding.opt_shardings,
             sharding.opt_shardings)):
        shapes = {jax.tree_util.keystr(p): tuple(l.shape) for p, l in
                  jax.tree_util.tree_flatten_with_path(ref_tree)[0]}
        assert shapes == {p: tuple(l.shape)
                          for p, l in tree_mod.flatten(port_tree)}
        specs = port_fn(cfg, pmesh, port_tree)
        assert _port_specs(specs) == _ref_specs(ref_fn(rcfg, jmesh, ref_tree))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", cfgbase.ARCH_NAMES)
def test_cache_and_batch_specs_equal_the_reference(arch, mesh):
    """``cache_shardings`` at decode_32k and long_500k (where it applies),
    and ``batch_shardings`` of every shape's inputs."""
    jmesh, pmesh = _meshes(mesh)
    rcfg, cfg = ref_cfg.get_config(arch), cfgbase.get_config(arch)
    for name in ("decode_32k", "long_500k"):
        shape = cfgbase.SHAPES[name]
        if not cfgbase.shape_applicable(cfg, shape):
            continue
        rc = ref_cfg.cache_specs(rcfg, shape.global_batch, shape.seq_len)
        pc = cfgbase.cache_specs(cfg, shape.global_batch, shape.seq_len)
        assert _port_specs(sharding.cache_shardings(cfg, pmesh, pc)) == \
            _ref_specs(ref_sharding.cache_shardings(rcfg, jmesh, rc))
    for name, shape in cfgbase.SHAPES.items():
        rspec = ref_cfg.input_specs(rcfg, ref_cfg.SHAPES[name])
        pspec = cfgbase.input_specs(cfg, shape)
        rspec.pop("cache", None)
        pspec.pop("cache", None)
        assert _port_specs(sharding.batch_shardings(cfg, pmesh, pspec)) == \
            _ref_specs(ref_sharding.batch_shardings(rcfg, jmesh, rspec))


ROLES = [("hidden", (256, 4096, 2560)), ("hidden", (1, 1, 2560)),
         ("hidden", (1, 32768, 4096)), ("logits", (256, 512, 151936)),
         ("logits", (32, 1, 51865)), ("gathered_weight", (2560, 9728)),
         ("gathered_weight", (128, 7168, 4864)), ("gathered_weight", (2560,)),
         ("gathered_weight", (3, 2560, 9728)), ("other", (4, 4, 4))]


@pytest.mark.parametrize("knobs", [{}, {"hidden_spec": "dshard"},
                                   {"hidden_spec": "off"},
                                   {"seq_parallel_hidden": True}])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_activation_rules_equal_the_reference(mesh, knobs):
    jmesh, pmesh = _meshes(mesh)
    cfg, rcfg = cfgbase.get_config("qwen3_4b"), ref_cfg.get_config("qwen3_4b")
    rpol = dataclasses.replace(ref_policy.PerfPolicy(), **knobs)
    ppol = dataclasses.replace(policy.PerfPolicy(), **knobs)
    with ref_policy.use(rpol), policy.use(ppol):
        rrule = ref_sharding.activation_rules(rcfg, jmesh)
        prule = sharding.activation_rules(cfg, pmesh)
        for role, shape in ROLES:
            want, got = rrule(role, shape), prule(role, shape)
            assert (got is None) == (want is None), (role, shape)
            if want is not None:
                assert _norm(got) == _norm(want), (role, shape)


@pytest.mark.parametrize("knobs", [{"param_tp_only": True},
                                   {"decode_replicate_small_cache": True,
                                    "small_cache_bytes": 1 << 40}])
def test_policy_fields_steer_the_rules_as_the_reference(knobs):
    """``param_tp_only`` drops the "data" shard of block weights;
    ``decode_replicate_small_cache`` replicates a cache under the size."""
    jmesh, pmesh = _meshes("pod1")
    arch = "h2o_danube_3_4b"
    rcfg, cfg = ref_cfg.get_config(arch), cfgbase.get_config(arch)
    params_s, _, params, _ = _structs(arch)
    shape = cfgbase.SHAPES["long_500k"]
    rc = ref_cfg.cache_specs(rcfg, shape.global_batch, shape.seq_len)
    pc = cfgbase.cache_specs(cfg, shape.global_batch, shape.seq_len)
    rpol = dataclasses.replace(ref_policy.PerfPolicy(), **knobs)
    ppol = dataclasses.replace(policy.PerfPolicy(), **knobs)
    with ref_policy.use(rpol), policy.use(ppol):
        assert _port_specs(sharding.param_shardings(cfg, pmesh, params)) == \
            _ref_specs(ref_sharding.param_shardings(rcfg, jmesh, params_s))
        assert _port_specs(sharding.cache_shardings(cfg, pmesh, pc)) == \
            _ref_specs(ref_sharding.cache_shardings(rcfg, jmesh, rc))


# the reference's named cases (tests/test_sharding_rules.py)


def test_moe_experts_on_model_axis():
    _, mesh = _meshes("pod1")
    spec = sharding.spec_for_param(
        "['blocks'][0]['moe']['w_gate']", (35, 128, 7168, 4864), mesh)
    assert spec[1] == "model"                   # expert parallelism


def test_embed_vocab_fallback_when_indivisible():
    """whisper vocab 51865 is not divisible by 16 -> d_model gets the
    axis."""
    _, mesh = _meshes("pod1")
    spec = sharding.spec_for_param("['embed']", (51865, 1024), mesh)
    assert spec[0] is None
    spec = sharding.spec_for_param("['lm_head']", (1024, 51865), mesh)
    assert spec == sharding.P("model", None)


def test_batch_sharding_replicates_batch1():
    cfg = cfgbase.get_config("xlstm_125m")
    _, mesh = _meshes("pod1")
    struct = {"token": torch.empty((1, 1), dtype=torch.int32,
                                   device="meta")}
    sh = sharding.batch_shardings(cfg, mesh, struct)
    assert sh["token"] == sharding.P(None, None)


@pytest.mark.parametrize("arch", cfgbase.ARCH_NAMES)
@pytest.mark.parametrize("multi_pod", [False, True])
def test_param_and_opt_specs_divide(arch, multi_pod):
    """Every assigned axis divides its dimension (the reference's
    ``test_param_and_opt_specs_divide``), through ``per_device_bytes``."""
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    cfg = cfgbase.get_config(arch)
    _, _, params, opt_state = _structs(arch)
    for tree, fn in ((params, sharding.param_shardings),
                     (opt_state, sharding.opt_shardings)):
        specs = fn(cfg, mesh, tree)
        whole = sum(l.numel() * l.element_size()
                    for l in tree_mod.leaves(tree))
        share = sharding.per_device_bytes(tree, specs, mesh)
        assert whole / mesh.size <= share < whole


@pytest.mark.parametrize("arch", cfgbase.ARCH_NAMES)
def test_cache_specs_divide(arch):
    """The reference's ``test_cache_specs_divide``: every cache spec at
    decode_32k and long_500k splits its dimension evenly."""
    cfg = cfgbase.get_config(arch)
    mesh = mesh_mod.make_production_mesh()
    for name in ("decode_32k", "long_500k"):
        shape = cfgbase.SHAPES[name]
        if not cfgbase.shape_applicable(cfg, shape):
            continue
        cache = cfgbase.cache_specs(cfg, shape.global_batch, shape.seq_len)
        specs = sharding.cache_shardings(cfg, mesh, cache)
        for leaf, spec in zip(tree_mod.leaves(cache),
                              tree_mod.leaves(specs)):
            sharding.shard_shape(tuple(leaf.shape), spec, mesh)


# ---------------------------------------------------------------------------
# meshes, shard shapes and the recording constraint
# ---------------------------------------------------------------------------


def test_meshes_follow_the_reference():
    m = mesh_mod.make_production_mesh()
    assert (m.axis_sizes, m.axis_names, m.size) == ((16, 16),
                                                    ("data", "model"), 256)
    m = mesh_mod.make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512
    assert mesh_mod.batch_axes(m) == ("pod", "data")
    assert mesh_mod.model_axis(m) == "model"
    assert mesh_mod.make_test_mesh(8, multi_pod=True).axis_sizes == (2, 2, 2)
    assert mesh_mod.make_test_mesh(8).axis_sizes == (2, 4)
    assert mesh_mod.make_test_mesh(2).axis_sizes == (1, 2)
    card = mesh_mod.card_mesh()
    assert card.size == 1 and mesh_mod.batch_axes(card) == ("data",)


def test_shard_shape_and_per_device_bytes():
    m = mesh_mod.make_production_mesh(multi_pod=True)
    P = sharding.P
    assert sharding.shard_shape((64, 32, 8), P(("pod", "data"), "model",
                                               None), m) == (2, 2, 8)
    assert sharding.shard_shape((5, 7), P(None, None), m) == (5, 7)
    with pytest.raises(ValueError):
        sharding.shard_shape((5, 16), P("model", None), m)
    tree = {"a": torch.empty((32, 16), dtype=torch.bfloat16, device="meta"),
            "b": [torch.empty((4,), device="meta")]}
    specs = {"a": P("data", "model"), "b": [P(None)]}
    assert sharding.per_device_bytes(tree, specs, m) == 2 * 1 * 2 + 4 * 4


def test_constrain_records_each_roles_spec_and_returns_its_input():
    _, mesh = _meshes("pod1")
    cfg = cfgbase.reduced(cfgbase.get_config("qwen3_4b"))
    x = torch.zeros(16, 8, 4)
    assert shardctx.constrain(x, "hidden") is x           # no rules: no-op
    with shardctx.rules(sharding.activation_rules(cfg, mesh)) as seen:
        assert shardctx.constrain(x, "hidden") is x
        shardctx.constrain(x, "hidden")
        shardctx.constrain(torch.zeros(16, 4, 512), "logits")
    P = sharding.P
    assert seen == {
        "hidden": {"calls": 2, "specs": [repr(P(("data",), None, None))]},
        "logits": {"calls": 1, "specs": [repr(P(("data",), None, "model"))]}}
