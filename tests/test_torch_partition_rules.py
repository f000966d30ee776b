"""The port's partition rules (idc_models_tpu_torch/partition.py, tp.py,
models/registry.py) against the JAX package's: the resolution cases of
tests/test_partition.py on the same paths, shapes and meshes, the port's
model trees yielding the JAX param paths and specs leaf for leaf, the
teaching errors, the channel rule, and shard_tree's blocks putting the
input back together. A mesh here is its shape alone: resolution and
cutting read no process group (tests/test_torch_dist.py gathers over
real ranks)."""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from idc_models_tpu import mesh as jmesh
from idc_models_tpu import partition as jpart
from idc_models_tpu import tp as jtp
from idc_models_tpu.models import registry as jregistry
from idc_models_tpu.models.lm import attention_lm
from idc_models_tpu.train import TrainState, rmsprop
from idc_models_tpu_torch import mesh as tmesh
from idc_models_tpu_torch import partition as tpart
from idc_models_tpu_torch import tp as ttp
from idc_models_tpu_torch.mesh import PartitionSpec as P
from idc_models_tpu_torch.models import mobilenet, registry, vgg
from idc_models_tpu_torch.models.lm import AttentionLM
from idc_models_tpu_torch.train.state import rmsprop as trmsprop


def _layout(**axes) -> tmesh.Mesh:
    """A mesh of these axis sizes, for resolution only."""
    return tmesh.Mesh(axes, None, {})


def _jax_flat_specs(rules, tree, mesh):
    leaves = jax.tree_util.tree_flatten_with_path(
        rules.specs(tree, mesh=mesh),
        is_leaf=lambda x: isinstance(x, JP))[0]
    return {jpart.path_str(p): tuple(s) for p, s in leaves}


# -- the resolution cases of tests/test_partition.py ------------------------

_D, _M, _C = "data", "model", "client"


def _cases():
    """(id, rules as (regex, spec entries) pairs, tree, mesh axes)."""
    return [
        ("first_match_right_align",
         ((r"special/kernel$", (None, _D)), (r"kernel$", (_M,)),
          (r".*", ())),
         {"special": {"kernel": np.zeros((8, 8))},
          "other": {"kernel": np.zeros((4, 8)), "bias": np.zeros((8,))}},
         {_D: 2, _M: 2}),
        ("adapt_drops_nondividing", ((r".*", (_D, _M)),),
         {"a": np.zeros((4, 6)), "b": np.zeros((4, 7)), "c": np.zeros(())},
         {_D: 2, _M: 2}),
        ("adapt_missing_axes", ((r".*", (_D, _M)),),
         {"a": np.zeros((4, 6)), "b": np.zeros((4, 7)), "c": np.zeros(())},
         {_C: 4}),
        ("scalars_need_no_rule", ((r"kernel$", ()),),
         {"kernel": np.zeros((4, 4)), "step": np.zeros(())},
         {_D: 2, _M: 2}),
        ("size_one_axis_dropped", ((r".*", (_D, (_M, _C))),),
         {"w": np.zeros((4, 8)), "one": np.zeros((1, 8))},
         {_D: 2, _M: 1, _C: 4}),
        ("tuple_entry", ((r"w$", ((_D, _M),)), (r".*", ())),
         {"w": np.zeros((8, 3)), "v": np.zeros((6,))},
         {_D: 2, _M: 2}),
        ("lm_rules_2x2", None, None, {_D: 2, _M: 2}),
        ("lm_rules_tp3", None, None, {_D: 1, _M: 3, "seq": 1}),
    ]


@pytest.mark.parametrize("case", _cases(), ids=[c[0] for c in _cases()])
def test_rules_resolve_as_jax_rules(case):
    """Every case of tests/test_partition.py:49-121 that resolves (first
    match, right alignment, mesh adaptation, scalars), plus tuple
    entries and the LM rules on the LM's tree, give the JAX package's
    specs, raw and adapted."""
    name, pairs, tree, axes = case
    if pairs is None:
        t_rules, j_rules = registry.LM_RULES, jregistry.LM_RULES
        tree = jax.eval_shape(lambda r: attention_lm(
            64, 64, embed_dim=32, num_heads=4, mlp_dim=48,
            num_blocks=2).init(r).params, jax.random.key(0))
        tree = jax.tree.map(lambda s: np.zeros(s.shape), tree)
    else:
        t_rules = tpart.PartitionRules([(rx, P(*e)) for rx, e in pairs])
        j_rules = jpart.PartitionRules([(rx, JP(*e)) for rx, e in pairs])
    jm = jmesh.make_mesh(axes)
    for mesh, jmesh_ in ((None, None), (_layout(**axes), jm)):
        got = {n: tuple(s) for n, s in tpart.tree_paths(
            t_rules.specs(tree, mesh=mesh))}
        assert got == _jax_flat_specs(j_rules, tree, jmesh_)


@pytest.mark.parametrize("what", ["unmatched", "dead", "over_rank",
                                  "empty", "not_a_spec", "bad_regex",
                                  "axis_twice"])
def test_errors_teach_as_in_jax(what):
    """The same PartitionError messages, word for word (the class name
    of the spec aside), and the check_dead opt-out."""
    mesh, jm = _layout(data=2, model=2), jmesh.make_mesh({_D: 2, _M: 2})

    def both(make, call):
        with pytest.raises(tpart.PartitionError) as got:
            call(make(tpart, P), mesh)
        with pytest.raises(jpart.PartitionError) as want:
            call(make(jpart, JP), jm)
        return str(got.value), str(want.value)

    calls = {
        "unmatched": (lambda m, S: m.PartitionRules(((r"kernel$", S()),)),
                      lambda r, mesh: r.specs({"bias": np.zeros((4,))})),
        "dead": (lambda m, S: m.PartitionRules(((r"ghost$", S(_D)),
                                                (r".*", S()))),
                 lambda r, mesh: r.specs({"kernel": np.zeros((4, 4))})),
        "over_rank": (lambda m, S: m.PartitionRules(((r".*", S(_D, _M)),)),
                      lambda r, mesh: r.specs({"bias": np.zeros((4,))},
                                              mesh=mesh)),
        "empty": (lambda m, S: m.PartitionRules(()), None),
        "not_a_spec": (lambda m, S: m.PartitionRules(((r".*", "data"),)),
                       None),
        "bad_regex": (lambda m, S: m.PartitionRules(((r"[", S()),)), None),
        "axis_twice": (lambda m, S: m.PartitionRules(((r".*",
                                                       S(_D, _D)),)),
                       None),
    }
    make, call = calls[what]
    got, want = both(make, call or (lambda r, mesh: r))
    if what == "not_a_spec":
        want = want.replace("a jax.sharding.PartitionSpec", "a "
                            "PartitionSpec")
    assert got == want
    if what == "dead":
        rules = make(tpart, P)
        assert rules.specs({"kernel": np.zeros((4, 4))},
                           check_dead=False)["kernel"] == P()


# -- the port's trees yield the JAX package's paths and specs ----------------


def _jax_state(model):
    """The JAX TrainState's structure (zeros) for `model`."""
    params, state = jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda r: (lambda v: (v.params, v.state))(
            model.init(r)), jax.random.key(0)))
    return TrainState(step=jnp.zeros((), jnp.int32), params=params,
                      model_state=state, opt_state=rmsprop(1e-3).init(params))


def _port_state(module):
    """The port's state tree with every trained parameter's moment made
    (one RMSprop step on zero gradients)."""
    opt = trmsprop(module, 1e-3)
    for p in module.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    return tpart.state_tree(module, opt)


_TREES = {
    "lm": (lambda: AttentionLM(64, 64, embed_dim=32, num_heads=4,
                               mlp_dim=48, num_blocks=2),
           lambda: attention_lm(64, 64, embed_dim=32, num_heads=4,
                                mlp_dim=48, num_blocks=2)),
    "vgg16": (lambda: vgg.vgg16(1), lambda: jregistry.get_model(
        "vgg16").build(1, 3)),
    "mobilenet_v2": (lambda: mobilenet.mobilenet_v2(1),
                     lambda: jregistry.get_model("mobilenet_v2").build(1, 3)),
}


@pytest.mark.parametrize("name", list(_TREES))
def test_port_trees_yield_jax_paths_and_specs(name):
    """The port's LM, VGG16 and MobileNetV2 state trees (params, BN
    statistics, RMSprop moments, step) have the JAX TrainState's leaf
    paths, and each leaf resolves to JAX's spec under the model's rules
    on a 2 x 2 ("data", "model") mesh -- the LM's optimizer moments
    sharded with their parameters."""
    port, jax_model = (f() for f in _TREES[name])
    tree = _port_state(port)
    want_state = _jax_state(jax_model)
    rules = registry.get_partition_rules("lm" if name == "lm" else name)
    j_rules = jregistry.get_partition_rules("lm" if name == "lm" else name)
    got = {n: tuple(s) for n, s in tpart.tree_paths(
        rules.specs(tree, mesh=_layout(data=2, model=2)))}
    want = _jax_flat_specs(j_rules, want_state,
                           jmesh.make_mesh({_D: 2, _M: 2}))
    assert got == want
    if name == "lm":
        assert got["params/block0/mha/wq"] == got[
            "opt_state/0/nu/block0/mha/wq"] == ("data", "model")
        assert got["step"] == ()


def test_registry_rule_sets_are_the_jax_package_s():
    """The rule-set names, patterns and specs of the registry, and its
    unknown-name error."""
    assert set(registry.PARTITION_RULES) == set(jregistry.PARTITION_RULES)
    for name, rules in registry.PARTITION_RULES.items():
        want = jregistry.PARTITION_RULES[name]
        assert rules.patterns == want.patterns
        assert [tuple(s) for _, _, s in rules._rules] == [
            tuple(s) for _, _, s in want._rules]
    for name in registry.REGISTRY:
        assert registry.get_partition_rules(name) is registry.REPLICATED_RULES
    with pytest.raises(KeyError, match="no partition rules for 'nope'"):
        registry.get_partition_rules("nope")


# -- the channel rule and the blocks ----------------------------------------


def test_channel_rules_equal_channel_spec_and_jax():
    """tp.channel_rules resolves every leaf of a mixed tree to exactly
    tp.channel_spec's spec on a 2 x 4 ("data", "model") mesh, and both to
    the JAX package's."""
    tree = {"conv": np.zeros((3, 3, 3, 32)), "dense": np.zeros((512, 8)),
            "head": np.zeros((512, 1)), "bias": np.zeros((32,)),
            "odd": np.zeros((7,)), "scalar": np.zeros(()),
            "moment": {"conv": np.zeros((3, 3, 3, 32))}}
    mesh = _layout(data=2, model=4)
    got = dict(tpart.tree_paths(ttp.state_shardings(mesh, tree)))
    jm = jtp.dp_tp_mesh(4)
    want = {n: tuple(s.spec) for n, s in
            jpart.tree_paths(jtp.state_shardings(jm, tree))}
    for name, sh in got.items():
        leaf = tree
        for part in name.split("/"):
            leaf = leaf[part]
        assert sh.spec == ttp.channel_spec(leaf, 4) == want[name], name
    assert not ttp.has_model_axis(_layout(data=4, model=1))
    assert ttp.has_model_axis(mesh)


def test_shard_tree_blocks_tile_the_input():
    """shard_tree's block on each coordinate of a 2 x 2 mesh is the
    input's slice, and the blocks put back together in coordinate order
    give the input exactly (gather_tree does so over real ranks in
    tests/test_torch_dist.py)."""
    rules = tpart.PartitionRules(((r"w$", P(_D, _M)), (r"v$", P(_M)),
                                  (r".*", P())))
    tree = {"w": np.arange(32.0).reshape(4, 8), "v": np.arange(6.0),
            "b": np.ones((3,))}
    blocks = {}
    for d, m in itertools.product(range(2), range(2)):
        mesh = tmesh.Mesh({_D: 2, _M: 2}, {_D: d, _M: m}, {})
        blocks[d, m] = tpart.shard_tree(mesh, rules, tree)
    w = np.block([[blocks[d, m]["w"].numpy() for m in range(2)]
                  for d in range(2)])
    np.testing.assert_array_equal(w, tree["w"])
    np.testing.assert_array_equal(
        np.concatenate([blocks[0, m]["v"].numpy() for m in range(2)]),
        tree["v"])
    for k in blocks:
        np.testing.assert_array_equal(blocks[k]["b"].numpy(), tree["b"])
    assert blocks[1, 0]["w"].shape == (2, 4)


def test_mesh_helpers_match_jax():
    """batch_axes, batch_seq_spec, batch_axis, sharding and replicated
    name JAX's specs on the same axes; a process drives one card; and
    tp.place cuts a tree by the channel rule."""
    for axes in ({_D: 2, "seq": 4}, {_D: 2, _M: 2, "seq": 2},
                 {"seq": 4}, {_C: 4}):
        mesh, jm = _layout(**axes), jmesh.make_mesh(axes)
        assert tmesh.batch_axes(mesh) == jmesh.batch_axes(jm)
        for trailing in (1, 2):
            assert tuple(tmesh.batch_seq_spec(mesh, trailing=trailing)) == \
                tuple(jmesh.batch_seq_spec(jm, trailing=trailing))
            assert tmesh.batch_seq_sharding(mesh, trailing=trailing).spec \
                == tmesh.batch_seq_spec(mesh, trailing=trailing)
        if _D in axes or len(axes) == 1:
            assert tmesh.batch_axis(mesh) == jmesh.batch_axis(jm)
    with pytest.raises(ValueError, match="cannot infer batch axis"):
        tmesh.batch_axis(_layout(model=2, seq=2))
    mesh = _layout(data=2)
    assert tmesh.sharding(mesh, _D).spec == P(_D)
    assert tmesh.replicated(mesh).spec == P()
    assert (tmesh.local_device_count(), tmesh.process_index()) == (1, 0)
    grid = tmesh.Mesh({_D: 1, _M: 2}, {_D: 0, _M: 1}, {})
    tree = {"k": np.arange(24.0).reshape(3, 8), "head": np.zeros((8, 1))}
    placed = ttp.place(grid, tree)
    np.testing.assert_array_equal(placed["k"].numpy(), tree["k"][:, 4:])
    assert placed["head"].shape == (8, 1)
