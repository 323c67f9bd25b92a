"""The port's sharding specs and input stand-ins
(`repro_torch/launch/specs.py`) and elastic mesh helpers
(`repro_torch/runtime/elastic.py`) against the JAX package's.

The three cases of the JAX package's `tests/test_specs.py` on its
`FakeMesh`; `param_specs` of every registered arch equal to JAX's (on
`jax.eval_shape`'s tree) with the leading layer axis dropped for the
port's per-layer leaves, and equal to JAX's itself on JAX's stacked
layout; `input_specs` shapes and dtypes and `batch_specs` equal to
JAX's for train, prefill and decode; `param_shapes` allocates nothing.
`choose_mesh_shape` equal to JAX's over n 1-64 x tp {1, 2, 4, 16} x pods
{1, 2}; `reshard_tree` onto a folded host mesh, and its refusal of a
mesh across devices.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jax_config
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.launch import specs as jspecs
from repro.models import transformer as jtf
from repro.runtime import elastic as jelastic
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import specs
from repro_torch.launch.mesh import DeviceMesh, Placement
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import elastic


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class FakePodMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


def _t(spec):
    """A JAX PartitionSpec as the port's tuple."""
    return tuple(spec)


def test_validate_filters_missing_axes():
    out = specs._validate(specs.P(("pod", "data"), "model"), (64, 32),
                          FakeMesh())
    assert out == specs.P("data", "model") == ("data", "model")


def test_validate_drops_indivisible():
    # 51865 is not divisible by 16 -> axis dropped
    out = specs._validate(specs.P("model", None), (51865, 8), FakeMesh())
    assert out == (None, None)
    # partial tuple: 32 % (16*16) != 0 but 32 % 16 == 0 -> keep prefix
    out = specs._validate(specs.P(("pod", "data"),), (32,), FakeMesh())
    assert out == ("data",)


def test_validate_reads_the_ports_mesh():
    """The port's DeviceMesh gives its sizes as a tuple in axis order."""
    mesh = DeviceMesh(devices=(torch.device("cpu"),) * 8, shape=(2, 4),
                      axis_names=("data", "model"))
    assert specs._validate(specs.P(("pod", "data"), "model"), (6, 12),
                           mesh) == ("data", "model")
    assert specs._validate(specs.P("model"), (6, 3), mesh) == (None, None)


def test_rules_cover_big_leaves():
    """Every >= 1e8-element weight leaf of mixtral-8x22b gets a
    non-trivial spec (FSDP or TP), as JAX's test holds: a replicated big
    leaf is the OOM of a real mesh."""
    params = specs.param_shapes(get_config("mixtral_8x22b"))
    spec_tree = specs.param_specs(params, FakePodMesh())
    flat = tree_leaves(params)
    spec_flat = _spec_leaves(spec_tree)
    assert len(flat) == len(spec_flat)
    big = 0
    for leaf, sp in zip(flat, spec_flat):
        # JAX's 1e8 elements of a leaf stacked over the 56 layers
        if np.prod(leaf.shape) >= 1e8 / 56:
            big += 1
            assert any(e is not None for e in sp), (leaf.shape, sp)
    assert big > 0


def _spec_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _spec_leaves(t)]
    return [tree]


def test_param_shapes_allocate_nothing():
    params = specs.param_shapes(get_config("mixtral_8x22b"))
    leaves = tree_leaves(params)
    assert all(p.device.type == "meta" for p in leaves)
    assert sum(p.numel() for p in leaves) > 1.4e11


def _jax_named(tree, is_leaf=None):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf for path, leaf in flat}


STACKED = ("layers", "blocks", "tail", "enc_layers")


def _port_named(tree):
    """{JAX's path: (the leaf of each layer, whether per layer)} of the
    port's tree: a list under a stacked key holds one tree a layer."""
    out = {}

    def walk(node, path, per_layer):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k, per_layer)
        elif isinstance(node, list) and path.split("/")[-1] in STACKED:
            for t in node:
                walk(t, path, True)
        else:
            out.setdefault(path, ([], per_layer))[0].append(node)
    walk(tree, "", False)
    return out


@pytest.mark.parametrize("mesh", (FakeMesh, FakePodMesh),
                         ids=("data_model", "pod_data_model"))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax(arch, mesh):
    """Each leaf's spec is JAX's for its (stacked) leaf, with the layer
    axis's entry dropped where the port keeps one tree a layer."""
    jparams = jax.eval_shape(lambda: jtf.init_params(
        jax_config(arch), jax.random.PRNGKey(0)))
    want = _jax_named(jspecs.param_specs(jparams, mesh()),
                      is_leaf=lambda x: isinstance(x, JP))
    jshapes = _jax_named(jparams)
    params = specs.param_shapes(get_config(arch))
    got = _port_named(specs.param_specs(params, mesh()))
    shapes = _port_named(params)
    assert set(got) == set(want)
    per_layer_seen = False
    for name, (spec_list, per_layer) in got.items():
        jshape, jspec = jshapes[name].shape, _t(want[name])
        if per_layer:
            per_layer_seen = True
            jshape, jspec = jshape[1:], jspec[1:]
            assert len(spec_list) == jshapes[name].shape[0], name
        for sp, leaf in zip(spec_list, shapes[name][0]):
            assert tuple(leaf.shape) == jshape, name
            assert sp == jspec, name
    assert per_layer_seen


@pytest.mark.parametrize("arch", ("olmo_1b", "recurrentgemma_2b",
                                  "whisper_medium", "phi35_moe"))
def test_param_specs_on_jax_layout_equal_jax(arch):
    """A tree in JAX's stacked layout (a checkpoint's logical arrays)
    takes JAX's specs themselves."""
    jparams = jax.eval_shape(lambda: jtf.init_params(
        jax_config(arch), jax.random.PRNGKey(0)))
    want = _jax_named(jspecs.param_specs(jparams, FakePodMesh()),
                      is_leaf=lambda x: isinstance(x, JP))
    logical = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                           jparams)
    got = _jax_named(specs.param_specs(logical, FakePodMesh()),
                     is_leaf=lambda x: isinstance(x, tuple))
    assert got == {k: _t(v) for k, v in want.items()}


@pytest.mark.parametrize("kind", ("train_4k", "prefill_32k", "decode_32k"))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax(arch, kind):
    cfg, shape = get_config(arch), SHAPES[kind]
    want = jspecs.input_specs(jax_config(arch), JAX_SHAPES[kind])
    got = specs.input_specs(cfg, shape)
    jflat = _jax_named(want)
    tflat = _jax_named(got)
    assert set(jflat) == set(tflat)
    for name, leaf in tflat.items():
        assert leaf.device.type == "meta", name
        assert tuple(leaf.shape) == jflat[name].shape, name
        assert str(leaf.dtype).removeprefix("torch.") == str(
            jflat[name].dtype), name
    jbs = _jax_named(jspecs.batch_specs(want, FakePodMesh()),
                     is_leaf=lambda x: isinstance(x, JP))
    tbs = _jax_named(specs.batch_specs(got, FakePodMesh()),
                     is_leaf=lambda x: isinstance(x, tuple))
    assert tbs == {k: _t(v) for k, v in jbs.items()}


def test_tree_shardings_and_batch_axes():
    mesh = elastic.make_mesh((2, 2), ("data", "model"), fold_onto="cpu")
    tree = specs.tree_shardings({"a": ("data", None), "b": [()]}, mesh)
    assert tree == {"a": Placement(mesh, ("data", None)),
                    "b": [Placement(mesh, ())]}
    assert specs.batch_axes(mesh) == ("data",)
    assert specs.batch_axes(FakePodMesh()) == ("pod", "data")
    assert elastic.replicated(mesh) == Placement(mesh, ())


def test_choose_mesh_shape_matches_jax():
    for n in range(1, 65):
        for tp in (1, 2, 4, 16):
            for pods in (1, 2):
                assert elastic.choose_mesh_shape(n, tp, pods) == \
                    jelastic.choose_mesh_shape(n, tp, pods), (n, tp, pods)


def test_reshard_tree_onto_a_folded_host_mesh():
    mesh = elastic.make_mesh(*elastic.choose_mesh_shape(4, tp=2),
                             fold_onto="cpu")
    assert mesh.folded and mesh.size == 4
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((4, 6)).astype(np.float32),
            "s": np.int32(7), "l": [np.arange(3)]}
    placements = {"w": Placement(mesh, ("data", "model")),
                  "s": elastic.replicated(mesh),
                  "l": [elastic.replicated(mesh)]}
    out = elastic.reshard_tree(tree, placements)
    assert out["w"].device.type == "cpu" and out["w"].dtype == torch.float32
    np.testing.assert_array_equal(out["w"].numpy(), tree["w"])
    assert out["s"].dtype == torch.int32 and int(out["s"]) == 7
    assert torch.equal(out["l"][0], torch.arange(3))
    # new tensors, never views of the logical arrays
    out["w"].add_(1)
    assert not np.array_equal(out["w"].numpy(), tree["w"])
    with pytest.raises(ValueError):
        elastic.reshard_tree(tree, {"w": placements["w"]})


def test_reshard_tree_refuses_a_mesh_across_devices():
    spread = DeviceMesh(devices=(torch.device("cpu"), torch.device("meta")),
                        shape=(2,), axis_names=("data",))
    with pytest.raises(NotImplementedError, match="fold"):
        elastic.reshard_tree({"w": np.zeros(2)},
                             {"w": Placement(spread, ("data",))})
