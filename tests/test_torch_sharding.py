"""The port's sharding rules and the models' logical axes against the JAX
package's ``repro.sharding.rules`` and ``repro.models.model.init_model``.

* ``model_axes(cfg)`` equals the reference's ``init_model(key, cfg)[1]``
  flattened to ``convert``'s names, for all ten registered archs,
  reduced and at their registered widths.
* ``shapes_and_axes`` evaluates the port's init on the ``meta`` device
  (nothing allocated) to the reference's shapes.
* ``specs_for_tree`` under RULES_A gives the reference's PartitionSpecs
  leaf for leaf on stand-in meshes of shape (2, 2), (2, 4) and (1, 16)
  (only ``axis_names`` and ``devices.shape`` are read), with and
  without a leading client axis; RULES_B / B2 / B3 on one arch each, on
  a ("data", "model") mesh; ``ShardingStrategy.for_arch`` alike.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models.model import init_model as j_init_model  # noqa: E402
from repro.sharding import rules as JR  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import flat_names  # noqa: E402
from repro_torch.models.model import init_model, model_axes  # noqa: E402
from repro_torch.sharding import rules as TR  # noqa: E402

ARCHS = list_archs()
MESH_SHAPES = [(2, 2), (2, 4), (1, 16)]


class FakeMesh:
    """What the rules read of a mesh: its axis names and device grid."""

    def __init__(self, shape, names):
        self.devices = np.empty(shape, dtype=object)
        self.axis_names = names


_REF = {}


def reference(arch: str, red: bool):
    """(flat name -> axes, flat name -> shape, axes tree, shapes tree) of
    the reference's init, evaluated without allocating."""
    if (arch, red) not in _REF:
        cfg = j_get_config(arch)
        cfg = j_reduced(cfg) if red else cfg
        shapes, axes = JR.shapes_and_axes(lambda k: j_init_model(k, cfg))
        names = flat_names(shapes)
        flat_axes = jax.tree.leaves(axes,
                                    is_leaf=lambda x: isinstance(x, tuple))
        _REF[arch, red] = (dict(zip(names, flat_axes)),
                           dict(zip(names, (tuple(s.shape) for s in
                                            jax.tree.leaves(shapes)))),
                           axes, shapes)
    return _REF[arch, red]


def port_cfg(arch: str, red: bool):
    cfg = get_config(arch)
    return reduced(cfg) if red else cfg


def flat_specs(tree) -> list:
    return jax.tree.leaves(tree, is_leaf=lambda s: isinstance(s, JP))


@pytest.mark.parametrize("red", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_axes_equal_the_reference(arch, red):
    want, _, _, _ = reference(arch, red)
    got = model_axes(port_cfg(arch, red))
    assert list(got) == list(want)
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_and_axes_allocate_nothing(arch):
    cfg = port_cfg(arch, False)
    shapes, axes = TR.shapes_and_axes(
        lambda k: (init_model(k, cfg, device="meta"), model_axes(cfg)))
    assert all(t.device.type == "meta" for t in shapes.values())
    _, want, _, _ = reference(arch, False)
    assert {n: tuple(t.shape) for n, t in shapes.items()} == want
    assert set(axes) == set(shapes)
    stacked = TR.stack_shapes(shapes, 8)
    assert all(stacked[n].shape == (8,) + tuple(shapes[n].shape)
               and stacked[n].device.type == "meta" for n in shapes)
    with pytest.raises(ValueError, match="meta"):
        TR.shapes_and_axes(lambda k: ({"w": torch.zeros(1)}, {}))


@pytest.mark.parametrize("red", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_a_specs_equal_the_reference(arch, red):
    want_axes, want_shapes, axes, shapes = reference(arch, red)
    got_axes = model_axes(port_cfg(arch, red))
    names = list(want_axes)
    for shape in MESH_SHAPES:
        mesh = FakeMesh(shape, ("clients", "model"))
        for lead in (("clients",), None):
            jshapes = JR.stack_shapes(shapes, 8) if lead else shapes
            tshapes = ({n: (8,) + s for n, s in want_shapes.items()}
                       if lead else want_shapes)
            want = dict(zip(names, flat_specs(JR.specs_for_tree(
                axes, jshapes, JR.RULES_A, mesh, leading_client=lead))))
            got = TR.specs_for_tree(got_axes, tshapes, TR.RULES_A, mesh,
                                    leading_client=lead)
            assert list(got) == names
            for n in names:
                assert tuple(got[n]) == tuple(want[n]), (shape, lead, n)
                assert repr(got[n]) == repr(want[n]).replace(
                    "PartitionSpec", "P"), n


@pytest.mark.parametrize("rules, arch", [
    ("RULES_B", "mixtral-8x22b"), ("RULES_B2", "qwen3-moe-30b-a3b"),
    ("RULES_B3", "zamba2-1.2b")])
def test_strategy_b_rules_equal_the_reference(rules, arch):
    want_axes, want_shapes, axes, shapes = reference(arch, False)
    names = list(want_axes)
    for shape in ((4, 4), (2, 8), (16, 16)):
        mesh = FakeMesh(shape, ("data", "model"))
        for lead in ((), None):
            jshapes = JR.stack_shapes(shapes, 2) if lead is not None \
                else shapes
            tshapes = ({n: (2,) + s for n, s in want_shapes.items()}
                       if lead is not None else want_shapes)
            want = flat_specs(JR.specs_for_tree(
                axes, jshapes, getattr(JR, rules), mesh,
                leading_client=lead))
            got = TR.specs_for_tree(model_axes(port_cfg(arch, False)),
                                    tshapes, getattr(TR, rules), mesh,
                                    leading_client=lead)
            assert [tuple(got[n]) for n in names] == [tuple(s) for s in
                                                      want], (shape, lead)


@pytest.mark.parametrize("strategy", [None, "A", "B", "B2", "B3"])
def test_strategy_for_arch_equals_the_reference(strategy):
    for names, shape in ((("data", "model"), (16, 16)),
                         (("pod", "data", "model"), (2, 16, 16))):
        mesh = FakeMesh(shape, names)
        for arch in ("smollm-135m", "mixtral-8x22b"):
            want = JR.ShardingStrategy.for_arch(arch, mesh,
                                                strategy=strategy)
            got = TR.ShardingStrategy.for_arch(arch, mesh,
                                               strategy=strategy)
            assert (got.name, got.num_clients, got.client_axes,
                    got.batch_axes) == (want.name, want.num_clients,
                                        want.client_axes, want.batch_axes)
            assert got.rules == want.rules


def test_partition_spec_and_leaf_rules():
    p = TR.P("clients", None, ("data", "model"))
    assert p == TR.P("clients", None, ("data", "model")) and len(p) == 3
    assert repr(p) == "P('clients', None, ('data', 'model'))"
    assert p.names(0) == ("clients",) and p.names(1) == () and \
        p.names(2) == ("data", "model") and p.names(7) == ()
    with pytest.raises(TypeError):
        TR.P(3)
    mesh = FakeMesh((2, 4), ("clients", "model"))
    # "layers" never shards; a dim that does not divide falls back.
    assert TR.spec_for_leaf(("layers", "mlp"), (4, 8), TR.RULES_A,
                            mesh) == TR.P(None, "model")
    assert TR.spec_for_leaf(("kv_heads", "head_dim"), (3, 64), TR.RULES_A,
                            mesh) == TR.P(None, None)
    assert TR.spec_for_leaf(("embed", "mlp"), (8, 576, 1536), TR.RULES_A,
                            mesh, leading_client=("clients",)) == TR.P(
        "clients", None, "model")
    assert TR.model_sharded_dims(
        {"a": TR.P("clients", None, "model"), "b": TR.P("clients")},
        "model") == {"a": 2, "b": None}
    with pytest.raises(ValueError, match="two dims"):
        TR.model_sharded_dims({"a": TR.P("model", "model")}, "model")
    with pytest.raises(ValueError, match="different leaves"):
        TR.specs_for_tree({"a": ("mlp",)}, {"b": (4,)}, TR.RULES_A, mesh)
