"""The port's architecture registry (``repro_torch.configs``) against the
JAX package's: every ``ArchConfig`` field, ``block_pattern``, ``stages``,
``n_params``, ``n_active_params``, ``max_learned_pos`` and ``reduced()``
equal for all ten registered architectures, and the input shapes."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro import configs as ref  # noqa: E402
from repro_torch import configs as port  # noqa: E402

ARCHS = ref.list_archs()


def test_the_same_registry():
    assert port.list_archs() == ARCHS and len(ARCHS) == 10
    assert {k: dataclasses.asdict(v) for k, v in port.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in ref.INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_and_structure_equal(arch, reduced):
    a, b = ref.get_config(arch), port.get_config(arch)
    if reduced:
        a, b = ref.reduced(a), port.reduced(b)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.block_pattern() == b.block_pattern()
    assert a.stages() == b.stages()
    assert a.n_params() == b.n_params()
    assert a.n_active_params() == b.n_active_params()
    assert a.max_learned_pos() == b.max_learned_pos()
    assert (a.attention_free, a.subquadratic) == (b.attention_free,
                                                  b.subquadratic)


def test_smollm_135m_registered_width():
    cfg = port.get_config("smollm-135m")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype,
            cfg.tie_embeddings) == (30, 576, 9, 3, 64, 1536, 49152,
                                    "bfloat16", True)
    assert cfg.n_params() == 134_515_008


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        port.get_config("no-such-arch")
