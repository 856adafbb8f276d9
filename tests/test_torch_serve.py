"""The port's serving driver (``repro_torch.launch.serve``) against the
JAX package's: ``main`` at the reduced size (the same seeds: the model
from ``PRNGKey(seed)``, the prompts from ``randint(PRNGKey(1))``, the
frontend stub from ``PRNGKey(0)``) greedy-decodes the same tokens —
prefill, then cached one-token decode steps, argmax — for the dense and
MoE architectures. The ssm, hybrid, whisper and vlm ones have their
prefill and cached decode held against the reference's logits in
``test_torch_models.py``, so every registered architecture's decode is
checked once."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rcfg  # noqa: E402
from repro.launch import serve as RS  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402

torch.set_num_threads(2)

ARGV = ["--batch", "2", "--prompt-len", "8", "--gen", "6"]
DECODE_TESTED_IN_MODELS = ("mamba2-780m", "zamba2-1.2b", "whisper-tiny",
                           "llama-3.2-vision-11b")
SERVE_ARCHS = [a for a in rcfg.list_archs()
               if a not in DECODE_TESTED_IN_MODELS]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_greedy_tokens_equal_the_reference(arch):
    want = np.asarray(RS.main(["--arch", arch] + ARGV))
    got = TS.main(["--arch", arch, "--device", "cpu"] + ARGV)
    assert got.dtype == torch.int64 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)


def test_serving_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        TS.main(ARGV)
