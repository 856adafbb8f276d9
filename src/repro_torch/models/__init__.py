"""The models of the port: the ten registered architectures (``model``:
dense, MoE, SSM, hybrid, encoder-decoder, VLM, over ``layers``,
``attention``, ``moe``, ``ssm``, ``transformer`` and the stub
``frontends``) and the paper's own nets (``paper_nets``)."""
from .model import (init_model, forward, loss_fn, init_decode_caches,  # noqa
                    decode_step, prefill, encode, model_axes)
from .frontends import stub_frontend_embeddings, frontend_shape  # noqa
