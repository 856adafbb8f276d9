"""Core: quantized DFedAvgM as PyTorch — the port of the JAX package's
``repro.core`` for one synchronous round on one device."""
from .topology import (Graph, MixingSpec, ring_graph, lazy_uniform,  # noqa
                       metropolis_hastings, max_degree_weights,
                       check_mixing_matrix)
from .quantize import (QuantConfig, quantize_int, dequantize_int,  # noqa
                       message_bits, scale_from_amax)
from .gossip_plan import GossipPlan, plan_from_spec  # noqa
from .wire_layout import WireLayout  # noqa
from .local_sgd import local_train, heavy_ball_update  # noqa
from .mixing import (MixerConfig, make_mixer, make_plan_mixer,  # noqa
                     mix_dense, consensus_distance)
from .dfedavgm import (DFedAvgMConfig, RoundState, init_round_state,  # noqa
                       make_round_step, average_params, round_comm_bits)
