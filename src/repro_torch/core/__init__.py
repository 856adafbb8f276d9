"""Core: quantized DFedAvgM as PyTorch — the port of the JAX package's
``repro.core`` for one synchronous round (a static spec or a
time-varying schedule) on one device or a 1D client mesh (block plans,
placement, the sharded executor), the asynchronous event engine, the virtual
client pool (a host store of up to 10^6 clients, a cohort of k lanes on
the card), its FedAvg and DSGD baselines, the paper's bit accounting,
and ``capture_step``, which runs a round or an event as one CUDA graph
(the counterpart of ``jax.jit``)."""
from .topology import (Graph, MixingSpec, TopologySchedule,  # noqa
                       ring_graph, chain_graph, torus_graph, complete_graph,
                       star_graph, erdos_renyi_graph, metropolis_hastings,
                       max_degree_weights, lazy_uniform, mixing_lambda,
                       spectral_gap, check_mixing_matrix,
                       metropolis_weights_from_adjacency)
from .quantize import (QuantConfig, quantize, quantize_int,  # noqa
                       dequantize_int, pack_bits, unpack_bits,
                       quantize_pytree, dequantize_pytree, message_bits,
                       scale_from_amax)
from .gossip_plan import (GossipPlan, plan_from_spec,  # noqa
                          plan_from_support, plan_from_matrix, BlockPlan,
                          BlockSubStep, Placement, compile_block_plan,
                          compute_placement)
from .wire_layout import WireLayout  # noqa
from .local_sgd import local_train, heavy_ball_update  # noqa
from .mixing import (MixerConfig, make_mixer, make_scheduled_mixer,  # noqa
                     make_plan_mixer, make_event_mixer, mix_dense,
                     consensus_distance, execute_plan_reference,
                     make_fused_tail, split_lanes, join_lanes,
                     cut_columns, join_columns)
from .dfedavgm import (DFedAvgMConfig, RoundState, init_round_state,  # noqa
                       make_round_step, make_cells_round_step,
                       average_params, round_comm_bits)
from .baselines import (FedAvgConfig, make_fedavg_step, DSGDConfig,  # noqa
                        make_dsgd_step)
from .comm_cost import (CommLedger, dfedavgm_round_bits, fedavg_round_bits,  # noqa
                        dsgd_round_bits, schedule_round_bits,
                        plan_round_bits, async_event_bits,
                        prop3_quantization_wins, prop3_epsilon_floor,
                        bottleneck_bits)
from .event_clock import SpeedModel, next_event  # noqa
from .async_gossip import (AsyncConfig, AsyncRoundState,  # noqa
                           init_async_state, staleness_weights,
                           staleness_eta, make_async_round_step,
                           make_async_engine)
from .client_pool import (ClientPool, PoolSchedule,  # noqa
                          PooledRoundStep, make_pooled_round_step,
                          PooledRunner, PooledAsyncRunner, ring_matching_src)
from .compiled import capture_step  # noqa
