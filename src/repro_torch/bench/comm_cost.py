"""Prop. 3 table: for every assigned architecture, does b-bit quantization
beat 32-bit DFedAvgM in total communication, and what are the per-round
volumes on the production ring (m=16 clients)? The reference's
``benchmarks/bench_comm_cost.py`` on the port: arithmetic over the
configs' ``n_params()``, no device work."""
from __future__ import annotations

from ..configs import get_config, list_archs
from ..core import (QuantConfig, dfedavgm_round_bits,
                    prop3_quantization_wins)
from ..core.topology import ring_graph


def run(*, smoke: bool = False, device=None):
    """The runner's entry: every registered arch's wire bits a round on the
    ring of 16 at 8 and 4 bits against 32 (``comm_cost``'s formulas), as CSV
    rows; nothing runs on a device."""
    del smoke, device
    rows = []
    g = ring_graph(16)
    for arch in list_archs():
        d = get_config(arch).n_params()
        for b in (8, 4):
            wins = prop3_quantization_wins(d, b)
            gb32 = dfedavgm_round_bits(g, d) / 8e9
            gbq = dfedavgm_round_bits(g, d, QuantConfig(bits=b)) / 8e9
            rows.append((f"prop3/{arch}/b{b}", 0.0,
                         f"wins={wins};roundGB32={gb32:.2f};"
                         f"roundGBq={gbq:.2f};saving={gb32/gbq:.1f}x"))
    return rows
