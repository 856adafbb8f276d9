"""Virtual event clocks for asynchronous gossip — the port of the JAX
package's ``core/event_clock.py``.

  * :class:`SpeedModel` — a per-client compute-duration distribution
    (``constant`` / ``lognormal`` / ``straggler``), drawn from a key on
    the key's device (``prng.normal``: one T4 launch on the card).
  * :func:`next_event` — pop the event queue: the earliest next-ready
    time and the mask of the clients finishing at that instant.

The event queue is the vector of per-client next-ready times carried in
``AsyncRoundState``; popping it is a min and a compare on the device, so
an event needs no host sync. Units are arbitrary virtual seconds;
``constant`` speed fires every client every event, which is how the
async engine reproduces the synchronous round bit for bit.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import prng

__all__ = ["SpeedModel", "next_event"]


@dataclasses.dataclass(frozen=True)
class SpeedModel:
    """Per-client compute-duration distribution, drawn once per local
    round.

    kinds:
      * ``constant``  — every client takes exactly ``mean``.
      * ``lognormal`` — ``mean * exp(sigma * xi - sigma^2 / 2)``, ``xi ~
                        N(0, 1)`` i.i.d. per client per draw.
      * ``straggler`` — lognormal, with the first ``ceil(straggler_frac *
                        m)`` clients slower by ``straggler_factor``.
    """

    kind: str = "constant"          # constant | lognormal | straggler
    mean: float = 1.0               # mean duration, virtual seconds
    sigma: float = 0.5              # lognormal log-std
    straggler_frac: float = 0.125   # fraction of clients that straggle
    straggler_factor: float = 10.0  # their duration multiplier
    _mult: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    _KINDS = ("constant", "lognormal", "straggler")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(f"unknown speed model kind {self.kind!r}; "
                             f"allowed: {' | '.join(self._KINDS)}")
        if self.mean <= 0:
            raise ValueError("speed model needs mean > 0")
        if self.sigma < 0:
            raise ValueError("speed model needs sigma >= 0")
        if not 0.0 < self.straggler_frac <= 1.0:
            raise ValueError("need 0 < straggler_frac <= 1")
        if self.straggler_factor < 1.0:
            raise ValueError("straggler_factor must be >= 1")

    @property
    def is_constant(self) -> bool:
        return self.kind == "constant"

    def n_stragglers(self, m: int) -> int:
        if self.kind != "straggler":
            return 0
        return max(1, math.ceil(self.straggler_frac * m))

    def multipliers(self, m: int) -> np.ndarray:
        """Static [m] per-client duration multiplier (1 everywhere except
        the straggler set)."""
        mult = np.ones((m,), np.float32)
        mult[: self.n_stragglers(m)] = self.straggler_factor
        return mult

    def multipliers_on(self, m: int, device) -> torch.Tensor:
        """:meth:`multipliers` as an f32 tensor on ``device``, made on the
        first call for (m, device) and kept: a draw then copies nothing
        from the host (the async step builds it when it is made)."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if (m, dev) not in self._mult:
            self._mult[(m, dev)] = torch.as_tensor(self.multipliers(m),
                                                   device=dev)
        return self._mult[(m, dev)]

    def draw(self, key: torch.Tensor, m: int) -> torch.Tensor:
        """(key, m) -> [m] f32 durations on the key's device.
        ``constant`` consumes no randomness (a fill, no T4)."""
        if self.kind == "constant":
            return torch.full((m,), self.mean, dtype=torch.float32,
                              device=key.device)
        xi = prng.normal(key, (m,))
        # The reference's order, with the constant factor folded on the
        # host so the exp argument is a single multiply.
        scale = self.mean * math.exp(-0.5 * self.sigma ** 2)
        dur = scale * torch.exp(self.sigma * xi)
        return dur * self.multipliers_on(m, key.device)

    @staticmethod
    def constant(mean: float = 1.0) -> "SpeedModel":
        return SpeedModel(kind="constant", mean=mean)

    @staticmethod
    def lognormal(mean: float = 1.0, sigma: float = 0.5) -> "SpeedModel":
        return SpeedModel(kind="lognormal", mean=mean, sigma=sigma)

    @staticmethod
    def straggler(mean: float = 1.0, sigma: float = 0.5,
                  frac: float = 0.125, factor: float = 10.0) -> "SpeedModel":
        return SpeedModel(kind="straggler", mean=mean, sigma=sigma,
                          straggler_frac=frac, straggler_factor=factor)


def next_event(next_ready: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pop the event queue: ``(t_now, ready)``, ``t_now`` the earliest
    next-ready time (0-dim) and ``ready`` the f32 [m] mask of the clients
    whose clock hits exactly that instant (at least one; all of them
    under a constant speed model)."""
    t_now = next_ready.min()
    return t_now, (next_ready <= t_now).to(torch.float32)
