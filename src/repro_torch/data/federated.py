"""Federated partitioning — the paper's MNIST protocol (§6.1), numpy,
copied from the JAX package's ``data/federated.py``:

IID:     shuffle, split evenly across m clients.
Non-IID: sort by label, cut into 2m shards, give each client 2 shards.

``round_batches`` returns tensors on the requested device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from .synthetic import ClassificationData

__all__ = ["partition_iid", "partition_noniid_shards", "FederatedDataset"]


def partition_iid(data: ClassificationData, m: int, *, seed: int = 0
                  ) -> list[np.ndarray]:
    """The paper's IID split: a seeded permutation of the examples cut into
    ``m`` near-equal index arrays, each sorted."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(data.y))
    return [np.sort(s) for s in np.array_split(idx, m)]


def partition_noniid_shards(data: ClassificationData, m: int, *,
                            shards_per_client: int = 2, seed: int = 0
                            ) -> list[np.ndarray]:
    """Paper: 'sort the data by digit label, divide it into 2m shards,
    and assign each of m clients 2 shards.'"""
    order = np.argsort(data.y, kind="stable")
    n_shards = m * shards_per_client
    shards = np.array_split(order, n_shards)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_shards)
    out = []
    for i in range(m):
        take = perm[i * shards_per_client:(i + 1) * shards_per_client]
        out.append(np.sort(np.concatenate([shards[t] for t in take])))
    return out


@dataclasses.dataclass
class FederatedDataset:
    """Client-partitioned dataset with a deterministic round-batch sampler
    returning [m, K, batch, ...] dicts (what round_step consumes)."""

    data: ClassificationData
    client_idx: list[np.ndarray]

    @staticmethod
    def make(data: ClassificationData, m: int, *, iid: bool = True,
             seed: int = 0) -> "FederatedDataset":
        part = partition_iid(data, m, seed=seed) if iid else \
            partition_noniid_shards(data, m, seed=seed)
        return FederatedDataset(data=data, client_idx=part)

    @property
    def m(self) -> int:
        return len(self.client_idx)

    def round_batches(self, round_idx: int, *, K: int, batch: int,
                      seed: int = 0, device=None) -> dict[str, torch.Tensor]:
        """The round's [m, K, batch, ...] batches on ``device`` — the same
        draws as the JAX package's ``round_batches``."""
        dev = resolve_device(device)
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, round_idx]))
        xs, ys = [], []
        for ci in self.client_idx:
            take = rng.choice(ci, size=(K, batch), replace=len(ci) < K * batch)
            xs.append(self.data.x[take])
            ys.append(self.data.y[take])
        return {"x": torch.from_numpy(np.stack(xs)).to(dev),
                "y": torch.from_numpy(np.stack(ys)).to(dev)}

    def label_histogram(self) -> np.ndarray:
        """[m, n_classes] label counts per client."""
        h = np.zeros((self.m, self.data.n_classes), np.int64)
        for i, ci in enumerate(self.client_idx):
            for c in range(self.data.n_classes):
                h[i, c] = int((self.data.y[ci] == c).sum())
        return h
