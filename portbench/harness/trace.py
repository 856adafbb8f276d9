"""The device side of a profiled stretch of rounds, read in memory from
``torch.profiler``'s kineto events (no trace file is written): the busy
time as the union of the device operations' intervals, device seconds by
kernel group and by kernel, and the idle gaps, each labelled by the
benchmark's host span around it (``round/batch``, ``round/run``,
``round/sync``).

A frozen rewrite of ``chip_smoke.device_profile`` and its kernel
grouping, so that later changes to the program cannot move the
yardstick. Groups: each hand-written kernel of the port's ``csrc/`` by
its function name (B1-B8, T1-T4), ``matmul`` (cuBLAS and CUTLASS
kernels), and ``torch_other`` (every other kernel, copy and fill).
"""
from __future__ import annotations

import re

import torch

HOST_SPANS = ("round/batch", "round/run", "round/sync")
# record_function ranges the profiler mirrors onto the device timeline:
# markers, not device work.
RANGE_PREFIXES = ("round/", "wire/", "pool/", "model/")
CSRC_KERNELS = {
    "momentum_quantize_pack_buffer": "b4", "quantize_pack_buffer": "b1",
    "quantize_pack": "b6", "dequant_mix_momentum_buffer": "b5",
    "dequant_mix_buffer": "b2", "dequant_mix_plan": "b7",
    "dequant_mix_ring": "b8", "momentum_sgd_lanes": "b3",
    "momentum_sgd": "b3", "threefry_split": "t1",
    "threefry_fold_in_each": "t1", "threefry_uniform": "t2",
    "threefry_bits": "t3", "threefry_normal": "t4"}
_CSRC = [(re.compile(rf"(?<![A-Za-z0-9_]){k}_kernel(?![A-Za-z0-9_])"), g)
         for k, g in CSRC_KERNELS.items()]
MATMUL = ("gemm", "xmma", "nvjet", "cutlass", "splitKreduce")


def group(name: str) -> str:
    """The kernel group of a device operation's name."""
    for pattern, g in _CSRC:
        if pattern.search(name):
            return g
    if any(p in name for p in MATMUL):
        return "matmul"
    return "torch_other"


class Trace:
    """A profiled stretch of ``rounds`` whole rounds (times in seconds)."""

    def __init__(self, rounds: int, events):
        self.rounds = rounds
        spans, host = [], []
        self.group_s: dict[str, float] = {}
        self.kernel_s: dict[str, float] = {}
        for e in events:
            name = e.name()
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if name.startswith(RANGE_PREFIXES):
                    continue
                s = (end - start) / 1e9
                g = group(name)
                self.group_s[g] = self.group_s.get(g, 0.0) + s
                self.kernel_s[name] = self.kernel_s.get(name, 0.0) + s
                spans.append((start, end))
            elif name in HOST_SPANS:
                host.append((start, end, name))
        if not host:
            raise RuntimeError("the profiled stretch recorded no host span")
        lo, hi = min(h[0] for h in host), max(h[1] for h in host)
        self.window_s = (hi - lo) / 1e9
        self.device_ops = len(spans)
        busy, reach, gaps = 0, lo, []
        for start, end in sorted(spans):
            start, end = max(start, lo), min(end, hi)
            if end <= reach:
                continue
            if start > reach:
                gaps.append((reach, start))
            busy += end - max(start, reach)
            reach = end
        if reach < hi:
            gaps.append((reach, hi))
        self.busy_s = busy / 1e9
        host.sort()
        self.gaps = sorted(((_label(host, (a + b) / 2), (b - a) / 1e9)
                            for a, b in gaps), key=lambda g: -g[1])

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps, ``[name, seconds]`` each."""
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:160], v] for k, v in top],
                "idle_gaps": [list(g) for g in self.gaps[:n]]}

    def idle_by_span(self) -> dict:
        out: dict[str, float] = {}
        for label, s in self.gaps:
            out[label] = out.get(label, 0.0) + s
        return out


def _label(host: list, t: float) -> str:
    """The host span around time ``t`` (the innermost that holds it)."""
    best = None
    for start, end, name in host:
        if start <= t <= end and (best is None or end - start < best[0]):
            best = (end - start, name)
    return best[1] if best else "between spans"


def profiler():
    """A profiler of host and device activity, not yet started."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
