"""``correct`` comes out false when the timed path is broken: the harness's
look for a card skipped (the round runs eagerly on the CPU, at the tiny
cells' size) and the rest of a run driven with one fault planted under
it, each a fault a training cell can have: a round that returns its state
unchanged, half of each batch left out (the mean over the rest), the
exchange between clients left out. And the control: the reference
computing its products in fp8, put in the program's place, fails too."""
from __future__ import annotations

import time

import numpy as np
import pytest

from portbench.harness import cell as cells
from portbench.harness import program
from portbench.reference import dfedavgm as ref_round
from portbench.tests import tiny

SEED = 2 ** 31 + 101
# Limits for the tiny cells, set as the cells' own are: above the sound
# program's readings at this size (loss_gap <= 3.7e-5 over 7 seeds of
# both families; the changes' gaps <= 0.06) and below the control's and
# the faults' (loss_gap >= 7.8e-5; changes >= 0.39).
LIMITS = {"loss_gap": 6e-5, "update1_gap": 0.2, "change_gap": 0.2}


def _run(tmp_path, name: str) -> dict:
    bench = tiny.make(tmp_path, LIMITS)
    result, _, _ = cells.run_cell(bench, name, SEED, 0.2, False, "cpu",
                                  time.perf_counter())
    return result


@pytest.mark.parametrize("name", ["smollm.tiny", "mamba2.tiny"])
def test_sound_program_is_correct(tmp_path, name):
    assert _run(tmp_path, name)["correct"]


def test_state_left_unchanged(tmp_path, monkeypatch):
    capture = program.capture

    def frozen(step, state, batch):
        run = capture(step, state, batch)
        return lambda s, b: (s, run(s, b)[1])

    monkeypatch.setattr(program, "capture", frozen)
    result = _run(tmp_path, "smollm.tiny")
    assert not result["correct"]
    assert result["checked"]["update1_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["smollm.tiny", "smollm.tiny.k1"])
def test_half_of_the_batch_left_out(tmp_path, monkeypatch, name):
    loss_for = program.loss_for

    def half(arch):
        loss = loss_for(arch)

        def on_half(p, batch, rng):
            b, l = batch["tokens"].shape[-2:]
            cut = ((lambda t: t[:, :b // 2]) if b > 1
                   else (lambda t: t[..., :l // 2]))
            return loss(p, {k: cut(v) for k, v in batch.items()}, rng)
        return on_half

    monkeypatch.setattr(program, "loss_for", half)
    result = _run(tmp_path, name)
    assert not result["correct"]
    assert result["checked"]["change_gap"]["value"] > LIMITS["change_gap"]


def test_exchange_left_out(tmp_path, monkeypatch):
    from repro_torch.core import MixingSpec

    def alone(mix):
        ring = MixingSpec.ring(mix["clients"], mix["self_weight"])
        return MixingSpec(graph=ring.graph, W=np.eye(mix["clients"]),
                          kind="ring")

    monkeypatch.setattr(program, "spec_for", alone)
    result = _run(tmp_path, "mamba2.tiny")
    assert not result["correct"]
    assert result["checked"]["change_gap"]["value"] > LIMITS["change_gap"]


@pytest.mark.parametrize("name", ["smollm.tiny", "mamba2.tiny"])
def test_control_in_the_programs_place(tmp_path, monkeypatch, name):
    def control_rounds(run, x0, key, data, n):
        state, _, batches = check_rounds(run, x0, key, data, n)
        cell = cells.Cell(bench, name, "cpu")
        ctrl = ref_round.rounds(
            x0, batches, key, family=cells.reference.family(
                cell.config["family"]), cfg=cell.config, eta=cell.mix["eta"],
            theta=cell.mix["theta"],
            W=ref_round.ring(cell.mix["clients"], cell.mix["self_weight"]),
            bits=cell.mix["bits"], precision="fp8")
        return state, ctrl, batches

    check_rounds = cells.check_rounds
    bench = tiny.make(tmp_path, LIMITS)
    monkeypatch.setattr(cells, "check_rounds", control_rounds)
    result, _, _ = cells.run_cell(bench, name, SEED, 0.2, False, "cpu",
                                  time.perf_counter())
    assert not result["correct"]
    assert result["checked"]["loss_gap"]["value"] > LIMITS["loss_gap"]
