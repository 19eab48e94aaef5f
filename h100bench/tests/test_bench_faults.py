"""`correct` comes out false when the timed path is broken underneath:
a step that returns its state unchanged, half of a batch left out, an
answer altered where it is produced; and the control (the reference with
its state held in bfloat16) fails the cell's limits. At the tiny sizes on
the CPU, where the port's kernel entries run their plain versions."""

import dataclasses

import pytest
import torch

from h100bench import compare
from h100bench.tests import tiny


def _wrap(system, after):
    inner = system.step

    def step(carry):
        new, rec = inner(carry)
        return after(carry, new), rec
    system.step = step


def unchanged(system):
    _wrap(system, lambda old, new: old)


def half_batch(system):
    def after(old, new):
        b = new.alpha.shape[-1] // 2
        cut = {k: torch.cat([getattr(new, k)[..., :b], getattr(old, k)[..., b:]],
                            dim=-1)
               for k in ("alpha", "u", "v", "w", "p", "t", "dt")}
        return dataclasses.replace(new, **cut)
    _wrap(system, after)


def altered(system):
    def after(old, new):
        s = new[0] if isinstance(new, tuple) else new
        s.alpha.view(-1)[s.alpha.numel() // 2] += 0.05
        return new
    _wrap(system, after)


@pytest.mark.parametrize("which", [tiny.FLAGSHIP, tiny.SWEEP],
                         ids=["flagship", "sweep"])
def test_sound_run_is_correct(which):
    assert tiny.run(which)["correct"] is True


@pytest.mark.parametrize("which", [tiny.FLAGSHIP, tiny.SWEEP],
                         ids=["flagship", "sweep"])
@pytest.mark.parametrize("fault", [unchanged, altered],
                         ids=["unchanged", "altered"])
def test_fault_is_not_correct(which, fault):
    assert tiny.run(which, fault=fault)["correct"] is False


def test_half_batch_is_not_correct():
    assert tiny.run(tiny.SWEEP, fault=half_batch)["correct"] is False


@pytest.mark.parametrize("which", [tiny.FLAGSHIP, tiny.SWEEP],
                         ids=["flagship", "sweep"])
def test_control_fails_the_limits(which):
    _, cell, config, traffic = tiny.cell(which)
    vals = compare.control(config, traffic, 31337, "cpu")
    assert any(v > cell["limits"][k] for k, v in vals.items())
