"""On the card: a short run of each cell at its tiny size through the
port's CUDA kernels, correct and with a traced breakdown. Skips without
a CUDA device (decided in the fixture)."""

import time

import pytest

from h100bench import harness
from h100bench.tests import tiny


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


@pytest.mark.gpu
@pytest.mark.parametrize("which", [tiny.FLAGSHIP, tiny.SWEEP],
                         ids=["flagship", "sweep"])
def test_tiny_run_on_the_card(card, which):
    name, c, config, traffic = tiny.cell(which)
    r = harness.run(name, c, config, traffic, 4242, 0.5, True, card,
                    time.perf_counter())
    assert r["correct"] is True
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert r["breakdown"]["device_ops"]
