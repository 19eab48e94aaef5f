"""The seeded inputs: the same for the same seed, another wave phase for
another seed, and the reference's linear-theory amplitude."""

import numpy as np
import torch

from h100bench import waves
from h100bench.tests import tiny


def _inputs(which, seed):
    _, _, config, traffic = tiny.cell(which)
    return waves.make_inputs(config, traffic, seed, "cpu")


def test_same_seed_same_inputs_other_seed_other_inputs():
    for which in (tiny.FLAGSHIP, tiny.SWEEP):
        a, b = _inputs(which, 2 ** 31 + 5), _inputs(which, 2 ** 31 + 5)
        for k in a["state"]:
            assert torch.equal(a["state"][k], b["state"][k])
        others = [_inputs(which, s)["state"] for s in (17, 18, 19, 20)]
        assert any(not torch.equal(a["state"]["t"], o["t"])
                   and not torch.equal(a["state"]["u"], o["u"])
                   for o in others)


def test_seeds_turn_one_wave_by_quarter_turns():
    """Every seed's wave is one wave turned about the axis by a multiple
    of 90 degrees: alpha and the dt are the same up to the turn."""
    base = _inputs(tiny.FLAGSHIP, 0)["state"]
    for seed in (1, 2, 3, 4, 5):
        s = _inputs(tiny.FLAGSHIP, seed)["state"]
        turned = [torch.rot90(base["alpha"], k, dims=(0, 1)) for k in range(4)]
        assert any(torch.allclose(s["alpha"], t, atol=1e-5) for t in turned)
        assert abs(float(s["dt"]) / float(base["dt"]) - 1) < 1e-4


def test_flagship_amplitude_is_the_reference_prediction():
    # SURVEY "Example run": Delta_h_PT = 0.0629 m for H0.208 D0.2 R0.004 f1.88
    w = float(np.float32(2 * np.pi * 1.88))
    assert abs(2 * waves.wall_amplitude(0.1, 0.004, w, 0.104) - 0.0629) < 5e-5


def test_wave_state_is_physical():
    inp = _inputs(tiny.FLAGSHIP, 99)
    s = inp["state"]
    assert float(s["alpha"].min()) == 0.0 and float(s["alpha"].max()) == 1.0
    assert all(bool(torch.isfinite(s[k]).all()) for k in s)
    ramp = 2.0
    assert ramp <= float(s["t"]) < ramp + 1 / 1.88
    # no write time (every 0.05 s) within 5 ms after t0
    assert 0.0 < float(s["t"]) % 0.05 < 0.045
    assert 0 < float(s["dt"]) < 0.05
    # the surface rises on one side and falls on the other
    col = s["alpha"].sum(dim=2)
    assert float(col.max() - col.min()) > 0.5


def test_study_rows_are_the_cartesian_product():
    config = {"study": {"freq": [1.0, 0.25, 32], "R": [0.0001, 0.0001, 32],
                        "duration": 10.0, "ramp": -1}}
    rows = waves.case_rows(config)
    assert len(rows) == 1024
    assert rows[0]["freq"] == 1.0 and rows[0]["R"] == 0.0001
    assert rows[-1]["freq"] == 8.75 and rows[-1]["R"] == 0.0032
