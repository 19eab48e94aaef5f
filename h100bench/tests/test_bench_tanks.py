"""tanks/cylinder.py is the code it replaced, bit for bit: waves.py's
seeded input and reference/step.py on reference/geometry.py's cylinder,
stepped as compare.py stepped them before a configuration named its
tank."""

import numpy as np
import pytest
import torch

from h100bench import compare, harness, waves
from h100bench.reference import geometry as rgeom
from h100bench.reference import step as rstep
from h100bench.tests import tiny


def _equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("hook", [None, compare.bf16_state],
                         ids=["reference", "control"])
@pytest.mark.parametrize("which", [tiny.FLAGSHIP, tiny.SWEEP],
                         ids=["flagship", "sweep"])
def test_the_cylinder_is_the_code_it_moved(which, hook):
    _, _, config, traffic = tiny.cell(which)
    cylinder = harness.tank(config)
    assert "tank" not in config and cylinder.__file__.endswith("cylinder.py")
    seed, n = 2 ** 31 + 77, 3

    got = cylinder.make_inputs(config, traffic, seed, "cpu")
    want = waves.make_inputs(config, traffic, seed, "cpu")
    _equal(got["state"], want["state"])
    _equal(got["forcing"], want["forcing"])
    assert got["rows"] == want["rows"]

    geom = rgeom.build_tank_geometry(H=config["H"], D=config["D"],
                                     mesh=config["mesh"], geo=config["geo"],
                                     round_to=config["round_to"])
    B = len(want["rows"])
    ga = rstep.geometry_arrays(geom, "cpu", batch=B if B > 1 else None)
    with torch.no_grad():
        ref, iters, _ = rstep.run(dict(want["state"]), want["forcing"], ga,
                                  tuple(float(h) for h in geom.spacing), n,
                                  lockstep=B > 1, hook=hook)
    state, it, t0, cells = cylinder.reference_segment(config, traffic, seed,
                                                      "cpu", n, hook=hook)
    _equal(state, ref)
    np.testing.assert_array_equal(
        it, torch.stack([torch.as_tensor(i) for i in iters]).numpy())
    assert torch.equal(t0, want["state"]["t"])
    assert cells == int(np.count_nonzero(geom.vfrac > 0))
