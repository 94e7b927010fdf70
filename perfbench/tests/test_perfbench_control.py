"""The control, read on the card at each cell's own size on three seeds:
the plain reference computed in float8 (the step below the configurations'
bfloat16) put in the program's place must fail the cell's limits. Marked
``card``; skips without one."""

import pytest

from perfbench import calibrate
from perfbench.harness import compare, manifest

MAN = manifest.load_manifest()
SEEDS = (101, 202, 303)


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in MAN["workloads"]])
def test_the_control_fails_the_limits(card, name):
    c = manifest.workload(MAN, name)
    config = manifest.config(MAN, c["config"])
    mix = manifest.traffic(c["traffic"])
    limits = manifest.limits(name)
    read = calibrate.train_readings if mix["driver"] == "train_step" else calibrate.serve_readings
    for seed in SEEDS:
        readings = read(config, mix, seed, card)
        assert not compare.verdict(readings["control"], limits), (seed, readings)
