"""A run with the timed path broken underneath reads `correct` false: once
for each fault a one-card genotyping cell can have, and for the control.

Each test drives a whole tiny run on the CPU (the harness's look for a
card skipped), through the port's plain PyTorch versions of its kernels,
with a fault of faults.py planted in the program, or as the control:
every Gibbs chain reads a tenth of the k-mers the configuration states
(judge.json "control").
"""

import pytest

from portbench import faults, run
from portbench.conftest import DENSE_CONFIG, DENSE_MIX, tiny_run

# the tiny bulk unit, and the same with a 7-SNV family judged whole
UNITS = {"bulk": {}, "dense": {"config": DENSE_CONFIG, "mix": DENSE_MIX}}


def _checks(checks):
    return {name: (value, limit) for name, value, limit in checks}


@pytest.mark.parametrize("unit", sorted(UNITS))
def test_sound_run_is_correct(unit):
    result, checks = tiny_run(**UNITS[unit])
    assert result["correct"], checks
    assert result["failed"] == 0
    read = _checks(checks)
    assert read["worst_gap_nats"][0] == 0.0
    assert read["unjudged_share"][0] == 0.0


def test_family_past_the_reach_is_not_judged():
    """Without the configuration's reach, the 7-SNV family's 128
    haplotypes pass judge.json's 65, in its one local window too: its
    variants go unjudged, and the run is not correct."""
    config = dict(DENSE_CONFIG)
    del config["judge"]
    result, checks = tiny_run(config=config, mix=DENSE_MIX)
    assert not result["correct"], checks
    assert _checks(checks)["unjudged_share"][0] > 0


@pytest.mark.parametrize("unit", sorted(UNITS))
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   "altered_gpp", "skip_noise"])
def test_fault_turns_correct_false(fault, unit):
    with faults.FAULTS[fault]() as planted:
        result, checks = tiny_run(**UNITS[unit])
    if fault.startswith("altered"):
        assert planted
    assert not result["correct"], checks
    read = _checks(checks)
    if fault == "half":
        assert 0.3 < read["nb_mean_gap"][0] < 0.7
    if fault == "altered":
        assert read["worst_gap_nats"][0] > 50
    if fault == "altered_gpp":
        # the first of the tiny run's 4 samples
        assert read["low_gpp_share"][0] == pytest.approx(0.25, abs=0.01)
    if fault == "skip_noise":
        assert read["noise_rate_gap"][0] > 2


def test_cut_chains_fail():
    """Chains of a tenth of the stated iterations (judge.json "cut", the
    program's own option) leave the noise traces short."""
    cut = run.load_json(run.HERE, "judge.json")["cut"]
    result, checks = tiny_run(program={k: max(1, v // 10)
                                       for k, v in cut.items()})
    assert not result["correct"], checks
    assert _checks(checks)["noise_rows_gap"][0] > 0


def test_control_fails():
    control = run.load_json(run.HERE, "judge.json")["control"]
    result, checks = tiny_run(program=control)
    assert not result["correct"], checks
    value, limit = _checks(checks)["missed_share"]
    assert value > 3 * limit
