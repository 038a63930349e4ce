"""On a CUDA card: the check of ``correct`` passes the program as it is and
fails the control and each fault a cell can have. It runs the Large cell's
set-up and loop at MNIST-Tiny's shape and k = 14, which a test run holds
(``control.py`` gives the same readings for any cell and seeds at its own
size).

    cd portbench && python3 -m pytest tests/test_portbench_card.py
"""

import dataclasses

import pytest

import control
from harness.cells import Benchmark

pytestmark = pytest.mark.card

SEED = 2_654_435_761
TINY = dict(num_filter_inputs=28, num_filter_entries=256, num_filter_hashes=1,
            bits_per_input=1)


@pytest.fixture(scope="module")
def readings(card):
    cell = Benchmark().cell("mnist_large.prove_serial")
    config = dict(cell.config, k=14, model=dict(cell.config["model"], **TINY))
    out = control.readings(dataclasses.replace(cell, config=config), [SEED], 6.0, 2.0)
    return {case: v for (_, case), v in out.items()}


def test_sound_run_is_correct(card, readings):
    numbers, failed, correct = readings["sound"]
    assert correct and failed == 0
    assert numbers == {"scores_wrong": 0, "proofs_rejected": 0}


@pytest.mark.parametrize("case", ("control",) + control.FAULTS)
def test_control_and_faults_are_not_correct(card, readings, case):
    numbers, failed, correct = readings[case]
    assert not correct
    if case == "half_lost":
        assert failed > 0
    else:
        assert numbers["scores_wrong"] + numbers["proofs_rejected"] > 0
