"""The control of each cell at a tiny width on the CPU: the reference
computed in the precision below the configuration's (TF32 for float32
with TF32 off) comes out not correct under the cell's limits, and its
readings lie far above a sound run's."""

import pytest

from portbench import control, harness
from portbench.tests.test_portbench_run import tiny_run
from portbench.tests.tiny import SERVE_MIX, TINY, TINY_TRAIN, TRAIN_MIX

CELLS = ["celeba128.train", "celeba128.serve"]


def control_readings(cell_name, seed):
    train = "train" in cell_name
    cell = harness.Cell(cell_name, TINY_TRAIN if train else TINY,
                        TRAIN_MIX if train else SERVE_MIX)
    precision = control.LOWER[cell.config.get("dtype", "float32")]
    if train:
        return cell, control.train_control(cell, seed, precision, None,
                                           "cpu")
    return cell, control.serve_control(cell, seed, precision, None, "cpu",
                                       2.0)


@pytest.mark.parametrize("cell_name", CELLS)
def test_control_is_not_correct(cell_name):
    seed = 2 ** 31 + 17
    cell, readings = control_readings(cell_name, seed)
    failed = [k for k, lim in cell.limits.items() if readings[k] > lim]
    assert failed, readings
    sound = tiny_run(cell_name, seed=seed)["readings"]
    assert any(readings[k] > 10 * sound[k] for k in failed)
