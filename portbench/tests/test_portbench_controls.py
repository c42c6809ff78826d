"""The comparison that decides ``correct`` fails where it must, at
sizes a test run can hold: with the control (the plain reference in
float8 in the program's place) and with each fault the cell can have
planted under the timed path, a run drives the rest of the harness as
on the card and comes out not correct."""

import copy

import pytest
import torch

from portbench import controls, harness
from portbench.tests.test_portbench_run import SMALL



def _deep(small: dict, minibatch: int, filters: int) -> dict:
    """``small`` at the configuration's own depth, wider and with a
    larger minibatch."""
    out = copy.deepcopy(small)
    out["params"]["minibatch"] = minibatch
    out["config"]["policy"].pop("layers")
    out["config"]["policy"]["filters_per_layer"] = filters
    return out


#: sizes a test run can hold at which the control's float8 nets stray
#: as far as at the cells' own: the float8 gradients drift past the
#: limits only through the full 13 layers
FAULT_SIZES = {
    "policy192.sl-train": _deep(SMALL["policy192.sl-train"], 32, 64),
}


def _cases():
    for cell in sorted(FAULT_SIZES):
        _, _, _, _, driver = harness.load_cell(cell)
        yield cell, "control"
        for fault in sorted(driver.FAULTS):
            yield cell, fault


@pytest.mark.parametrize("cell,kind", list(_cases()))
def test_fails(cell, kind):
    torch.manual_seed(0)
    (row,) = controls.readings(cell, [(kind, [2**31 + 77])], 4.0,
                               torch.device("cpu"),
                               overrides=FAULT_SIZES[cell])
    assert row["correct"] is False, row
