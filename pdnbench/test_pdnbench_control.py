"""The control of `correct` (pdnbench/control.py) at a size a test run
holds: the reference's float64 answer passes each cell's check, the
same answer rounded to float32 fails it (CPU, the tiny configuration).
At the cells' own sizes the control runs on the card's machine:
`python3 pdnbench/control.py --workload <cell> --seeds ...`."""

import pytest

from pdnbench import control
from pdnbench.conftest import TINY_CELLS


@pytest.mark.parametrize("cell", TINY_CELLS)
@pytest.mark.parametrize("seed", [5, 2**31 + 9])
def test_the_control_fails_and_the_reference_passes(tiny, cell, seed):
    bench, root = tiny
    got = control.readings(bench, cell, seed, root)
    assert got
    for name, (ref, ctrl, limit) in got.items():
        assert ctrl > 3 * limit, name
        if ref is not None:
            assert ref < limit / 100, name
