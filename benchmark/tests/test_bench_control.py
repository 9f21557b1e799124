"""The control at a small size: the reference at float32 in the
program's place fails the comparison (the chip runs it at the cell's
size: ``python3 benchmark/control.py``)."""

from benchmark.control import control


def test_control_fails_the_comparison(small, tmp_path):
    cell, cfg = small
    cell = dict(cell, params=dict(cell["params"],
                                  check=dict(cell["params"]["check"],
                                             reads=6)))
    out = control(cell, cfg, 2**31 + 7, 50, str(tmp_path))
    assert out["compared"] == 6
    assert out["lines_differ"] >= 1
