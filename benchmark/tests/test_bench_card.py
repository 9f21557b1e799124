"""On the chip: one short run of every cell through the command the
driver runs, with the result line's keys and ``correct``."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import core


@pytest.mark.card
def test_each_cell_runs_correct(card):
    bench = core.load_json(os.path.join(core.ROOT, "BENCHMARK.json"))
    for w in bench["workloads"]:
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", w["name"],
             "--seed", str(2**31 + 5), "--seconds", "10", "--trace", "0"],
            capture_output=True, text=True, timeout=900, cwd=core.ROOT)
        assert out.returncode == 0, out.stderr[-3000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert {"correct", "attempted", "failed", "metrics",
                "device"} <= set(line)
        assert line["correct"], line["checks"]
