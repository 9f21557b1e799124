"""A later cell, mix or per-layer metric comes as files and entries: the
harness finds them by name, with no edit to a file it has."""

import json
import os
import shutil

from benchmark.harness import core


def test_cells_and_metrics_of_benchmark_json_have_their_files():
    bench = core.load_json(os.path.join(core.ROOT, "BENCHMARK.json"))
    for w in bench["workloads"]:
        cell, cfg = core.cell_files(w["name"])
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
        assert hasattr(core.driver_of(cell), "run")
        _, layer = core.cell_metrics(bench, w["name"])
        for m in layer:
            assert callable(core.reader_of(m["name"]).read)
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(core.ROOT, c["file"]))


def test_new_cell_and_metric_files_are_found(tmp_path):
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(core.BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cell, _ = core.cell_files("ecoli_map.isolate")
    cell = dict(cell, traffic="isolate_long")
    cell["params"] = dict(cell["params"], read_len_bp=[4000, 8000])
    (bench_dir / "workloads" / "ecoli_map.isolate_long.json").write_text(
        json.dumps(cell))
    (bench_dir / "metrics" / "host_loop.handoffs_per_s.batch.py").write_text(
        "def read(rec):\n"
        "    return rec['counters']['n_handoff'] / rec['window_s']\n")
    bench = core.load_json(os.path.join(core.ROOT, "BENCHMARK.json"))
    bench["workloads"].append(dict(name="ecoli_map.isolate_long",
                                   config="ecoli_map", traffic="isolate_long",
                                   chips=1, why="longer reads"))
    bench["per_layer"].append(dict(
        name="host_loop.handoffs_per_s.batch", unit="1/s", better="higher",
        source="program_counter", layer="host loop", moves="reads_per_s"))
    got, cfg = core.cell_files("ecoli_map.isolate_long", str(bench_dir))
    assert got["params"]["read_len_bp"] == [4000, 8000]
    assert cfg["name"] == "ecoli_map"
    e2e, layer = core.cell_metrics(bench, "ecoli_map.isolate_long")
    names = [m["name"] for m in layer]
    # a metric without workloads is every cell's that reports what it moves
    assert "host_loop.handoffs_per_s.batch" in names
    assert "engine.ms_per_step.batch" not in names  # listed for the other
    assert {m["name"] for m in e2e} == {"reads_per_s", "setup_s"}
    rd = core.reader_of("host_loop.handoffs_per_s.batch", str(bench_dir))
    assert rd.read(dict(counters=dict(n_handoff=30), window_s=10)) == 3
