"""Run one cell once: find its files by name, drive it, read its metrics,
judge it, and print the result.

Everything particular to a cell sits in files the names in
``BENCHMARK.json`` lead to:

* ``benchmark/workloads/<cell>.json``: its configuration, driver, chips,
  why and traffic parameters;
* ``benchmark/configs/<config>.json``: the configuration as it is run;
* ``benchmark/drivers/<driver>.py``: ``run(ctx)`` sets the program up,
  measures the window and checks the outputs;
* ``benchmark/metrics/<metric>.py``: ``read(rec)`` gives a per-layer
  metric from the driver's record, or None where there is nothing to read.
  A traced run on the card whose cell lists a metric it cannot read fails
  (the line would lack it); it never reports 0 in its place.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from dataclasses import dataclass

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
WORK = os.path.join(ROOT, ".bench_work")
# top-level modules that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "uncalled_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Ctx:
    """What a driver gets."""
    name: str
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float
    work: str
    patch: object = None  # fn(mapper) -> None, for the fault tests


def cell_metrics(bench: dict, name: str):
    """The cell's end-to-end and per-layer metric entries: a metric
    listing ``workloads`` is the cell's where it names it; one without is
    every cell's that reports the end-to-end metric it moves."""
    mine = [m for m in bench["end_to_end"]
            if name in m.get("workloads", [name])]
    names = {m["name"] for m in mine}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return mine, layer


def forbidden_modules(names=None):
    """The forbidden top-level names among loaded modules (or ``names``),
    compared whole: ``uncalled_tpu_torch`` is not ``uncalled_tpu``."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def cell_files(name, bench_dir=BENCH):
    """A cell's file and its configuration's."""
    cell = load_json(os.path.join(bench_dir, "workloads", name + ".json"))
    return cell, load_json(os.path.join(bench_dir, "configs",
                                        cell["config"] + ".json"))


def driver_of(cell, bench_dir=BENCH):
    return load_module(os.path.join(bench_dir, "drivers",
                                    cell["driver"] + ".py"),
                       "bench_driver_" + cell["driver"])


def reader_of(metric: str, bench_dir=BENCH):
    return load_module(os.path.join(bench_dir, "metrics", metric + ".py"),
                       "bench_metric_" + metric)


def run_cell(name, seed, seconds, trace, t0, device="cuda", bench=None,
             cell=None, config=None, patch=None, bench_dir=BENCH) -> dict:
    """Drive cell ``name`` once and build its result line (a dict).
    ``bench``, ``cell`` and ``config`` default to the files; the tests
    pass small ones and a ``patch`` that breaks the program.  Also gives
    the names of the cell's per-layer metrics that had nothing to read."""
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    if cell is None:
        cell, config = cell_files(name, bench_dir)
    work = os.path.join(WORK, name)
    os.makedirs(work, exist_ok=True)
    driver = driver_of(cell, bench_dir)
    ctx = Ctx(name, cell, config, seed, seconds, bool(trace), device, t0,
              work, patch)
    res = driver.run(ctx)

    e2e_defs, layer_defs = cell_metrics(bench, name)
    metrics, unread = {}, []
    if trace:
        for m in layer_defs:
            v = reader_of(m["name"], bench_dir).read(res["record"])
            if v is None:
                print(f"metric {m['name']}: nothing to read",
                      file=sys.stderr)
                unread.append(m["name"])
                continue
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        for m in e2e_defs:
            metrics[m["name"]] = dict(value=res["end_to_end"][m["name"]],
                                      unit=m["unit"])
    checks = res["checks"]
    correct = (res["attempted"] > 0 and res["compared"] > 0
               and all(v <= lim for v, lim in checks.values()))
    dev = dict(platform="gpu" if device == "cuda" else device,
               kind=res["device_kind"], count=int(cell["chips"]),
               memory_peak_bytes=int(res["memory_peak_bytes"]),
               power_limit_w=res.get("power_limit_w"))
    line = dict(correct=bool(correct), attempted=int(res["attempted"]),
                failed=int(res["failed"]), metrics=metrics, device=dev)
    prof = res["record"].get("profile") if trace else None
    if prof:
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["wall_s"]
        line["breakdown"] = dict(device_ops=prof["device_ops"],
                                 idle_gaps=prof["idle_gaps"])
    if "reads" in res:  # where every read pulled went
        line["reads"] = res["reads"]
    line["checks"] = {k: dict(value=v, limit=lim)
                      for k, (v, lim) in checks.items()}
    return line, unread


def main(argv, t0) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry = [w for w in bench["workloads"] if w["name"] == a.workload]
    if not entry:
        print(f"no workload {a.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    # every build and kernel cache inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(WORK, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(WORK, "triton")
    import torch

    torch.set_num_threads(1)
    chips = int(entry[0]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line, unread = run_cell(a.workload, a.seed, a.seconds, a.trace, t0,
                            "cuda", bench=bench)
    if unread:
        print(f"per-layer metrics of the cell with nothing to read: "
              f"{', '.join(unread)}", file=sys.stderr)
        return 4
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the run: {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
