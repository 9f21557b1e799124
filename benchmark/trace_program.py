"""Run one batch cell once with the program's own tracer
(``uncalled_tpu_torch.tracing``) on over the window, and print what its
spans say:

    python3 benchmark/trace_program.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1> --tracer <0|1>

The cell runs as ``benchmark/run.py`` runs it, through the same
``run(ctx)``, with two additions: the tracer is on while the benchmark's
spans are (the window; ``--tracer 1``), and a profiled stretch
(``--trace 1``) also places the program's spans on the trace's clock and
puts each device event and idle gap down to the innermost of them
(``harness/program_spans.py``).  For a traced run it prints to standard
error the table of spans (host ms, launches, device ms a step and the
top device ops), the idle seconds by span and by the benchmark's spans
alone, how the clock offset was found, and ``engine.step``'s host ms a
step inside the stretch and in the rest of the window.  The last line of
standard output is a JSON object: the end-to-end metrics, the cell's
per-layer metrics, the three read from the program's spans over the
window, the span totals, and the stretch's table.  ``--tracer 0`` runs
the benchmark's own run, so the two measure what the tracer costs when
on.  The benchmark's runs do not run this.
"""

import os
import sys
import time

T0 = time.time()
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_v] = "1"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(name, seed, seconds, trace, tracer, t0, device="cuda", cell=None,
        config=None) -> dict:
    """Drive cell ``name`` once; the result as the JSON line holds it."""
    from uncalled_tpu_torch import tracing

    from benchmark.harness import core
    from benchmark.harness import profile as hprof
    from benchmark.harness import program_spans as ps
    from benchmark.harness import spans as hspans
    from benchmark.metrics.common import window_steps

    bench = core.load_json(os.path.join(core.ROOT, "BENCHMARK.json"))
    if cell is None:
        cell, config = core.cell_files(name)
    got = {}

    class WindowSpans(hspans.Spans):
        """The benchmark's spans; the program's tracer is on while they
        are (from the window's opening to its close)."""

        @property
        def on(self):
            return self._on

        @on.setter
        def on(self, v):
            self._on = v
            if tracer:
                tracing.enable() if v else tracing.disable()

    summarize = hprof.summarize

    def keep_events(evs, *a, **k):
        got["evs"] = evs
        return summarize(evs, *a, **k)

    class ProgramStretch(hprof.Stretch):
        hook_s = 0.0  # the stretch's own start and stop, inside a block

        def hook(self, name):
            t = time.perf_counter()
            super().hook(name)
            self.hook_s += time.perf_counter() - t

        def finish(self):
            out = super().finish()
            evs = got.pop("evs", None)
            if out:
                out["hook_s"] = self.hook_s
            if not out or evs is None:
                return out
            off0 = hprof.sync_offset_us(evs, *self.sync)
            if off0 is None:
                return out
            steps = out["calls"] * got["T"]
            spans = tracing.snapshot()["spans"]
            near = ps.readout_offset_us(evs, spans, off0)
            off = off0 if near is None else near[0]
            clipped = ps.clip(spans, self.t0, self.t0 + self.wall)
            prog = ps.shift(clipped, off)
            bench_sp = [(n, s * 1e6 + off, e * 1e6 + off)
                        for n, s, e in self.host_spans]
            out["program"] = pr = ps.breakdown(evs, prog, bench_sp, steps)
            pr["sync_spread_us"] = ps.sync_spread_us(evs, *self.sync)
            pr["readout_offset"] = near and dict(
                minus_sync_us=near[0] - off0, width_us=near[1],
                readouts=near[2])
            # launches a span under the synchronise's offset alone
            pr["launches_at_sync_offset"] = {
                k: r["launches"] for k, r in ps.breakdown(
                    evs, ps.shift(clipped, off0), (), steps)["spans"].items()}
            pr["step_s"] = sum(
                (e - s) * 1e-6 for n, s, e, _ in prog if n == "engine.step")
            # the idle gaps by the benchmark's spans alone, as before
            pr["bench_idle_s"] = ps.breakdown(evs, [], bench_sp,
                                              steps)["idle_s"]
            return out

    saved = hspans.Spans, hprof.Stretch, hprof.summarize
    hspans.Spans, hprof.Stretch = WindowSpans, ProgramStretch
    hprof.summarize = keep_events
    try:
        work = os.path.join(core.WORK, name)
        os.makedirs(work, exist_ok=True)
        ctx = core.Ctx(name, cell, config, seed, seconds, bool(trace),
                       device, t0, work)
        got["T"] = config["conf"]["engine"]["evt_block"]
        res = core.driver_of(cell).run(ctx)
    finally:
        hspans.Spans, hprof.Stretch, hprof.summarize = saved
        tracing.disable()
    rec = res["record"]
    if tracer:
        rec["program"] = tracing.snapshot()["totals"]
    _, layer = core.cell_metrics(bench, name)
    metrics = {m["name"]: core.reader_of(m["name"]).read(rec) for m in layer}
    metrics.update({k: fn(rec) for k, fn in ps.WINDOW_METRICS.items()})
    line = dict(seed=seed, trace=trace, tracer=tracer,
                end_to_end=res["end_to_end"], checks=res["checks"],
                device=res["device_kind"],
                power_limit_w=res.get("power_limit_w"), metrics=metrics,
                program_totals=rec.get("program"))
    prof = rec.get("profile") or {}
    if prof:
        line["stretch_hook_s"] = prof["hook_s"]
    if "program" in prof:
        pr = prof["program"]
        steps = prof["calls"] * rec["T"]
        w_steps = window_steps(rec)
        inside = pr["step_s"]
        outside = rec["program"]["engine.step"]["seconds"] - inside
        pr["step_ms_inside"] = 1e3 * inside / steps
        pr["step_ms_outside"] = 1e3 * outside / (w_steps - steps)
        pr["stretch_launches"] = prof["kernels"]
        pr["stretch_device_s"] = prof["device_s"]
        pr["stretch_busy_s"] = prof["busy_s"]
        pr["stretch_wall_s"] = prof["wall_s"]
        line["program"] = pr
        _print_table(pr, prof, file=sys.stderr)
    return line


def _print_table(pr, prof, file):
    print(f"{'span':<24} {'host ms':>8} {'launches':>9} {'device ms':>9}"
          "  top device ops (ms a step)", file=file)
    for name, r in sorted(pr["spans"].items(),
                          key=lambda kv: -kv[1]["host_ms"]):
        ops = "; ".join(f"{n[:48]} {ms:.4f}" for n, ms in r["top_ops"])
        print(f"{name:<24} {r['host_ms']:8.3f} {r['launches']:9.2f} "
              f"{r['device_ms']:9.4f}  {ops}", file=file)
    idle = sum(pr["idle_s"].values())
    print(f"idle {idle:.4f} s by span: " + ", ".join(
        f"{k} {v:.4f}" for k, v in pr["idle_s"].items()), file=file)
    print("idle by the benchmark's spans: " + ", ".join(
        f"{k} {v:.4f}" for k, v in pr["bench_idle_s"].items()), file=file)
    print(f"launches {pr['launches']} of {prof['kernels']}, device "
          f"{pr['device_s']:.6f} of {prof['device_s']:.6f} s, unmatched "
          f"{pr['unmatched']}, sync spread {pr['sync_spread_us']} us, "
          f"readout offset {pr['readout_offset']}; "
          f"engine.step host ms a step: stretch {pr['step_ms_inside']:.3f}, "
          f"rest of the window {pr['step_ms_outside']:.3f}", file=file)


def main(argv) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    a = ap.parse_args(argv)

    from benchmark.harness import core

    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(core.WORK,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(core.WORK, "triton")
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    line = run(a.workload, a.seed, a.seconds, a.trace, a.tracer, T0)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
