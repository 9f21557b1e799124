"""The control of a batch cell's comparison: the reference put in the
program's place at the next precision down (float32 where the
configuration states float64), judged by the same comparison.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

It makes the cell's genome and, for each seed, the reference's index, draws
as many read numbers as a run compares from the first ``--reads-from``
reads of the cell's stream, maps them with the reference at float64 and
at float32, and prints one JSON line: the lines that differ, of those
compared.  A sound comparison finds some on every seed.  The benchmark's
own runs do not run this.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness.core import WORK, cell_files  # noqa: E402


def control(cell, config, seed, reads_from, work, device="cpu"):
    import numpy as np

    from benchmark.reference import check
    from benchmark.traffic import genome as gen

    mix = cell["params"]
    genome = gen.realistic_genome(config["genome"]["bp"],
                                  np.random.default_rng(
                                      [config["genome"]["seed"], 1]),
                                  config["genome"]["repeats"])
    spec = check.prepare(work, genome, config["genome"]["name"],
                         config["conf"], device)
    picked = check.sample(range(reads_from), mix["check"]["reads"], seed)
    w = mix["check"]["workers"]
    ref = check.reference_lines(spec, seed, mix, picked, w)
    low = check.reference_lines(spec, seed, mix, picked, w, hi="float32")
    return dict(seed=seed, compared=len(picked),
                lines_differ=sum(ref[n] != low[n] for n in picked))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--reads-from", type=int, default=400)
    a = ap.parse_args()
    cell, config = cell_files(a.workload)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    work = os.path.join(WORK, "control_" + a.workload)
    os.makedirs(work, exist_ok=True)
    for seed in a.seeds:
        t0 = time.time()
        out = control(cell, config, seed, a.reads_from, work, device)
        out["seconds"] = time.time() - t0
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
