"""The hand-written kernels whose roofline share the benchmark reports:
for each family, the names its launches carry in a profiler trace, the
program's functions that launch it (wrapped while a stretch is profiled,
to take each call's arguments), the launch counter that must agree with
the calls taken, and the byte count of a call.
"""

from __future__ import annotations

import importlib

from . import bytes as nb

POOLED = "uncalled_tpu_torch.mapping.pooled"
CG = "uncalled_tpu_torch.ops.colgather"
FG = "uncalled_tpu_torch.ops.flat_gather"
SK = "uncalled_tpu_torch.ops.sortkern"
STK = "uncalled_tpu_torch.ops.stepkern"
TK = "uncalled_tpu_torch.ops.tracker_kernel"


# A call's count: (bytes from its shapes, launches, and what is counted
# after the stretch: None or (function, tensor) -> bytes)
def _gather(kernel, cols, idx, lens=None, out=None):
    plan = nb.gather_plan(cols, idx, lens, kernel == "row_gather")
    return 0, 1, (lambda x, _p=plan: nb.gather_bytes(_p, x), idx)


def _gather_table(kernel, tables, idx):
    F = tables[0].shape[-1]
    plan = nb.gather_table_plan(tables, idx, kernel == "row_gather")
    return 0, -(-F // 16), (lambda x, _p=plan: nb.gather_bytes(_p, x), idx)


def _tracker(min_aln_len, st, ref_en, mc, evt, st_w, rows_eff):
    return (nb.tracker_fold_fixed(st, rows_eff), 1,
            (lambda x: int(x.sum()) * 12, rows_eff))


def _shapes(fn):
    """The count of a kernel whose bytes its arguments' shapes give."""
    return lambda *a, **k: (fn(*a, **k), 1, None)


# family -> (trace name substrings, [(module, function, count)], launch
# counters)
FAMILIES = {
    "gather_cols": (("gather_cols_kernel",),
                    [(CG, "gather", _gather),
                     (CG, "gather_table", _gather_table)],
                    ("flat_gather", "row_gather")),
    "pair_counts": (("pair_counts_kernel",),
                    [(FG, "pair_counts", _shapes(nb.pair_counts)),
                     (POOLED, "pair_counts", _shapes(nb.pair_counts))],
                    ("pair_counts",)),
    "ring_assemble": (("ring_assemble_kernel",),
                      [(STK, "ring_assemble", _shapes(nb.ring_assemble)),
                       (POOLED, "ring_assemble", _shapes(nb.ring_assemble))],
                      ("ring_assemble",)),
    "tracker_fold": (("tracker_fold_kernel",),
                     [(TK, "tracker_run_compact", _tracker),
                      (POOLED, "tracker_run_compact", _tracker)],
                     ("tracker_fold",)),
    "sort_net": (("tile_net", "global_net"),
                 [(SK, "sort_runs", _shapes(nb.sort_runs)),
                  (POOLED, "sort_runs", _shapes(nb.sort_runs)),
                  (SK, "merge_level_", _shapes(nb.merge_level)),
                  (POOLED, "merge_level_", _shapes(nb.merge_level))],
                 ("sort_runs", "merge_level")),
}

def family_of(trace_name: str):
    for fam, (names, _, _) in FAMILIES.items():
        if any(n in trace_name for n in names):
            return fam
    return None


class Calls:
    """While entered: every call of the families' launching functions is
    counted from its shapes and passed on, keeping only the index tensors
    whose distinct rows count (and their version, so that one written in
    place after the call counts as unreadable); ``tally()`` then gives
    each family's (bytes, launches)."""

    def __init__(self):
        self.kept = []  # (family, bytes, launches, deferred, version)
        self._orig = []

    def __enter__(self):
        for fam, (_, sites, _) in FAMILIES.items():
            for mod_name, fn_name, count in sites:
                mod = importlib.import_module(mod_name)
                orig = getattr(mod, fn_name)
                self._orig.append((mod, fn_name, orig))
                setattr(mod, fn_name, self._wrap(fam, count, orig))
        return self

    def _wrap(self, fam, count, orig):
        def call(*a, **k):
            b, n, later = count(*a, **k)
            ver = later[1]._version if later else None
            self.kept.append((fam, b, n, later, ver))
            return orig(*a, **k)
        return call

    def __exit__(self, *exc):
        for mod, fn_name, orig in reversed(self._orig):
            setattr(mod, fn_name, orig)
        self._orig = []

    def tally(self) -> dict:
        """Family -> (bytes, launches); a family with a kept tensor that
        changed since its call gets (bytes, 0): nothing to read."""
        out = {fam: [0, 0] for fam in FAMILIES}
        bad = set()
        for fam, b, n, later, ver in self.kept:
            if later:
                fn, x = later
                if x._version != ver:
                    bad.add(fam)
                    continue
                b += fn(x)
            out[fam][0] += b
            out[fam][1] += n
        self.kept = []
        for fam in bad:
            out[fam][1] = 0
        return {f: tuple(v) for f, v in out.items()}
