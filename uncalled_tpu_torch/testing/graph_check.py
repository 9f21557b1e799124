"""The pooled engine's graph runner held to the eager block, bit for bit.

``compare_blocks`` runs the same blocks through ``pool_advance_block`` and
through a ``graphs.BlockGraphs`` (CUDA graphs on the card, or the same
cuts and buffers eagerly with ``graphs=False``), feeding both the same
inputs: every slot a read's events, standby windows armed on every
second slot (with the handoff), the switched slots promoted to their
standby's events at the next block, and decided slots reset to a new
read, as the host loop does.  The host's choices read the eager state, so
both paths see one input stream whatever they compute.  After every
block it lists the state keys whose bits differ, and it counts the
switches, promotions and resets the host made.

``golden_events`` gives the golden reads' normalised events (the inputs
of ``tests/test_torch_graph_step.py`` and of ``chip_smoke.py``'s card
check).
"""

from __future__ import annotations

import os

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
FIXTURES = os.path.join(_REPO, "tests", "fixtures")
PREFIX = os.path.join(FIXTURES, "example_index", "example_ref")


def golden_events() -> dict:
    """Normalised events of the 14 golden reads by read id, in file
    order (the 12 simulated reads decide within 34-80 events of their
    start on the example index; ``f41a60f7-...`` and ``noise_1`` do not
    within 120)."""
    from .. import native
    from ..mapping.batch import normalize_events
    from ..poremodel import load_default

    model = load_default()
    sigs = np.load(os.path.join(FIXTURES, "golden_reads.npz"),
                   allow_pickle=True)
    out = {}
    for r in sorted(sigs.files):
        ev = native.detect_events(sigs[r], 0.0, 40000.0)
        out[r] = normalize_events(ev["mean"], model.means_mean,
                                  model.means_stdv)[0]
    return out


def example_index(device):
    """The in-repo example index's device tables."""
    from ..index.bwa_compat import load_bwa_index
    from ..mapping.engine import device_index
    from ..mapping.thresholds import load_uncl
    from ..poremodel import load_default

    return device_index(load_bwa_index(PREFIX), load_uncl(PREFIX + ".uncl"),
                        load_default(), device=device)


def bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits: f32 as int32, so NaN payloads and -0.0 count."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def differ(a: dict, b: dict) -> list:
    """The keys of two states whose bits differ (or that one lacks)."""
    keys = sorted(set(a) | set(b))
    return [k for k in keys if k not in a or k not in b
            or a[k].shape != b[k].shape or a[k].dtype != b[k].dtype
            or not torch.equal(bits(a[k]), bits(b[k]))]


class _Host:
    """The inputs of successive blocks, chosen from the eager state."""

    def __init__(self, events, B, T, W, handoff):
        self.events, self.B, self.T, self.W = events, B, T, W
        self.handoff = handoff
        n = len(events)
        self.next_read = 0
        self.stream = [None] * B
        self.fed = np.zeros(B, np.int64)
        for b in range(B):
            self._admit(b)
        # slot b's standby: a read of the other half of the list
        self.standby = [events[(b + n // 2) % n] if handoff and b % 2 == 0
                        else None for b in range(B)]
        self.promote = np.zeros(B, bool)
        self.switched = self.resets = 0

    def _admit(self, b):
        n = len(self.events)
        k = self.next_read
        self.next_read += 1
        # the same read again starts a few events in, so slots differ
        self.stream[b] = self.events[k % n][(k // n) * 7:]
        self.fed[b] = 0

    def block(self):
        B, T, W = self.B, self.T, self.W
        means = np.zeros((B, T), np.float32)
        on = np.zeros((B, T), bool)
        for b in range(B):
            m = self.stream[b][self.fed[b]: self.fed[b] + T]
            means[b, : len(m)] = m
            on[b, : len(m)] = True
            self.fed[b] += len(m)
        if not self.handoff:
            return means, on, None
        sb_m = np.zeros((B, W), np.float32)
        sb_o = np.zeros((B, W), bool)
        armed = np.zeros(B, bool)
        for b, s in enumerate(self.standby):
            if s is not None:
                w = s[:W]
                sb_m[b, : len(w)] = w
                sb_o[b, : len(w)] = True
                armed[b] = True
        prom = self.promote.copy()
        self.promote[:] = False
        return means, on, (sb_m, sb_o, armed, prom)

    def after(self, st) -> np.ndarray:
        """Read the eager state after a block: promote the slots that
        switched (their standby's events from its evt_i + T on), and
        return the mask of decided slots to reset to a new read."""
        done = st["done"].cpu().numpy()
        sw = st["sw"].cpu().numpy()
        evt = st["evt_i"].cpu().numpy()
        reset = np.zeros(self.B, bool)
        for b in range(self.B):
            if sw[b] and self.standby[b] is not None:
                self.stream[b] = self.standby[b]
                self.fed[b] = min(int(evt[b]) + self.T, len(self.stream[b]))
                self.standby[b] = None
                self.promote[b] = True
                self.switched += 1
            elif done[b] and not sw[b]:
                self._admit(b)
                reset[b] = True
                self.resets += 1
        return reset


def compare_blocks(idx, p, events, n_blocks: int, T: int, device,
                   graphs: bool = True, migrate_to=None):
    """``n_blocks`` blocks of T events (``events``: the reads' event
    arrays, admitted in turn) through ``pool_advance_block`` and
    through ``BlockGraphs``; with ``migrate_to`` (a smaller PoolParams)
    both states move there (the first ``migrate_to.B`` slots) before the
    last block.  Returns (one list a block of the keys that differ, the
    host's counts: ``switched`` slots promoted, ``resets``)."""
    from ..mapping import graphs as gr
    from ..mapping import pooled as tp

    dev = torch.device(device)
    W = 2 * T if p.handoff else 0
    host = _Host(events, p.B, T, W, p.handoff)
    state = tp.reset_pool_rows(tp.make_pool_state(p, dev),
                               torch.ones(p.B, dtype=torch.bool, device=dev))
    se, sg = state, state
    run = gr.BlockGraphs(idx, p, T, W, dev, graphs=graphs)
    out, counts = [], dict(switched=0, resets=0)
    for k in range(n_blocks):
        if migrate_to is not None and k == n_blocks - 1:
            sel = torch.arange(migrate_to.B, dtype=torch.int32, device=dev)
            se = tp.migrate_pool_state(p, migrate_to, se, sel)
            sg = tp.migrate_pool_state(p, migrate_to, sg, sel)
            p = migrate_to
            counts["switched"] += host.switched
            counts["resets"] += host.resets
            host = _Host(events, p.B, T, W, p.handoff)
            run = gr.BlockGraphs(idx, p, T, W, dev, graphs=graphs)
        means, on, sb = host.block()
        dsb = None if sb is None else tuple(
            torch.as_tensor(a, device=dev) for a in sb)
        se = tp.pool_advance_block(idx, p, se, torch.as_tensor(means,
                                                               device=dev),
                                   torch.as_tensor(on, device=dev), sb=dsb)
        sg = run.run(sg, means, on, sb)
        out.append(differ(se, sg))
        reset = host.after(se)
        if reset.any():
            mask = torch.as_tensor(reset, device=dev)
            se = tp.reset_pool_rows(se, mask)
            sg = tp.reset_pool_rows(sg, mask)
    counts["switched"] += host.switched
    counts["resets"] += host.resets
    return out, counts
