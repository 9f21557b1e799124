"""The port's BatchMapper at the conf defaults on the CPU: the in-scan slot
handoff, the straggler drain by state migration (pooled) and by restart
(classic) each give the reference's golden PAF lines byte for byte, and
each case asserts that its path really ran.  The subsets keep the file
short; the full 14 golden reads through these paths run on the card
(chip_smoke.py phase 3)."""

import json
import os

import numpy as np
import pytest
import torch

FX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PREFIX = os.path.join(FX, "example_index", "example_ref")

# one intra-op thread: the suite runs several pytest workers side by side,
# and spinning torch thread pools in each of them starve one another
torch.set_num_threads(1)


class Read:
    def __init__(self, id, signal):
        self.id = id
        self.signal = np.asarray(signal, dtype=np.float32)
        self.channel, self.number, self.start_sample = 1, 0, 0

    @property
    def raw_len(self):
        return len(self.signal)


@pytest.fixture(scope="module")
def assets():
    from uncalled_tpu_torch.index.bwa_compat import load_bwa_index
    from uncalled_tpu_torch.mapping.thresholds import load_uncl
    from uncalled_tpu_torch.poremodel import load_default

    with open(os.path.join(FX, "golden_pafs.json")) as f:
        golden = json.load(f)
    sigs = np.load(os.path.join(FX, "golden_reads.npz"), allow_pickle=True)
    return (load_bwa_index(PREFIX), load_default(),
            load_uncl(PREFIX + ".uncl"), golden, sigs)


def _map(bm, sigs, rids):
    return {p.rd_name: p.to_line()
            for p in bm.map_reads([Read(r, sigs[r]) for r in rids])}


def test_handoff_golden(assets):
    """Default Conf at B=2 (too narrow to drain): more reads than slots,
    so decided slots switch to their standbys on the device."""
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.mapping.batch import BatchMapper

    fmi, model, th, golden, sigs = assets
    conf = Conf()
    conf.engine.batch_reads = 2
    conf.engine.pool_slots_per_read = 512
    bm = BatchMapper(fmi, model, th, conf, device="cpu")
    assert bm.eng.params.handoff
    rids = ["sim_0005_Escherichia_coli_3483_+", "sim_0008_Escherichia_coli_1891_+",
            "sim_0009_Escherichia_coli_2589_+", "sim_0002_Escherichia_coli_6254_+",
            "sim_0003_Escherichia_coli_6188_-"]
    got = _map(bm, sigs, rids)
    assert bm.n_handoff > 0, "no device switch was harvested"
    assert bm._drain_mapper is None
    for rid in rids:
        assert got[rid] == golden[rid], rid


def test_handoff_with_drain_disarm_golden(assets):
    """tests/test_handoff.py's tail mode: at B=8 the lingering standbys
    disarm and enter the straggler drain again; no read is lost."""
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.mapping.batch import BatchMapper

    fmi, model, th, golden, sigs = assets
    conf = Conf()
    conf.engine.batch_reads = 8
    conf.engine.pool_slots_per_read = 512
    bm = BatchMapper(fmi, model, th, conf, device="cpu")
    # the 12 reads that decide (the two that never do run thousands of
    # events: with them the full set runs on the card)
    rids = [r for r in golden if r.startswith("sim_")]
    got = _map(bm, sigs, rids)
    assert len(got) == len(rids), "reads lost through the disarm path"
    for rid in rids:
        assert got[rid] == golden[rid], rid
    assert bm.n_handoff > 0 and bm._drain_mapper is not None


def test_drain_by_migration_golden(assets):
    """tests/test_pooled.py's migration case: B=8 drains at this tiny
    scale, and the stragglers' state moves into the B=4 pooled drain."""
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.mapping.pooled import PooledEngine

    fmi, model, th, golden, sigs = assets
    conf = Conf()
    conf.engine.batch_reads = 8
    conf.engine.pool_slots_per_read = 512
    conf.engine.drain_min_batch = 8
    conf.engine.evt_block = 16
    bm = BatchMapper(fmi, model, th, conf, device="cpu")
    migrated = []
    orig = bm.eng.migrate

    def migrate(state, sel, dst):
        migrated.append(np.asarray(sel).copy())
        return orig(state, sel, dst)

    bm.eng.migrate = migrate
    rids = list(golden)[:10]
    got = _map(bm, sigs, rids)
    assert len(got) == len(rids)
    for rid in rids:
        assert got[rid] == golden[rid], rid
    dm = bm._drain_mapper
    assert dm is not None and isinstance(dm.eng, PooledEngine)
    assert dm.eng.params.B == 4 and dm.T == 32
    assert bm.n_migrate > 0 and migrated, "the migration path must have run"
    assert dm.disp_events > 0


def test_classic_drain_by_restart_golden(assets):
    """tests/test_engine.py's restart case: a classic B=64 entry with two
    reads restarts them on its B=32 drain (which chains further)."""
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.mapping.engine import MapEngine

    fmi, model, th, golden, sigs = assets
    conf = Conf()
    conf.engine.pooled = False
    conf.engine.batch_reads = 64
    bm = BatchMapper(fmi, model, th, conf, device="cpu")
    rids = ["sim_0000_Escherichia_coli_3854_+",
            "sim_0003_Escherichia_coli_6188_-"]
    got = _map(bm, sigs, rids)
    for rid in rids:
        assert got[rid] == golden[rid], rid
    dm = bm._drain_mapper
    assert dm is not None and isinstance(dm.eng, MapEngine)
    assert dm.eng.params.B == max(4, 64 // conf.engine.drain_div) == 32
    assert bm.n_migrate > 0 and bm.disp_events == 0  # restarted at once
