"""The port's sharded engines (``uncalled_tpu_torch.parallel``) over four
``gloo`` ranks on a (2, 2) ``(dp, idx)`` mesh, against the golden lines and
against the JAX package's sharded engines on a (2, 2) virtual CPU mesh,
with zero tolerance: the cases of tests/test_sharded.py (the tables really
split, ``ShardedMapEngine`` at B=4, ``ShardedPooledEngine`` at B=4 and with
more reads than slots at B=2), one ``advance`` whose rank-gathered state
equals JAX's global state on every key, bits equal, the divisibility
errors, and ``mesh=None``.

The ranks run ``python -m uncalled_tpu_torch.testing.multihost_child``
once for the module (about 20 s on the CPU), while the JAX reference runs
in this process; the JAX index is built from the in-repo BWA files.
"""

import os

import jax
import numpy as np
import pytest
import torch

from uncalled_tpu_torch.testing import multihost_child as mc

FX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PREFIX = os.path.join(FX, "example_index", "example_ref")

# one intra-op thread: the suite runs several pytest workers side by side,
# and spinning torch thread pools in each of them starve one another
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharded"))
    procs = mc.spawn(4, out, "sharded", device="cpu", timeout=240)
    yield procs, out
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def jax_assets():
    from uncalled_tpu.index.bwa_compat import load_bwa_index
    from uncalled_tpu.mapping.oracle import load_uncl
    from uncalled_tpu.poremodel import load_default

    mesh = jax.make_mesh((2, 2), ("dp", "idx"), devices=jax.devices()[:4])
    return (load_bwa_index(PREFIX), load_default(),
            load_uncl(PREFIX + ".uncl"), mesh)


def jax_conf(**fields):
    from uncalled_tpu.config import Conf

    conf = Conf()
    for k, v in fields.items():
        setattr(conf.engine, k, v)
    return conf


def jax_engine(kind, assets, conf, **over):
    from uncalled_tpu.parallel import ShardedMapEngine, ShardedPooledEngine

    fmi, model, th, mesh = assets
    cls = ShardedPooledEngine if kind == "pooled" else ShardedMapEngine
    return cls(fmi, model, th, conf, mesh=mesh, **over)


@pytest.fixture(scope="module")
def jax_lines(launched, jax_assets):
    """JAX's sharded engines' lines on the cases of the ranks (computed
    while the ranks run)."""
    from uncalled_tpu.mapping.batch import BatchMapper

    fmi, model, th, _ = jax_assets
    sigs = np.load(os.path.join(FX, "golden_reads.npz"), allow_pickle=True)
    out = {}
    for name, (kind, cf, over, rids) in mc.GOLDEN_CASES.items():
        conf = jax_conf(**cf)
        eng = jax_engine(kind, jax_assets, conf, **over)
        bm = BatchMapper(fmi, model, th, conf, engine=eng)
        out[name] = {p.rd_name: p.to_line() for p in bm.map_reads(
            [mc.Read(r, sigs[r]) for r in rids])}
    return out


@pytest.fixture(scope="module")
def ranks(launched, jax_lines):
    procs, out = launched
    return mc.collect(procs, out, "sharded", timeout=240)


def test_tables_are_actually_sharded(ranks, jax_assets):
    res, _ = ranks
    fmi = jax_assets[0]
    nb = (fmi.n + 31) // 32
    padded = {"occ_rows": nb + nb % 2, "sa_samp": (fmi.n + 32) // 32}
    padded["sa_samp"] += padded["sa_samp"] % 2
    for r in res:
        t = r["tables"]
        for kind in ("map", "pooled"):
            for key, (local, total, nbytes) in t[kind].items():
                assert total == padded[key] and local == total // 2, (kind,
                                                                      key)
                assert nbytes == local * (24 if key == "occ_rows" else 4)
        assert t["map_local_B"] == 2 and t["pooled_local_B"] == 2
    # the same split as JAX's on its (2, 2) mesh
    eng = jax_engine("map", jax_assets, jax_conf(batch_reads=4),
                     B=4, P=64, C=64, R=16, CL=32)
    for key in ("occ_rows", "sa_samp"):
        rows = {s.data.shape[0] for s in eng._tables[key].addressable_shards}
        assert rows == {res[0]["tables"]["map"][key][0]}


@pytest.mark.parametrize("case", sorted(mc.GOLDEN_CASES))
def test_golden_lines(ranks, jax_lines, case):
    """Every rank gives the golden line of every read, and JAX's sharded
    engine's."""
    import json

    with open(os.path.join(FX, "golden_pafs.json")) as f:
        golden = json.load(f)
    res, _ = ranks
    rids = mc.GOLDEN_CASES[case][3]
    for r in res:
        got = r["golden"][case]["lines"]
        assert sorted(got) == sorted(rids)
        for rid in rids:
            assert got[rid] == golden[rid], (r["rank"], rid)
            assert got[rid] == jax_lines[case][rid], (r["rank"], rid)
        assert got == res[0]["golden"][case]["lines"]


def test_advance_state_equals_jax(ranks, jax_assets):
    """One advance from a fresh state (20 events of four golden reads): the
    state gathered over the dp ranks equals the JAX global state on every
    key, dtypes equal, floats as raw bits."""
    _, arrays = ranks
    kind, cf, over, _ = mc.GOLDEN_CASES["pooled"]
    eng = jax_engine(kind, jax_assets, jax_conf(**cf), **over)
    means, on = arrays["in_means"], arrays["in_on"]
    B = eng.params.B
    state = eng.reset_slots(eng.fresh_state(), np.ones(B, bool))
    want = jax.tree.map(np.asarray, eng.advance(state, means, on))
    got = {k: v for k, v in arrays.items() if not k.startswith("in_")}
    assert sorted(got) == sorted(want)
    # every read is still mapping, with paths in its pool segment
    assert (want["evt_i"] == mc.ADVANCE_EVENTS).all()
    assert (want["n_paths"] > 0).all() and not want["done"].any()
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype.kind == "f":
            assert np.array_equal(g.view(np.int32), w.view(np.int32)), k
        else:
            assert np.array_equal(g, w), k


def test_drain_migration_refused(ranks, jax_assets):
    """Where the drain chain would migrate a sharded entry's state, JAX's
    BatchMapper fails (migrate_pool_state on the dp-sharded state) and the
    port raises a ValueError naming drain_shrink, on every rank; the reads
    that decided before it give their golden lines."""
    import json

    from uncalled_tpu.mapping.batch import BatchMapper

    with open(os.path.join(FX, "golden_pafs.json")) as f:
        golden = json.load(f)
    fmi, model, th, _ = jax_assets
    sigs = np.load(os.path.join(FX, "golden_reads.npz"), allow_pickle=True)
    conf = jax_conf(**mc.DRAIN_CONF)
    bm = BatchMapper(fmi, model, th, conf,
                     engine=jax_engine("pooled", jax_assets, conf))
    tried = []
    migrate = bm._try_migrate

    def spy(dm, state, keep):
        tried.append(list(keep))
        return migrate(dm, state, keep)

    bm._try_migrate = spy
    with pytest.raises(Exception) as e:
        list(bm.map_reads([mc.Read(r, sigs[r]) for r in mc.DRAIN_READS]))
    assert tried and "migrate" in "".join(
        str(t.name) for t in e.traceback)
    res, _ = ranks
    for r in res:
        d = r["drain"]
        assert d["error"] is not None and "drain_shrink" in d["error"]
        assert d["n_migrate"] == 1 and d["lines"]
        assert all(d["lines"][k] == golden[k] for k in d["lines"])
        assert d == res[0]["drain"]


def test_divisibility_errors(ranks, jax_assets):
    """The same ValueErrors as JAX's for every budget that does not divide
    by dp."""
    res, _ = ranks
    want = []
    for kind, over in mc.BAD_SPLITS:
        with pytest.raises(ValueError) as e:
            jax_engine(kind, jax_assets,
                       jax_conf(batch_reads=4, pool_slots_per_read=512),
                       **over)
        want.append(str(e.value))
    for r in res:
        assert r["errors"] == want


def test_mesh_none_raises():
    from uncalled_tpu_torch.index.bwa_compat import load_bwa_index
    from uncalled_tpu_torch.mapping.thresholds import load_uncl
    from uncalled_tpu_torch.parallel import (
        ShardedMapEngine,
        ShardedPooledEngine,
    )
    from uncalled_tpu_torch.poremodel import load_default

    args = (load_bwa_index(PREFIX), load_default(), load_uncl(PREFIX + ".uncl"))
    with pytest.raises(ValueError, match="needs a DeviceMesh"):
        ShardedPooledEngine(*args, device="cpu")
    with pytest.raises(ValueError, match="needs a DeviceMesh"):
        ShardedMapEngine(*args, device="cpu")
