"""The port's multi-process dp layout against the JAX package's
(tests/test_multihost.py, zero tolerance): two ``gloo`` ranks each advance
their dp shard of ``testing.multihost_fixture``'s batch one block through
``pool_advance_block``, and the ten decision keys gathered over the ranks
equal JAX's single-process ``shard_map`` of ``pool_advance_block`` on a
2-device dp mesh, integers equal and floats as raw bits: from the fresh
state that test feeds (every slot done), and from it with every slot
reset, so that the block maps."""


import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from uncalled_tpu_torch.testing import multihost_child as mc

# one intra-op thread: the suite runs several pytest workers side by side,
# and spinning torch thread pools in each of them starve one another
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("multihost"))
    procs = mc.spawn(2, out, "multihost", device="cpu", timeout=240)
    yield procs, out
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def jax_out(launched):
    """JAX's single-process run (while the ranks run)."""
    from jax import shard_map

    from uncalled_tpu.mapping.pooled import pool_advance_block, reset_pool_rows
    from uncalled_tpu.testing.multihost_fixture import (
        build_engine,
        global_fresh_state,
        global_inputs,
    )

    eng, T = build_engine()
    mesh = jax.make_mesh((2,), ("dp",), devices=jax.devices()[:2])
    means, on = global_inputs(2)
    state = jax.tree.map(jax.numpy.asarray, global_fresh_state(eng, 2))
    step = jax.jit(shard_map(
        lambda s, m, o: pool_advance_block(eng.idx, eng.params, s, m, o),
        mesh=mesh, in_specs=(P("dp"), P("dp"), P("dp")), out_specs=P("dp"),
        check_vma=False))
    reset = jax.jit(shard_map(
        lambda s, m: reset_pool_rows(s, m), mesh=mesh,
        in_specs=(P("dp"), P("dp")), out_specs=P("dp"), check_vma=False))
    got = {}
    for tag, st in (("", state), ("reset_", reset(
            state, jax.numpy.ones(means.shape[0], bool)))):
        out = step(st, jax.numpy.asarray(means), jax.numpy.asarray(on))
        got.update({tag + k: np.asarray(out[k]) for k in mc.DECISION_KEYS})
    return got


@pytest.fixture(scope="module")
def ranks(launched, jax_out):
    procs, out = launched
    return mc.collect(procs, out, "multihost", timeout=240)


def test_two_rank_pooled_step_matches_single(ranks, jax_out):
    res, got = ranks
    assert [r["world"] for r in res] == [2, 2] and res[0]["shard_B"] == 2
    assert sorted(got) == sorted(jax_out)
    # the JAX test's fresh state: every slot done, nothing advances; reset:
    # all four reads take every event
    assert int(jax_out["evt_i"].sum()) == 0
    assert (jax_out["reset_evt_i"] == res[0]["T"]).all()
    assert int((jax_out["reset_q_total"] > 0).sum()) > 0  # paths in the pool
    for k, w in jax_out.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype.kind == "f":
            assert np.array_equal(g.view(np.int32), w.view(np.int32)), k
        else:
            assert np.array_equal(g, w), k


def test_fixture_matches_jax_fixture():
    """The port's fixture builds JAX's index, batch and fresh layout."""
    from uncalled_tpu.testing import multihost_fixture as jf

    from uncalled_tpu_torch.testing import multihost_fixture as tf

    jeng, jT = jf.build_engine()
    teng, tT = tf.build_engine(device="cpu")
    assert jT == tT and jeng.params.B == teng.params.B == tf.SHARD_B
    for k, v in jeng.idx.items():
        if isinstance(v, int):
            assert teng.idx[k] == v, k
        else:
            assert np.array_equal(np.asarray(v), teng.idx[k].numpy()), k
    for a, b in zip(jf.global_inputs(3), tf.global_inputs(3)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    js = jf.global_fresh_state(jeng, 3)
    ts = tf.global_fresh_state(teng, 3)
    assert sorted(js) == sorted(ts)
    for k in js:
        assert js[k].dtype == ts[k].dtype and np.array_equal(js[k], ts[k]), k
