"""The PyTorch port stands alone: no JAX, nothing of the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "uncalled_tpu_torch")

# one intra-op thread: the suite runs several pytest workers side by side,
# and spinning torch thread pools in each of them starve one another
torch.set_num_threads(1)


def _package_modules():
    mods = []
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_import_leaves_jax_and_reference_out():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"for m in {_package_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'uncalled_tpu' or m.startswith('uncalled_tpu.')]\n"
        "print(len(bad), bad[:5])\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("mod", _package_modules())
def test_no_forbidden_import_in_source(mod):
    path = os.path.join(REPO, *mod.split("."))
    path = path + ".py" if os.path.exists(path + ".py") else os.path.join(
        path, "__init__.py")
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "uncalled_tpu"), (mod, n)


def test_entry_points_default_to_cuda(monkeypatch):
    import torch

    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.index.bwa_compat import load_bwa_index
    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.mapping.engine import MapEngine, device_index
    from uncalled_tpu_torch.mapping.pooled import PooledEngine
    from uncalled_tpu_torch.mapping.thresholds import load_uncl
    from uncalled_tpu_torch.poremodel import load_default

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prefix = os.path.join(REPO, "tests", "fixtures", "example_index",
                          "example_ref")
    fmi = load_bwa_index(prefix)
    th = load_uncl(prefix + ".uncl")
    model = load_default()
    conf = Conf()
    with pytest.raises(RuntimeError, match="no CUDA"):
        PooledEngine(fmi, model, th, conf)
    with pytest.raises(RuntimeError, match="no CUDA"):
        MapEngine(fmi, model, th, conf)
    with pytest.raises(RuntimeError, match="no CUDA"):
        BatchMapper(fmi, model, th, conf)
    conf.engine.pooled = False
    with pytest.raises(RuntimeError, match="no CUDA"):
        BatchMapper(fmi, model, th, conf)
    with pytest.raises(RuntimeError, match="no CUDA"):
        device_index(fmi, th, model)
    # the CPU is used only when asked for
    eng = PooledEngine(fmi, model, th, conf, device="cpu", B=4)
    assert eng.fresh_state()["q_rid"].device.type == "cpu"
    eng = MapEngine(fmi, model, th, conf, device="cpu", B=4)
    assert eng.fresh_state()["p_cum"].device.type == "cpu"


@pytest.mark.parametrize("argv", [
    ["map", "{prefix}", "{empty}"],
    ["map", "{prefix}", "{empty}", "--ord"],
    ["sim", "{prefix}", "{empty}"],
    ["realtime", "{prefix}"],
    ["dtw", "{prefix}", "{empty}", "--paf", "{empty}/none.paf"],
], ids=["map", "map-ord", "sim", "realtime", "dtw"])
def test_cli_defaults_to_cuda(monkeypatch, tmp_path, argv):
    """The command line runs on the card unless --device cpu is given, and
    raises without one (no fallback to the CPU)."""
    from uncalled_tpu_torch.__main__ import main
    from uncalled_tpu_torch.realtime import client

    class StandIn(client.MinknowClient):  # no MinKNOW here
        def __init__(self, conf, host, port, chunk_time):
            super().__init__(conf, host, port, chunk_time,
                             connection_factory=lambda: None)

    monkeypatch.setattr(client, "MinknowClient", StandIn)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prefix = os.path.join(REPO, "tests", "fixtures", "example_index",
                          "example_ref")
    argv = [a.format(prefix=prefix, empty=tmp_path) for a in argv]
    with pytest.raises(RuntimeError, match="no CUDA"):
        main(argv)
    with pytest.raises(RuntimeError, match="no CUDA"):
        main(argv + ["--device", "cuda"])


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_card_or_checkout(tmp_path, alone):
    """chip_smoke.py prints no result and exits non-zero without a CUDA
    card, and (with a card faked) when run from a directory that holds
    only the script."""
    import shutil

    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
        code = (
            "import runpy, sys, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            f"sys.argv = [{str(script)!r}]\n"
            f"runpy.run_path({str(script)!r}, run_name='__main__')\n"
        )
        cmd = [sys.executable, "-c", code]
    else:
        cmd = [sys.executable, script]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                       cwd=tmp_path)
    assert r.returncode not in (0, None), r.stdout + r.stderr
    assert '"ok"' not in r.stdout, r.stdout
    assert ("uncalled_tpu_torch not found" if alone else "no CUDA device") \
        in r.stderr, r.stderr


def test_unported_options_raise():
    """The conf defaults construct (slot handoff, drain chain, the bitonic
    sort), and so do both engines in sampled-SA mode (the 1/32 sample on
    the device, no full SA) and the mapper with the device event detector:
    no option of the batch mapper raises any more."""
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.index.bwa_compat import load_bwa_index
    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.mapping.engine import MapEngine
    from uncalled_tpu_torch.mapping.pooled import PooledEngine
    from uncalled_tpu_torch.mapping.thresholds import load_uncl
    from uncalled_tpu_torch.poremodel import load_default

    prefix = os.path.join(REPO, "tests", "fixtures", "example_index",
                          "example_ref")
    fmi, th, model = load_bwa_index(prefix), load_uncl(prefix + ".uncl"), \
        load_default()
    conf = Conf()  # slot_handoff and drain_shrink default on
    bm = BatchMapper(fmi, model, th, conf, device="cpu")
    assert bm.eng.params.handoff and bm.eng.params.sort_mode == "flat"
    assert "sw" in bm.eng.READOUT_KEYS
    for over in ({"sort_mode": "bitonic"}, {"handoff": True}):
        eng = PooledEngine(fmi, model, th, conf, device="cpu", B=4, **over)
        assert all(getattr(eng.params, k) == v for k, v in over.items())
    for cls in (PooledEngine, MapEngine):
        eng = cls(fmi, model, th, conf, device="cpu", B=4, sampled_sa=True)
        assert eng.params.sampled_sa and eng.params.sa_intv == 32
        assert "sa_samp" in eng.idx and "sa" not in eng.idx
        assert eng.idx["sa_samp"].shape == ((fmi.n + 32) // 32,)
    conf.engine.device_dsp = True
    bm = BatchMapper(fmi, model, th, conf, device="cpu")
    assert bm.conf.engine.device_dsp and hasattr(bm, "_prepare_wave")


def test_scan_covers_the_sharded_layer():
    """The import checks above reach the sharded engines and the rank
    runner."""
    mods = _package_modules()
    for m in ("uncalled_tpu_torch.parallel", "uncalled_tpu_torch.parallel.sharded",
              "uncalled_tpu_torch.ops.shard_take",
              "uncalled_tpu_torch.testing.multihost_fixture",
              "uncalled_tpu_torch.testing.multihost_child"):
        assert m in mods, m


def test_scan_covers_the_host_reference_modules():
    """The import checks above reach the oracle, its introsort and the
    FM-range arithmetic; the oracle runs on the host and takes no device."""
    import inspect

    from uncalled_tpu_torch.mapping.oracle import OracleMapper

    mods = _package_modules()
    for m in ("uncalled_tpu_torch.mapping.introsort",
              "uncalled_tpu_torch.mapping.oracle",
              "uncalled_tpu_torch.ranges"):
        assert m in mods, m
    assert "device" not in inspect.signature(OracleMapper).parameters


def test_sharded_engines_default_to_cuda(tmp_path):
    """A sharded engine built without device= takes the rank's card, and
    raises without one; with device="cpu" it builds.  One gloo rank on a
    (1, 1) mesh, in a fresh process (the process group is global)."""
    code = f"""
import os, sys
sys.path.insert(0, {REPO!r})
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
dist.init_process_group("gloo", init_method="file://{tmp_path}/init",
                        rank=0, world_size=1)
mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("dp", "idx"))
torch.cuda.is_available = lambda: False
from uncalled_tpu_torch.config import Conf
from uncalled_tpu_torch.index.bwa_compat import load_bwa_index
from uncalled_tpu_torch.mapping.thresholds import load_uncl
from uncalled_tpu_torch.parallel import ShardedMapEngine, ShardedPooledEngine
from uncalled_tpu_torch.poremodel import load_default
p = os.path.join({REPO!r}, "tests", "fixtures", "example_index", "example_ref")
args = (load_bwa_index(p), load_default(), load_uncl(p + ".uncl"), Conf())
for cls in (ShardedPooledEngine, ShardedMapEngine):
    try:
        cls(*args, mesh=mesh, B=4)
        sys.exit(cls.__name__ + " built without a card")
    except RuntimeError as e:
        assert "no CUDA" in str(e), e
    eng = cls(*args, mesh=mesh, device="cpu", B=4)
    assert eng.fresh_state()["done"].device.type == "cpu"
dist.destroy_process_group()
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stdout + r.stderr
