"""Nothing the benchmark runs loads JAX or the JAX package: module names
are compared by their whole top-level name, so the port
(``uncalled_tpu_torch``) is not taken for the JAX package
(``uncalled_tpu``)."""

import os
import subprocess
import sys

from benchmark.harness import core


def test_forbidden_names_compare_whole_top_level_names():
    assert core.forbidden_modules(["uncalled_tpu_torch", "numpy",
                                   "uncalled_tpu_torch.mapping.batch",
                                   "jaxtyping", "flaxen.x"]) == []
    assert core.forbidden_modules(["uncalled_tpu.mapping", "jaxlib.xla",
                                   "jax", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "uncalled_tpu"]


def test_benchmark_modules_load_no_jax():
    code = (
        "import glob, os, sys, importlib\n"
        "sys.path.insert(0, %r)\n"
        "from benchmark.harness import core\n"
        "for f in sorted(glob.glob(os.path.join(core.BENCH, '**', '*.py'),"
        " recursive=True)):\n"
        "    rel = os.path.relpath(f, core.ROOT)[:-3]\n"
        "    if '/tests/' in rel or rel.endswith('run'):\n"
        "        continue\n"
        "    if '/metrics/' in rel or '/drivers/' in rel:\n"
        "        core.load_module(f, 'm_' + rel.replace('/', '_'))\n"
        "    else:\n"
        "        importlib.import_module(rel.replace('/', '.'))\n"
        "import uncalled_tpu_torch.mapping.batch, uncalled_tpu_torch.index.build\n"
        "print(core.forbidden_modules())\n" % core.ROOT)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=core.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
