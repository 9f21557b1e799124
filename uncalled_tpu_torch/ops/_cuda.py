"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At first use every source is compiled by its own ``nvcc`` process, all
started together, into a shared library with a plain C interface under
the package's gitignored ``_build/`` directory, and loaded with ctypes.
Each C launcher takes device pointers (``tensor.data_ptr()``), plain
ints and the current CUDA stream, launches on that stream without
synchronising, and returns ``cudaGetLastError()``; :func:`launch` raises
on a non-zero code.

``COUNTS`` holds one plain integer per kernel: its wrapper adds one where
it launches the kernel, so a run can show the main path went through it.
The two tracker folds also count which of their two forms ran.
"""

from __future__ import annotations

import array
import ctypes
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# C launcher -> (source stem, argument kinds): p = device pointer,
# i = int, a = host array of device pointers, q = host array of int64
# (device pointers, sizes, strides, bounds, constants); every launcher
# ends with the stream argument.
_FUNCS = {
    "flat_gather_cols_i32": ("flat_gather", "qpp"),
    "pair_counts_i32": ("flat_gather", "ppiiiip"),
    "ring_assemble_i32": ("stepkern", "ppppppii"),
    "tracker_fold_compact": ("tracker_kernel", "aiiiiiii"),
    "tracker_fold_rows": ("tracker_kernel", "aiiiiiii"),
    "row_gather_cols_i32": ("row_gather", "qpp"),
    "sort_net_i32": ("sortkern", "aiipiqi"),
    "sa_lookup_i32": ("sa_lookup", "pppppiiii"),
    "sa_walk_step_i32": ("sa_lookup", "ppppiiiiii"),
    "shard_take_i32": ("shard", "pppiiii"),
    "detect_block_f32": ("detect", "aii"),
    "seg_running_max_i32": ("seg_scan", "ppppii"),
    # measurement probes (chip_smoke.py), no kernel of the mapper
    "probe_empty": ("probe", "iii"),
    "probe_chase": ("probe", "pip"),
    "probe_detect_chain": ("detect", "ip"),
    "probe_div_check": ("detect", "ip"),
}

COUNTS = {
    "flat_gather": 0,
    "pair_counts": 0,
    "ring_assemble": 0,
    "tracker_fold": 0,
    "tracker_fold_rows": 0,
    # which form of the two folds ran (ops/tracker_kernel.py fold_launch)
    "tracker_fold_shared": 0,
    "tracker_fold_device": 0,
    "tracker_fold_rows_shared": 0,
    "tracker_fold_rows_device": 0,
    "row_gather": 0,
    "merge_level": 0,
    "sort_runs": 0,
    "sa_lookup": 0,
    "detect": 0,
    # launched inside the step's graph pieces: counts eager calls and
    # captures, not replays
    "seg_running_max": 0,
    # the sharded engines (parallel/sharded.py): the shard-local row gather
    # and the sharded LF-walk's local runs
    "shard_take": 0,
    "sa_walk_step": 0,
}

_libs: dict = {}
_paths: dict = {}
build_seconds = None


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                     "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def build() -> dict:
    """Compile every ``csrc/*.cu`` whose library is missing or older than
    its source or a ``csrc/*.cuh`` header (one nvcc each, in parallel);
    returns stem -> .so path."""
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    names = os.listdir(SRC_DIR)
    stems = sorted(f[:-3] for f in names if f.endswith(".cu"))
    headers = [os.path.join(SRC_DIR, f) for f in names if f.endswith(".cuh")]
    t0 = time.time()
    procs = {}
    out = {}
    for stem in stems:
        src = os.path.join(SRC_DIR, stem + ".cu")
        so = os.path.join(BUILD_DIR, f"lib{stem}.so")
        out[stem] = so
        newest = max(os.path.getmtime(f) for f in [src, *headers])
        if os.path.exists(so) and os.path.getmtime(so) >= newest:
            continue
        log = open(os.path.join(BUILD_DIR, stem + ".log"), "w")
        procs[stem] = (
            subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", so, src],
                stdout=log, stderr=subprocess.STDOUT,
            ),
            log,
        )
    failed = []
    for stem, (proc, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(stem)
    build_seconds = time.time() - t0
    if failed:
        msgs = []
        for stem in failed:
            with open(os.path.join(BUILD_DIR, stem + ".log")) as f:
                msgs.append(f"--- {stem}.cu ---\n{f.read()[-4000:]}")
        raise RuntimeError("nvcc failed:\n" + "\n".join(msgs))
    return out


def _lib(stem: str):
    lib = _libs.get(stem)
    if lib is None:
        if not _paths:
            _paths.update(build())
        lib = ctypes.CDLL(_paths[stem])
        for name, (src, kinds) in _FUNCS.items():
            if src == stem:
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [
                    ctypes.c_int if k == "i" else ctypes.c_void_p
                    for k in kinds
                ] + [ctypes.c_void_p]
        _libs[stem] = lib
    return lib


def _arg(kind, v):
    if kind == "p":
        return ctypes.c_void_p(v.data_ptr())
    if kind == "a":
        arr = (ctypes.c_void_p * len(v))(*[t.data_ptr() for t in v])
        return arr
    if kind == "q":  # one buffer copy, no per-element ctypes conversion
        return (ctypes.c_longlong * len(v)).from_buffer(array.array("q", v))
    return ctypes.c_int(int(v))


def launch(name: str, *args) -> None:
    """Call C launcher ``name`` with tensors (``p``), lists of tensors
    (``a``), lists of ints (``q``) and ints (``i``) on the current stream;
    raise on a CUDA error."""
    stem, kinds = _FUNCS[name]
    fn = getattr(_lib(stem), name)
    if len(args) != len(kinds):
        raise TypeError(f"{name}: expected {len(kinds)} args, got {len(args)}")
    # the raw handle of the current stream (what torch.cuda.current_stream()
    # .cuda_stream gives, without its Stream object and device checks: a
    # graph replay launches ~35 wrappers an event)
    stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
    keep = [_arg(k, v) for k, v in zip(kinds, args)]
    rc = fn(*keep, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def check(t: torch.Tensor, name: str, dtypes, ndim: int, device) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-D tensor of one of
    ``dtypes`` on ``device`` (what every kernel wrapper takes)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-D, expected {ndim}-D")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
