"""Judge the program's PAF lines by the plain reference's.

``prepare`` builds the reference's index from the genome the benchmark
made (the suffix array on the card where there is one) and fits its
thresholds, writing what the workers need under the run's work
directory.  ``reference_lines`` maps reads, each made again from (seed,
read number), in worker processes: the reference is sequential Python, so
after the window it runs on several cores.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from . import fm, params


def prepare(work: str, genome: np.ndarray, name: str, conf: dict,
            device="cpu") -> dict:
    text = fm.full_text(genome)
    sa = fm.suffix_array(text, device)
    bwt = fm.bwt_of(text, sa)
    paths = dict(genome=os.path.join(work, "ref_genome.npy"),
                 sa=os.path.join(work, "ref_sa.npy"),
                 bwt=os.path.join(work, "ref_bwt.npy"))
    np.save(paths["genome"], genome.astype(np.uint8))
    np.save(paths["sa"], sa.astype(np.int32))
    np.save(paths["bwt"], bwt)
    idx = fm.RefFM(name, len(genome), text, sa, bwt)
    th = params.bin_thresholds(params.fit_default(idx, conf["index"]))
    return dict(paths=paths, name=name, threshes=th, conf=conf)


_W: dict = {}


def _init(spec, seed, mix, hi):
    from ..traffic.reads import MODEL_NPZ, load_levels
    from .mapper import RefMapper, pore_model

    p = spec["paths"]
    genome = np.load(p["genome"])
    sa = np.load(p["sa"], mmap_mode="r")
    idx = fm.RefFM(spec["name"], len(genome), fm.full_text(genome), sa,
                   np.load(p["bwt"]))
    _W.update(genome=genome, seed=seed, mix=mix, levels=load_levels(),
              mapper=RefMapper(idx, pore_model(MODEL_NPZ), spec["threshes"],
                               spec["conf"], hi=getattr(np, hi)))


def _map(i):
    from ..traffic.reads import make_read

    r = make_read(_W["genome"], _W["seed"], i, _W["mix"], _W["levels"])
    return i, _W["mapper"].map_read(r).to_line()


def reference_lines(spec, seed, mix, numbers, workers, hi="float64"):
    """Read number -> the reference's PAF line, for ``numbers``."""
    if not numbers:
        return {}
    with ProcessPoolExecutor(min(workers, len(numbers)),
                             mp_context=multiprocessing.get_context("spawn"),
                             initializer=_init,
                             initargs=(spec, seed, mix, hi)) as ex:
        return dict(ex.map(_map, list(numbers)))


def read_number(read_id: str) -> int:
    """The stream position a read's name carries (``r<7 digits>_...``)."""
    return int(read_id[1:8])


def sample(numbers, k: int, seed: int):
    """``k`` of ``numbers`` drawn from the seed (all where k is larger)."""
    numbers = sorted(numbers)
    if k >= len(numbers):
        return numbers
    rng = np.random.default_rng([seed, 3])
    return sorted(np.asarray(numbers)[rng.choice(len(numbers), k,
                                                  replace=False)].tolist())
