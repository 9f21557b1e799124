"""Reference genomes made from a seed.

A bacterial-genome-like sequence with the repeat structure that stresses a
seed mapper: an order-1 Markov backbone with E. coli-like base bias,
dispersed IS-element families with divergent copies, a low-divergence
rRNA-like operon repeated 7 times, and short tandem repeats, as
``uncalled_tpu_torch.testing.simulate.realistic_genome`` makes it.  Here
the repeat sizes and copy counts are fixed by the configuration (there
they are drawn from the seed, which changes the mapping work from seed to
seed), and the Markov chain is drawn without a Python loop over bases (a
prefix composition of the per-position transition maps): a 4.7 Mb genome
takes about a second instead of ten.
"""

from __future__ import annotations

import numpy as np

# E. coli-ish order-1 transition matrix (rows ACGT -> cols ACGT)
_T = np.array([
    [0.30, 0.22, 0.20, 0.28],
    [0.26, 0.24, 0.28, 0.22],
    [0.24, 0.28, 0.24, 0.24],
    [0.20, 0.24, 0.26, 0.30],
])
_CUM = np.cumsum(_T / _T.sum(axis=1, keepdims=True), axis=1)


def _compose_table() -> np.ndarray:
    """A map of {0..3} to itself packed in a byte (entry s in bits 2s and
    2s+1); table[a * 256 + b] is the byte of a o b, (a o b)(s) = a(b(s))."""
    a = np.arange(256)[:, None]
    b = np.arange(256)[None, :]
    out = np.zeros((256, 256), np.int64)
    for s in range(4):
        bs = (b >> (2 * s)) & 3
        out |= ((a >> (2 * bs)) & 3) << (2 * s)
    return out.astype(np.uint8).reshape(-1)


_COMPOSE = _compose_table()


def markov(rng: np.random.Generator, n: int) -> np.ndarray:
    """n bases of the order-1 chain from a uniform start, as uint8 codes.

    Position i's base is f_i(base i-1) with f_i(s) = the first j where
    u_i <= cum[s, j]; the chain is the prefix composition f_i o ... o f_0
    applied to the start, computed by doubling over the maps packed in a
    byte each."""
    start = int(rng.integers(4))
    u = rng.random(n)
    maps = np.zeros(n, np.int64)
    for s in range(4):
        nxt = np.minimum(np.searchsorted(_CUM[s], u), 3)
        maps |= nxt << (2 * s)
    maps = maps.astype(np.uint16)
    k = 1
    while k < n:
        # maps[i] := maps[i] o maps[i - k]
        maps[k:] = _COMPOSE[(maps[k:] << 8) | maps[:-k]]
        k *= 2
    return ((maps >> (2 * start)) & 3).astype(np.uint8)


def realistic_genome(n_bp: int, rng: np.random.Generator,
                     repeats: dict) -> np.ndarray:
    """An ``n_bp`` genome as uint8 codes (A=0 C=1 G=2 T=3).  ``repeats``
    fixes the repeat structure, so every seed gets the same sizes and
    copy counts at other places and with other bases:

    * ``is_families``: [length, copies] of each dispersed IS-element
      family; each copy diverges from the family's consensus by a share
      drawn uniformly from ``is_divergence`` ([lo, hi]);
    * ``operon``: [length, copies, divergence] of the rRNA-like operon;
    * ``tandem``: [unit length, repeats] of each short tandem repeat.
    """
    genome = markov(rng, n_bp)

    def mutate(seq, div):
        seq = seq.copy()
        m = rng.random(len(seq)) < div
        seq[m] = (seq[m] + rng.integers(1, 4, int(m.sum()))) % 4
        return seq

    def paste(seq):
        at = int(rng.integers(0, n_bp - len(seq)))
        genome[at: at + len(seq)] = seq

    lo, hi = repeats["is_divergence"]
    for length, copies in repeats["is_families"]:
        cons = markov(rng, length)
        for _ in range(copies):
            paste(mutate(cons, rng.uniform(lo, hi)))
    length, copies, div = repeats["operon"]
    operon = markov(rng, min(length, n_bp // 20))
    for _ in range(copies):
        paste(mutate(operon, div))
    for unit_len, reps in repeats["tandem"]:
        unit = markov(rng, unit_len)
        paste(np.tile(unit, reps)[: n_bp // 100])
    return genome


def write_fasta(path: str, name: str, codes: np.ndarray) -> None:
    """One record, 80 bases a line."""
    seq = np.frombuffer(b"ACGT", np.uint8)[codes].tobytes()
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        for i in range(0, len(seq), 80):
            f.write(seq[i: i + 80] + b"\n")
