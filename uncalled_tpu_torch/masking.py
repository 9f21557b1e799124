"""Reference repeat masking for eukaryotic-scale targets.

Self-contained replacement for the reference's masking/ pipeline
(masking/mask_internal.sh + mask_kmers.py + mask_external.sh +
masking/README.md:1-60), without the jellyfish/bowtie external tools:

* ``mask_internal``: iteratively find the single most frequent k-mer
  (jellyfish count equivalent via sort-based counting) and N-mask all of its
  occurrences, merging overlapping runs exactly like mask_kmers.py:8-40.
* ``mask_external`` (long exact repeats): positions covered by an exact
  repeat of length >= min_len occurring >= min_copy times, found with our
  own suffix array + LCP (replacing the bowtie alignment sweep): a suffix
  with LCP >= min_len to a neighbor lies in a repeated substring.
"""

from __future__ import annotations

import sys

import numpy as np

from .index.build import read_fasta, suffix_array_numpy
from .kmer import seq_to_codes


def _top_kmer(codes: np.ndarray, k: int):
    """(kmer_codes, count) of the most frequent k-mer (ignores N runs)."""
    valid = codes < 4
    if k > 27:
        raise ValueError("k too large for packed counting")
    n = len(codes) - k + 1
    if n <= 0:
        return None, 0
    packed = np.zeros(n, dtype=np.int64)
    ok = np.ones(n, dtype=bool)
    for i in range(k):
        packed = (packed << 2) | codes[i : n + i]
        ok &= valid[i : n + i]
    packed = packed[ok]
    if len(packed) == 0:
        return None, 0
    uniq, counts = np.unique(packed, return_counts=True)
    best = np.argmax(counts)
    kmer = uniq[best]
    out = np.array([(kmer >> (2 * (k - 1 - i))) & 3 for i in range(k)],
                   dtype=np.uint8)
    return out, int(counts[best])


def _mask_occurrences(seq: str, kmer: str):
    """N-mask all occurrences of kmer, merging overlapping runs
    (mask_kmers.py:8-40). Returns (masked_seq, n_occurrences)."""
    k = len(kmer)
    useq = seq.upper()
    ranges = []
    n = 0
    i = useq.find(kmer)
    while i >= 0:
        j = i + k
        if not ranges or i > ranges[-1][1]:
            ranges.append((i, j))
        else:
            ranges[-1] = (ranges[-1][0], j)
        n += 1
        i = useq.find(kmer, i + 1)
    if not ranges:
        return seq, 0
    out = []
    prev = 0
    for st, en in ranges:
        out.append(seq[prev:st] + "N" * (en - st))
        prev = en
    out.append(seq[prev:])
    return "".join(out), n


def mask_internal(fasta_in: str, fasta_out: str, k: int, iters: int,
                  log=sys.stderr):
    """Iterative top-k-mer masking (mask_internal.sh main loop)."""
    seqs = [(name, seq.decode()) for name, seq in read_fasta(fasta_in)]
    for it in range(iters):
        all_codes = np.concatenate(
            [seq_to_codes(s) for _, s in seqs]
        ) if seqs else np.zeros(0, np.uint8)
        kmer_codes, count = _top_kmer(all_codes, k)
        if kmer_codes is None or count <= 1:
            break
        kmer = "".join("ACGT"[c] for c in kmer_codes)
        total = 0
        new_seqs = []
        for name, s in seqs:
            m, n = _mask_occurrences(s, kmer)
            new_seqs.append((name, m))
            total += n
        seqs = new_seqs
        log.write(f"Iteration {it}: masked {total} x {kmer}\n")
    _write_fasta(fasta_out, seqs)
    return fasta_out


def long_repeat_mask(codes: np.ndarray, min_len: int) -> np.ndarray:
    """Bool mask of positions inside exact repeats of length >= min_len
    (suffix array + Kasai LCP)."""
    n = len(codes)
    text = np.where(codes < 4, codes, 0).astype(np.uint8)
    from . import native

    sa = native.suffix_array(text)
    if sa is None:
        sa = suffix_array_numpy(text)[:n]
    sa = np.asarray(sa, dtype=np.int64)[:n]
    # Kasai: lcp[r] = LCP(suffix sa[r], suffix sa[r-1])
    rank = np.empty(n, dtype=np.int64)
    rank[sa] = np.arange(n)
    lcp = np.zeros(n, dtype=np.int64)
    h = 0
    for i in range(n):
        r = rank[i]
        if r > 0:
            j = sa[r - 1]
            while i + h < n and j + h < n and text[i + h] == text[j + h]:
                h += 1
            lcp[r] = h
            if h:
                h -= 1
        else:
            h = 0
    mask = np.zeros(n, dtype=bool)
    for r in range(1, n):
        l = lcp[r]
        if l >= min_len:
            for p in (sa[r], sa[r - 1]):
                mask[p : p + l] = True
    # never mask N-free claim for ambiguous spots; keep simple
    return mask


def mask_external(fasta_in: str, fasta_out: str, min_len: int,
                  log=sys.stderr):
    """Long-exact-repeat masking (mask_external.sh role, bowtie-free)."""
    seqs = [(name, seq.decode()) for name, seq in read_fasta(fasta_in)]
    offs = []
    total = 0
    for name, s in seqs:
        offs.append(total)
        total += len(s)
    codes = np.concatenate([seq_to_codes(s) for _, s in seqs])
    mask = long_repeat_mask(codes, min_len)
    out_seqs = []
    n_masked = int(mask.sum())
    for (name, s), off in zip(seqs, offs):
        m = mask[off : off + len(s)]
        chars = np.frombuffer(s.encode(), dtype="S1").copy()
        chars[m] = b"N"
        out_seqs.append((name, b"".join(chars).decode()))
    log.write(f"Masked {n_masked} bp in exact repeats >= {min_len} bp\n")
    _write_fasta(fasta_out, out_seqs)
    return fasta_out


def _write_fasta(path: str, seqs):
    with open(path, "w") as f:
        for name, s in seqs:
            f.write(f">{name}\n")
            for i in range(0, len(s), 80):
                f.write(s[i : i + 80] + "\n")
