"""The reference's FM index, built from the genome alone.

The text is the forward genome followed by its reverse complement, as in
BWA and UNCALLED; rows are the sorted suffixes of text + '$', so row 0 is
the sentinel's suffix.  ``sa[r]`` is the text position of row r,
``L2[c]`` the number of text characters below c, and
``occ(k, c)`` the count of c in the BWT's rows [0, k].  A backward
extension of the interval [st, en] by base b is
[L2[b] + occ(st - 1, b) + 1, L2[b] + occ(en, b)] (UNCALLED's
``BwaIndex::get_neighbor``).

The suffix array is sorted by prefix doubling with ``torch.sort``, on the
card where there is one; everything else is numpy.
"""

from __future__ import annotations

import numpy as np

K = 5
KMER_COUNT = 4 ** K


def suffix_array(text: np.ndarray, device="cpu") -> np.ndarray:
    """Suffix array of text + '$' (n + 1 rows, row 0 = n) by prefix
    doubling: ranks of the first 2k characters from those of the first k,
    until every rank differs."""
    import torch

    n = len(text)
    N = n + 1
    rank = torch.zeros(N, dtype=torch.int64, device=device)
    rank[:n] = torch.from_numpy(text.astype(np.int64)).to(device) + 1
    k = 1
    while True:
        nxt = torch.zeros(N, dtype=torch.int64, device=device)
        if k < N:
            nxt[: N - k] = rank[k:] + 1
        key = rank * (N + 2) + nxt
        skey, sa = torch.sort(key)
        new = torch.zeros(N, dtype=torch.int64, device=device)
        new[1:] = torch.cumsum((skey[1:] != skey[:-1]).long(), 0)
        rank = torch.empty_like(rank)
        rank[sa] = new
        if int(new[-1]) == N - 1:
            return sa.cpu().numpy()
        k *= 2


def full_text(genome: np.ndarray) -> np.ndarray:
    """Forward genome then its reverse complement."""
    g = genome.astype(np.uint8)
    return np.concatenate([g, (3 - g)[::-1]])


def bwt_of(text: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """BWT over the n + 1 rows, 4 for the sentinel."""
    prev = sa - 1
    bwt = np.where(prev >= 0, text[np.maximum(prev, 0)], 4).astype(np.uint8)
    return bwt


class RefFM:
    """The index of one single-sequence reference (the genome's name and
    length), from its text, suffix array and BWT."""

    def __init__(self, name: str, genome_len: int, text: np.ndarray,
                 sa: np.ndarray, bwt: np.ndarray):
        self.ref_names = [name]
        self.ref_lens = np.array([genome_len], np.int64)
        self.ref_offsets = np.array([0], np.int64)
        self.n = len(text)
        self.text = text
        self.sa_full = sa
        counts = np.bincount(text, minlength=4)[:4]
        self.L2 = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        # cnt[c][k + 1] = occ(k, c), for k in [-1, n]
        self.cnt = np.zeros((4, self.n + 2), np.int32)
        for c in range(4):
            np.cumsum(bwt == c, out=self.cnt[c, 1:])
        self.kmer_ranges = self._kmer_ranges()

    def extend(self, start, end, base):
        """Backward extension, scalar or vectorised; start > end when the
        result is empty."""
        if np.ndim(start) == 0 and np.ndim(base) == 0:
            b = int(base)
            row = self.cnt[b]
            l2 = int(self.L2[b])
            return l2 + int(row[int(start)]) + 1, l2 + int(row[int(end) + 1])
        start = np.asarray(start, np.int64)
        end = np.asarray(end, np.int64)
        base = np.asarray(base, np.int64)
        return (self.L2[base] + self.cnt[base, start] + 1,
                self.L2[base] + self.cnt[base, end + 1])

    def _kmer_ranges(self) -> np.ndarray:
        """Every k-mer's range as UNCALLED walks it (bwa_index.hpp:124-132):
        from the head base's [L2[b], L2[b + 1]], extended by the k-mer's
        bases left to right."""
        kmers = np.arange(KMER_COUNT)
        head = (kmers >> (2 * (K - 1))) & 3
        st = self.L2[head].astype(np.int64)
        en = self.L2[head + 1].astype(np.int64)
        for i in range(1, K):
            st, en = self.extend(st, en, (kmers >> (2 * (K - 1 - i))) & 3)
        return np.stack([st, en], axis=1)

    def get_base(self, i):
        """Forward-strand base at position i."""
        return self.text[np.asarray(i, np.int64)]

    def translate_loc(self, sa_loc: int):
        rid = int(np.searchsorted(self.ref_offsets, sa_loc, side="right") - 1)
        if rid < 0 or rid >= len(self.ref_names):
            return None, 0, 0
        return (self.ref_names[rid], int(sa_loc - self.ref_offsets[rid]),
                int(self.ref_lens[rid]))
