"""BWT / FM-index — the reference's alternative to the suffix array.

Reference parity: BLASR can anchor through a BWT-FM index instead of the
SA (``--bwt``, Blasr.cpp:1073-1080; search dispatch BlasrAlignImpl.hpp:51-58)
built/inverted by the ``sa2bwt`` / ``bwt2sa`` tools
(extrautils/SuffixArrayToBWT.cpp:48, BwtToSuffixArray.cpp:33).  The
trade-off is the same (smaller artifact, slower search); the device hot path
keeps the k-mer table, and ``--bwt`` indexes are accepted by converting at
load (plus an exact FM backward search for API/tool parity).

Alphabet: 0..3 ACGT, 4 N, 5 sentinel (one '$', lexicographically largest
here so the plain SA over codes needs no re-sorting; order within the FM
search is defined by the C[] vector, not code order).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

SENTINEL = 5
FORMAT_VERSION = 1


class FMIndex:
    """FM-index over a genome code array (exact counts via per-character
    cumulative occ tables; memory ~6 ints/base, sized for tool/test and
    moderate-genome use — the mapping hot path uses the k-mer table)."""

    def __init__(self, bwt: np.ndarray, sa_sample: np.ndarray,
                 sample_rate: int, counts: np.ndarray):
        self.bwt = bwt
        self.sample_rate = sample_rate
        self.sa_sample = sa_sample
        self.counts = counts          # C[c]: # of codes < c in the text
        self._occ = {}
        for c in range(6):
            self._occ[c] = np.concatenate(
                [[0], np.cumsum(bwt == c, dtype=np.int64)])

    @staticmethod
    def from_text(codes: np.ndarray, sa: np.ndarray = None,
                  sample_rate: int = 32) -> "FMIndex":
        codes = np.asarray(codes, dtype=np.uint8)
        if sa is None:
            from blasr_tpu.index.suffix_array import build_suffix_array
            text = np.concatenate(
                [codes, np.asarray([SENTINEL], np.uint8)])
            sa = build_suffix_array(text)
        else:
            sa = np.asarray(sa)
            if len(sa) == len(codes):   # no sentinel row: synthesize it
                text = np.concatenate(
                    [codes, np.asarray([SENTINEL], np.uint8)])
                from blasr_tpu.index.suffix_array import build_suffix_array
                sa = build_suffix_array(text)
        text = np.concatenate([codes, np.asarray([SENTINEL], np.uint8)])
        bwt = text[(sa + len(text) - 1) % len(text)]
        hist = np.bincount(text, minlength=6)
        counts = np.concatenate([[0], np.cumsum(hist)[:-1]])
        idx = np.arange(len(sa))
        keep = idx % sample_rate == 0
        sa_sample = np.full(-(-len(sa) // sample_rate), -1, np.int64)
        sa_sample[idx[keep] // sample_rate] = sa[keep]
        fm = FMIndex(bwt.astype(np.uint8), sa_sample, sample_rate,
                     counts.astype(np.int64))
        fm._sa = np.asarray(sa)
        return fm

    def occ(self, c, i):
        """# of occurrences of code c in bwt[:i] (vectorized over i)."""
        return self._occ[int(c)][i]

    def backward_search(self, pattern: np.ndarray) -> Tuple[int, int]:
        """SA interval [lo, hi) of suffixes prefixed by pattern."""
        lo, hi = 0, len(self.bwt)
        for c in np.asarray(pattern)[::-1]:
            c = int(c)
            lo = self.counts[c] + self.occ(c, lo)
            hi = self.counts[c] + self.occ(c, hi)
            if lo >= hi:
                return int(lo), int(lo)
        return int(lo), int(hi)

    def backward_search_batch(self, patterns: np.ndarray,
                              valid: np.ndarray = None):
        """Vectorized backward search of fixed-length patterns [N, k]
        -> (lo, hi) int64 [N].  The batched analog of the reference's
        per-suffix BWTSearch loop (BlasrHeaders.h:62)."""
        pat = np.asarray(patterns)
        N, k = pat.shape
        lo = np.zeros(N, np.int64)
        hi = np.full(N, len(self.bwt), np.int64)
        for j in range(k - 1, -1, -1):
            c = pat[:, j]
            for code in range(5):
                m = c == code
                if not m.any():
                    continue
                tab = self._occ[code]
                lo[m] = self.counts[code] + tab[lo[m]]
                hi[m] = self.counts[code] + tab[hi[m]]
        if valid is not None:
            lo, hi = np.where(valid, lo, 0), np.where(valid, hi, 0)
        return lo, np.maximum(hi, lo)

    def locate(self, row: int) -> int:
        """Text position of SA row via LF-walk to a sampled row."""
        steps = 0
        r = int(row)
        while (r % self.sample_rate != 0
               or self.sa_sample[r // self.sample_rate] < 0):
            c = int(self.bwt[r])
            r = int(self.counts[c] + self.occ(c, r))
            steps += 1
        return int((self.sa_sample[r // self.sample_rate] + steps)
                   % len(self.bwt))


def build_bwt(codes: np.ndarray, sa: np.ndarray = None):
    """(bwt, counts) for genome codes + implicit sentinel."""
    fm = FMIndex.from_text(codes, sa)
    return fm.bwt, fm.counts


def invert_bwt(bwt: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Recover the original text (without sentinel) from the BWT — the
    bwt2sa direction (extrautils/BwtToSuffixArray.cpp:33; the SA is then
    rebuilt with SA-IS, which is faster than storing rank vectors)."""
    bwt = np.asarray(bwt)
    n = len(bwt)
    try:
        from blasr_tpu.native import bwt_invert_native
        out = bwt_invert_native(bwt, SENTINEL)
        if out is not None:
            return out
    except Exception:
        pass
    # LF mapping == stable sort position (counts[c] + rank-within-char)
    order = np.argsort(bwt, kind="stable")
    lf = np.empty(n, np.int64)
    lf[order] = np.arange(n)
    out = np.empty(n - 1, np.uint8)
    row = int(np.nonzero(bwt == SENTINEL)[0][0])  # the SA[row] == 0 row
    for i in range(n - 2, -1, -1):
        row = int(lf[row])
        out[i] = bwt[row]
    return out


def save_bwt(path, bwt: np.ndarray, counts: np.ndarray, names, lengths):
    np.savez_compressed(
        path, format_version=FORMAT_VERSION, bwt=bwt, counts=counts,
        names=np.asarray(list(names)), lengths=np.asarray(list(lengths)))


def load_bwt(path):
    z = np.load(path, allow_pickle=False)
    assert int(z["format_version"]) == FORMAT_VERSION
    return (z["bwt"], z["counts"], [str(x) for x in z["names"]],
            [int(x) for x in z["lengths"]])
