"""Canonical k-mers in torch, on any device: the benchmark's own counting.

A k <= 55-mer is a pair of int64 lanes, as the KMC tables the benchmark
writes order them:

    hi = value of bases[0:27]   (big-endian 2-bit codes, A=0 C=1 G=2 T=3)
    lo = value of bases[27:k]

so lexicographic order on (hi, lo) is the order of the base strings. The
canonical k-mer is the smaller of the forward and the reverse-complement
pair. Both lanes stay below 2**56, so signed int64 compares them correctly.
Sequences hold only A, C, G and T.

The generator counts every haplotype's k-mers here on the card, and the
reference counts the genome's; `test_portbench_generator.py` holds both
against the host counting of the port's `io.kmc.count_kmers_from_sequences`.
"""

from __future__ import annotations

import numpy as np
import torch

N_HI = 27

_CODE = np.full(256, 255, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i


def encode(seq: bytes, device) -> torch.Tensor:
    """Sequence bytes -> int64 2-bit codes [L] on device."""
    codes = _CODE[np.frombuffer(seq, np.uint8)]
    if codes.size and codes.max() > 3:
        raise ValueError("sequence holds a base other than A, C, G, T")
    return torch.from_numpy(codes).to(device).long()


def _compose(codes, offsets, n):
    """sum_j codes[offsets[j] + i] << 2 (len(offsets) - 1 - j), i < n."""
    out = torch.zeros(n, dtype=torch.int64, device=codes.device)
    for off in offsets:
        out = (out << 2) | codes[off:off + n]
    return out


def lanes(codes: torch.Tensor, k: int):
    """(hi, lo) int64 [L - k + 1]: the canonical lanes of every k-mer."""
    n = codes.shape[0] - k + 1
    if n <= 0:
        z = torch.zeros(0, dtype=torch.int64, device=codes.device)
        return z, z
    n_hi = min(N_HI, k)
    f_hi = _compose(codes, range(n_hi), n)
    f_lo = _compose(codes, range(n_hi, k), n)
    comp = 3 - codes
    # base j of the reverse complement at i is comp[i + k - 1 - j]
    r_hi = _compose(comp, [k - 1 - j for j in range(n_hi)], n)
    r_lo = _compose(comp, [k - 1 - j for j in range(n_hi, k)], n)
    fwd = (f_hi < r_hi) | ((f_hi == r_hi) & (f_lo <= r_lo))
    return torch.where(fwd, f_hi, r_hi), torch.where(fwd, f_lo, r_lo)


def sort_pairs(hi, lo, *rest):
    """The pairs (and tensors riding with them) in (hi, lo) order."""
    order = torch.sort(lo, stable=True).indices
    order = order[torch.sort(hi[order], stable=True).indices]
    return (hi[order], lo[order]) + tuple(t[order] for t in rest)


def count(seqs, k: int, device):
    """Sorted distinct canonical k-mers of the sequences with their
    multiplicities: (hi, lo, mult int64), on device."""
    parts = [lanes(encode(s, device), k) for s in seqs]
    hi = torch.cat([p[0] for p in parts])
    lo = torch.cat([p[1] for p in parts])
    hi, lo = sort_pairs(hi, lo)
    if hi.numel() == 0:
        return hi, lo, hi.clone()
    new = torch.ones_like(hi, dtype=torch.bool)
    new[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    starts = torch.nonzero(new).flatten()
    ends = torch.cat([starts[1:], starts.new_tensor([hi.numel()])])
    return hi[starts], lo[starts], ends - starts


def lookup(table_hi, table_lo, hi, lo):
    """Index of each (hi, lo) in a sorted pair table, -1 where absent."""
    n = table_hi.numel()
    if n == 0 or hi.numel() == 0:
        return torch.full_like(hi, -1)
    left = torch.searchsorted(table_hi, hi, right=False)
    right = torch.searchsorted(table_hi, hi, right=True)
    lft, r = left.clone(), right.clone()
    while True:
        active = lft < r
        if not bool(active.any()):
            break
        mid = (lft + r) >> 1
        go = active & (table_lo[mid.clamp(max=n - 1)] < lo)
        lft = torch.where(go, mid + 1, lft)
        r = torch.where(active & ~go, mid, r)
    cur = lft.clamp(max=n - 1)
    found = (lft < right) & (table_lo[cur] == lo)
    return torch.where(found, lft, torch.full_like(lft, -1))
