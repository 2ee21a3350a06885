"""Samplers of the Gibbs step in torch: fixed-round gamma, log-space
categorical and the spike-and-slab haplotype-frequency resample.

Counterpart of bayestyper_tpu/ops/sampling.py. Every function takes a batch
of keys [..., 2] (ops/prng.py) and arrays whose leading axes are the key's
batch axes, so one call draws for every (chunk, cluster, chain) at once —
the JAX package's vmap written out. The draws consume the same key splits
and counters as the JAX functions.
"""

from __future__ import annotations

import torch

from ..constants import DIRICHLET_PARAMETER
from . import prng

NEG_INF = -1e30  # finite stand-in for -inf so masked logits never produce NaN


def fixed_round_gamma(key, alpha, rounds: int = 6):
    """Gamma(alpha, 1) by Marsaglia-Tsang with a fixed number of rejection
    rounds (sampling.py:35-71). key [..., 2]; alpha [...] + element shape."""
    return fixed_round_gamma_split(prng.split(key, 3), alpha, rounds)


def fixed_round_gamma_split(ks, alpha, rounds: int = 6, first=None):
    """fixed_round_gamma from its key's split ks [..., 3, 2] (k_boost,
    k_norm, k_unif). first = (x0, u0, ub), each [...] + element shape: the
    first round's normal and uniform and the boost uniform drawn ahead from
    those keys (kernels.noise_rate_draws), used in place of drawing them."""
    alpha = alpha.to(torch.float32)
    nb = ks.dim() - 2
    elem = tuple(alpha.shape[nb:])
    k_boost, k_norm, k_unif = ks[..., 0, :], ks[..., 1, :], ks[..., 2, :]

    a_eff = torch.where(alpha < 1.0, alpha + 1.0, alpha)
    d = a_eff - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)

    xs = prng.normal(k_norm, (rounds,) + elem)            # [..., R, *elem]
    us = prng.uniform(k_unif, (rounds,) + elem, minval=1e-12)
    if first is None:
        ub = prng.uniform(k_boost, elem, minval=1e-12)
    else:
        x0, u0, ub = first
        xs = torch.cat([x0.unsqueeze(nb), xs.narrow(nb, 1, rounds - 1)], nb)
        us = torch.cat([u0.unsqueeze(nb), us.narrow(nb, 1, rounds - 1)], nb)
    d_r = d.unsqueeze(nb)
    t = 1.0 + c.unsqueeze(nb) * xs
    v = t * (t * t)
    ok = (v > 0) & (
        torch.log(us) < 0.5 * xs * xs + d_r - d_r * v
        + d_r * torch.log(torch.where(v > 0, v, torch.ones_like(v)))
    )
    any_ok = ok.any(dim=nb)
    is_first = ok & (torch.cumsum(ok.to(torch.int32), dim=nb) == 1)
    dv = d_r * v
    sample = torch.where(is_first, dv, torch.zeros_like(dv)).sum(dim=nb)
    sample = torch.where(any_ok, sample, a_eff)

    boost = torch.pow(ub, 1.0 / torch.clamp_min(alpha, 1e-12))
    return torch.where(alpha < 1.0, sample * boost, sample)


def log_categorical(key, log_probs):
    """Max-shifted inverse-CDF categorical over the last axis (one uniform
    per draw, sampling.py:74-97)."""
    m = log_probs.max(dim=-1, keepdim=True).values
    p = torch.exp(log_probs - m)
    csum = torch.cumsum(p, dim=-1)
    u = prng.uniform(key, (1,)) * csum[..., -1:]
    return (csum <= u).sum(dim=-1, dtype=torch.int32)


def _simplex_size_log_probs(n_plus, n_total, n_valid, max_h, sparsity,
                            alpha=DIRICHLET_PARAMETER):
    """[..., max_h + 1] log-probabilities of the active-set size
    (updateCachedSimplexProbVector, sampling.py:113-138)."""
    t = torch.arange(max_h + 1, dtype=torch.float32, device=n_plus.device)
    np_f = n_plus.to(torch.float32)[..., None]
    nv = n_valid.to(torch.float32)[..., None]
    nt = n_total.to(torch.float32)[..., None]
    sp = sparsity.to(torch.float32)[..., None]
    j = np_f + t

    log_card = (
        torch.lgamma(nv - np_f + 1.0)
        - torch.lgamma(t + 1.0)
        - torch.lgamma(nv - j + 1.0)
    )
    log_prior = j * torch.log(sp) + (nv - j) * torch.log1p(-sp)
    log_assign = torch.lgamma(j * alpha) - torch.lgamma(nt + j * alpha)
    logp = log_card + log_prior + log_assign
    return torch.where(j <= nv, logp, torch.full_like(logp, NEG_INF))


def _expand_rank(key, elig):
    """rank[i] = number of eligible haplotypes with a strictly larger key."""
    g = prng.uniform(key, (elig.shape[-1],))
    g = torch.where(elig, g, torch.full_like(g, -1.0))
    return (g[..., None, :] > g[..., :, None]).sum(dim=-1)


def sample_sparse_frequencies(key, counts, valid_mask, sparsity,
                              alpha=DIRICHLET_PARAMETER):
    """Spike-and-slab simplex resample (sampling.py:141-182)."""
    ones = torch.ones(counts.shape[:-1], dtype=torch.bool, device=counts.device)
    return sample_frequencies(key, counts, valid_mask, sparsity, ones, alpha)


def sample_frequencies(key, counts, valid_mask, sparsity, use_sparse,
                       alpha=DIRICHLET_PARAMETER):
    """Sparse or dense frequency resample sharing one gamma draw
    (sampling.py:185-220). counts/valid_mask [..., H]; sparsity, use_sparse
    [...]."""
    h = counts.shape[-1]
    ks = prng.split(key, 3)
    k_size, k_sel, k_gam = ks[..., 0, :], ks[..., 1, :], ks[..., 2, :]

    counts = torch.where(valid_mask, counts, torch.zeros_like(counts))
    plus_mask = counts > 0
    n_plus = plus_mask.sum(dim=-1)
    n_total = counts.sum(dim=-1)
    n_valid = valid_mask.sum(dim=-1)

    logp = _simplex_size_log_probs(n_plus, n_total, n_valid, h, sparsity, alpha)
    n_expand = log_categorical(k_size, logp)

    elig = valid_mask & ~plus_mask
    rank = _expand_rank(k_sel, elig)
    expand_mask = elig & (rank < n_expand[..., None])

    active = torch.where(use_sparse[..., None], plus_mask | expand_mask,
                         valid_mask)
    a = torch.where(active, counts.to(torch.float32) + alpha,
                    torch.ones(counts.shape, device=counts.device))
    gam = fixed_round_gamma(k_gam, a) * active
    total = gam.sum(dim=-1, keepdim=True)
    return gam / torch.clamp_min(total, 1e-30)
