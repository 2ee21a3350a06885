"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its CUDA kernel computes (csrc/*.cu), from the
same inputs, with torch tensor ops. The wrappers in kernels/__init__.py call
these only for tensors on the CPU (the tests); chip_smoke.py holds every
kernel against its plain version on the card. Layouts are the JAX package's:
[C, ch, K] masks, [C, ch, S, O] log-likelihoods, and per-(chunk, cluster,
chain) "pairs" flattened row-major from [B, C, ch].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import MISSING, PLOIDY_DIPLOID, PLOIDY_HAPLOID, PLOIDY_NULL
from ..model.buckets import unpack_member_bits
from ..model.draws import own_multiplicity, pair_keys, sample_outcomes
from ..ops import prng, sampling
from ..ops.sampling import NEG_INF, sample_frequencies


def slot_bits(key, k, salt):
    """[..., k] int64: word 0 of threefry(key, (i, salt)) >> 8 for slot i
    (gibbs.py:120-137), the 24 bits of slot i's uniform."""
    i = torch.arange(k, dtype=torch.int64, device=key.device)
    y0, _ = prng.threefry_2x32(key[..., 0, None], key[..., 1, None], i,
                               torch.full_like(i, salt))
    return y0 >> 8


def slot_uniform(key, k, salt):
    """[..., k] uniforms where element i depends only on (key, i, salt)
    (gibbs.py:120-137): slot_bits * 2^-24."""
    return slot_bits(key, k, salt).to(torch.float32) * (2.0 ** -24)


def subsample_masks(base_keys, fold, cluster_id, kmer_valid, rate, salt):
    """Bernoulli(rate) k-mer subsets [C, ch, K] (gibbs.py:140-168)."""
    keys = pair_keys(base_keys, fold, cluster_id)          # [C, ch, 2]
    u = slot_uniform(keys, kmer_valid.shape[1], salt)
    return (u < rate) & kmer_valid[:, None, :]


def _dip_mult(mult, oa, ob):
    """[C, K, O] diplotype multiplicity; haplotype index H is the zero sentinel."""
    c, k, _ = mult.shape
    me = torch.cat([mult.to(torch.int32),
                    torch.zeros((c, k, 1), dtype=torch.int32,
                                device=mult.device)], dim=2)
    return me[:, :, oa] + me[:, :, ob]


def ll_noise_terms(mult, inter, counts, w, tables, mmax, oa, ob,
                   include_noise_row=True, noise_terms=False,
                   max_temp_bytes=1 << 29):
    """LL[c,ch,s,o] = sum_k w * T_s[min(dip + inter, mmax), count] with the
    null column zeroed (gibbs.py:254-464); with noise_terms also A, B, C0
    = sums of (count, 1, lgamma(count + 1)) over subsampled k-mers of total
    multiplicity 0 (gibbs.py:467-515). Clusters and samples are processed
    in tiles that keep the [c, K, s, O] gather under max_temp_bytes. The
    sums over k run in float64 and are stored as float32, as the kernel's
    do: a K32768 class sums thousands of terms per entry, past float32's
    1e-5."""
    c, k, _ = mult.shape
    s = counts.shape[2]
    o = oa.shape[0]
    ch = w.shape[1]
    m_rows = tables.shape[1]
    dev = mult.device
    ll = torch.empty((c, ch, s, o), dtype=torch.float32, device=dev)
    if noise_terms:
        a_t, b_t, c0_t = (torch.empty_like(ll) for _ in range(3))
    s_tile = min(s, max(1, max_temp_bytes // max(k * o * 8, 1)))
    tile = max(1, max_temp_bytes // max(k * s_tile * o * 8, 1))
    s_off = (torch.arange(s, device=dev) * (m_rows * 256))[None, None, :, None]
    flat_t = tables.reshape(-1).to(torch.float64)
    for c0 in range(0, c, tile):
        sl = slice(c0, min(c, c0 + tile))
        dip = _dip_mult(mult[sl], oa, ob)                      # [c, K, O]
        wf = w[sl].to(torch.float64)                            # [c, ch, K]
        for s0 in range(0, s, s_tile):
            ss = slice(s0, min(s, s0 + s_tile))
            inter_i = inter[sl, :, ss].to(torch.int32)          # [c, K, s]
            cnt = counts[sl, :, ss].to(torch.int64)
            row = torch.clamp_max(dip[:, :, None, :] + inter_i[:, :, :, None],
                                  mmax)                         # [c,K,s,O]
            q = flat_t[s_off[:, :, ss] + row * 256 + cnt[:, :, :, None]]
            zero = (dip[:, :, None, :] == 0) & (inter_i[:, :, :, None] == 0)
            del row
            if not include_noise_row:
                q = torch.where(zero, torch.zeros_like(q), q)
            ll[sl, :, ss] = torch.einsum("cxk,ckso->cxso", wf, q)
            if noise_terms:
                del q
                cf = cnt.to(torch.float32)
                for out, val in ((a_t, cf), (b_t, torch.ones_like(cf)),
                                 (c0_t, torch.lgamma(cf + 1.0))):
                    v = torch.where(zero, val.to(torch.float64)[:, :, :, None],
                                    torch.zeros((), dtype=torch.float64,
                                                device=dev))
                    out[sl, :, ss] = torch.einsum("cxk,ckso->cxso", wf, v)
    ll[..., -1] = 0.0
    if noise_terms:
        return ll, (a_t, b_t, c0_t)
    return ll, None


def select_outcome(vals, o_sel):
    """vals[..., O] at o_sel[...]."""
    return torch.gather(vals, -1, o_sel.to(torch.int64)[..., None])[..., 0]


def gibbs_step(key, freqs, ll, ploidy, hap_valid, sparsity, use_sparse, osp):
    """One Gibbs iteration for a flat batch of (cluster, chain) pairs
    (gibbs.py:606-645): key [N, 2], freqs [N, H], ll [N, S, O],
    ploidy [N, S], hap_valid [N, H], sparsity/use_sparse [N].
    Returns (freqs [N, H], o_sel [N, S] int32)."""
    oa, ob, het_bonus, ploidy_mask = osp
    h = freqs.shape[-1]
    ks = prng.split(key, 2)
    k_cat, k_freq = ks[:, 0], ks[:, 1]

    logf = torch.where(freqs > 0, torch.log(torch.clamp_min(freqs, 1e-30)),
                       torch.full_like(freqs, NEG_INF))
    logf_ext = torch.cat([logf, torch.zeros_like(logf[:, :1])], dim=1)
    prior = logf_ext[:, oa] + logf_ext[:, ob] + het_bonus      # [N, O]
    valid = ploidy_mask[ploidy.to(torch.int64)]                # [N, S, O]
    logits = torch.where(valid, prior[:, None, :] + ll,
                         torch.full_like(ll, NEG_INF))
    o_sel = sample_outcomes(k_cat, logits)

    hr = torch.arange(h, device=freqs.device)
    sel = o_sel.to(torch.int64)
    hap_counts = (
        (oa[sel][..., None] == hr).to(torch.int32).sum(dim=1)
        + (ob[sel][..., None] == hr).to(torch.int32).sum(dim=1)
    )                                                          # [N, H]
    n_total = hap_counts.sum(dim=-1, keepdim=True)
    new_freqs = sample_frequencies(k_freq, hap_counts, hap_valid, sparsity,
                                   use_sparse)
    return torch.where(n_total > 0, new_freqs, freqs), o_sel


def gibbs_sweep(ll, ploidy, hap_valid, sparsity, use_sparse, keys, freqs,
                t0, t1, burn_in, osp, tally=None):
    """Iterations t0..t1-1 of the frozen-noise Gibbs scan for a flat batch
    of pairs (the scan body of genotype_stacked, gibbs.py:1880-1935).
    keys [N, 2] are the pairs' chain keys; each iteration draws with
    fold_in(key, t). Adds one to tally[n, s, o_sel] for t >= burn_in.
    Returns (freqs, tally, o_sel of the last iteration)."""
    o_sel = None
    for t in range(t0, t1):
        freqs, o_sel = gibbs_step(prng.fold_in(keys, t), freqs, ll, ploidy,
                                  hap_valid, sparsity, use_sparse, osp)
        if tally is not None and t >= burn_in:
            tally.scatter_add_(-1, o_sel.to(torch.int64)[..., None],
                               torch.ones_like(tally[..., :1]))
    return freqs, tally, o_sel


def noise_ll(llg, a, b, log_r, rates):
    """Noise-chain log-likelihood llg + a*log(r) - b*r with the null outcome
    zeroed (gibbs.py:1995-2017). llg/a/b [N, S, O]; log_r/rates [N, S], the
    pair's chain's values."""
    part = a * log_r[..., None] - b * rates[..., None]
    part[..., -1] = 0.0
    return llg + part


def noise_step(llg, a, b, cv, log_r, rates, ploidy, hap_valid, sparsity,
               use_sparse, keys, freqs, t, osp, count_sum, num_obs):
    """One noise-chain iteration for a flat batch of pairs (gibbs.py:
    2099-2121): the Gibbs step at the chains' current rates, then a and b
    at the drawn outcome, summed as int32 over the valid clusters into
    count_sum/num_obs [ch, S]. Per-pair arrays are [N, ...] with N = B*C*ch
    in row-major (chunk, cluster, chain) order; cv [N] is 1.0 where the
    pair's cluster contributes; log_r/rates are [ch, S]."""
    ch, s = rates.shape
    reps = llg.shape[0] // ch
    ll = noise_ll(llg, a, b, log_r.repeat(reps, 1), rates.repeat(reps, 1))
    freqs, o_sel = gibbs_step(prng.fold_in(keys, t), freqs, ll, ploidy,
                              hap_valid, sparsity, use_sparse, osp)
    a_sel = select_outcome(a, o_sel)                           # [N, S]
    b_sel = select_outcome(b, o_sel)
    count_sum += (a_sel * cv[:, None]).to(torch.int32).reshape(-1, ch, s).sum(0)
    num_obs += (b_sel * cv[:, None]).to(torch.int32).reshape(-1, ch, s).sum(0)
    return freqs, o_sel


def joint_step(llg, a, b, cv, log_r, rates, ploidy, hap_valid, sparsity,
               use_sparse, keys, freqs, t, osp, count_sum, num_obs, tally,
               burn_in):
    """One joint noise + genotype iteration (gibbs.py:2184-2216): noise_step
    with cv the clusters' validity, then tally [N, S, O] int32 += one at
    the drawn outcomes for t >= burn_in."""
    freqs, o_sel = noise_step(llg, a, b, cv, log_r, rates, ploidy, hap_valid,
                              sparsity, use_sparse, keys, freqs, t, osp,
                              count_sum, num_obs)
    if t >= burn_in:
        tally.scatter_add_(-1, o_sel.to(torch.int64)[..., None],
                           torch.ones_like(tally[..., :1]))
    return freqs, o_sel


def noise_rates(k_noise, count_sum, num_obs, rates, log_r, trace, t,
                prior_shape, prior_scale):
    """The conjugate gamma rate update of iteration t (gibbs.py:2127-2135,
    :2222-2230), in place: rates [ch, S] = fixed_round_gamma(fold_in(
    k_noise[x], t), prior_shape + count_sum) * prior_scale / (num_obs *
    prior_scale + 1); log_r = log(max(rates, 1e-30)); trace[:, t] = rates;
    count_sum and num_obs zeroed for the next iteration. The reference for
    noise_rate_draws and noise_rate_update together."""
    _rate_update(sampling.fixed_round_gamma(prng.fold_in(k_noise, t),
                                            prior_shape + count_sum),
                 count_sum, num_obs, rates, log_r, trace, t, prior_scale)


def _rate_update(gamma, count_sum, num_obs, rates, log_r, trace, t,
                 prior_scale):
    """rates = gamma * the posterior scale, their logs and trace column;
    the statistics zeroed."""
    scale = prior_scale / (num_obs * prior_scale + 1.0)
    rates.copy_(gamma * scale)
    log_r.copy_(torch.log(torch.clamp_min(rates, 1e-30)))
    trace[:, t] = rates
    count_sum.zero_()
    num_obs.zero_()


def noise_rate_draws(k_noise, t0, n, s):
    """What noise_rates draws from its keys alone, for iterations t0 ..
    t0 + n - 1 of chains k_noise [ch, 2] and s samples: keys [n, ch, 3, 2]
    (fixed_round_gamma's split of fold_in(k_noise[x], t): k_boost, k_norm,
    k_unif) and draws [n, 3, ch, s] (each element's first-round normal and
    uniform and its boost uniform)."""
    t = torch.arange(t0, t0 + n, dtype=torch.int64, device=k_noise.device)
    keys = prng.split(prng.fold_in(k_noise[None], t[:, None]), 3)
    k_boost, k_norm, k_unif = keys.unbind(-2)
    draws = torch.stack([prng.normal(k_norm, (s,)),
                         prng.uniform(k_unif, (s,), minval=1e-12),
                         prng.uniform(k_boost, (s,), minval=1e-12)], dim=1)
    return keys, draws


def noise_rate_update(keys, draws, count_sum, num_obs, rates, log_r, trace,
                      t, prior_shape, prior_scale):
    """noise_rates of iteration t from its slice of noise_rate_draws (keys
    [ch, 3, 2], draws [3, ch, S]): the gamma's first round and boost read,
    its later rounds drawn from the keys."""
    _rate_update(sampling.fixed_round_gamma_split(
        keys, prior_shape + count_sum, first=draws.unbind(0)),
        count_sum, num_obs, rates, log_r, trace, t, prior_scale)


def gamma_draw(keys, alpha):
    """jax.random.gamma per row (random.py _gamma_impl): keys [N, 2],
    alpha [N, E]; element e of row n draws with split(keys[n], E)[e] through
    prng._gamma_one_batch, whose masked rejection loops run until every
    element has accepted."""
    n, e = alpha.shape
    elem_keys = prng.split(keys, e).reshape(-1, 2)
    return prng._gamma_one_batch(
        elem_keys, alpha.reshape(-1).to(torch.float32)).reshape(n, e)


def unpack_bucket(flat_counts, flat_inter_fm, flat_mult, flat_member, lens,
                  gcol, k):
    """Dense padded [C, K, *] bucket tensors from the ragged per-k-mer rows
    (engine.py:1439-1474), bit-exact against the host dense build: padding
    slots read an appended zero row; the intercluster multiplicity is
    resolved per sample gender from its (female, male) columns. Returns
    (counts, inter, mult, member, kmer_valid)."""
    offs = torch.cumsum(lens, 0) - lens
    j = torch.arange(k, device=lens.device)
    valid = j[None, :] < lens[:, None]
    src = torch.where(valid, offs[:, None] + j[None, :], flat_counts.shape[0])

    def ex(flat):
        zero = torch.zeros((1,) + flat.shape[1:], dtype=flat.dtype,
                           device=flat.device)
        return torch.cat([flat, zero])[src]

    fm = ex(flat_inter_fm)                                  # [C, K, 2]
    return (ex(flat_counts), fm[:, :, gcol], ex(flat_mult), ex(flat_member),
            valid)


# memberships (cluster, chain, slot, variant, haplotype) per block of
# clusters in kmer_cap's plain version
CAP_BLOCK = 1 << 26


def kmer_cap(base_keys, fold, cluster_id, w, member_packed, num_haplotypes,
             cap, salt):
    """Exact per-chain shuffled-order k-mer cap per (haplotype, variant)
    (gibbs.py:171-231). Chain x of cluster c visits its k-mers in the order
    of a stable argsort of slot_uniform(fold_in(fold_in(base[x], cid[c]),
    fold[x]), K, salt); the JAX scan keeps a kept k-mer iff one of its
    memberships is still under the cap and counts exactly those, so the
    counter of column e after t steps is min(cap, the kept k-mers of
    membership e among the first t visited). Here without the scan: the
    kept slots sorted by (slot_bits << 32 | slot), an exclusive cumulative
    count per column over that order, and a kept k-mer survives iff one of
    its memberships has fewer than cap before it. Clusters in blocks of at
    most CAP_BLOCK memberships."""
    c, num_chains, k = w.shape
    dev = w.device
    keys = pair_keys(base_keys.to(dev), fold.to(dev), cluster_id)
    v = member_packed.shape[2]
    slot = torch.arange(k, dtype=torch.int64, device=dev)
    step = max(1, CAP_BLOCK // max(1, num_chains * k * v * num_haplotypes))
    out = torch.zeros_like(w)
    for c0 in range(0, c, step):
        wb = w[c0:c0 + step]
        # kept slots first, in visit order; the others after them
        order = torch.argsort(torch.where(
            wb, slot_bits(keys[c0:c0 + step], k, salt) << 32 | slot,
            (1 << 56) | slot), dim=-1)
        cidx = torch.arange(wb.shape[0], device=dev)[:, None, None]
        mem = unpack_member_bits(member_packed[c0:c0 + step][cidx, order],
                                 num_haplotypes)
        mem &= torch.gather(wb, 2, order)[..., None, None]
        before = torch.cumsum(mem, dim=2, dtype=torch.int32) - mem.to(
            torch.int32)
        keep = (mem & (before < cap)).any(dim=(3, 4))
        out[c0:c0 + step] = out[c0:c0 + step].scatter(2, order, keep)
    return out


# float tolerance semantics of Utils::floatCompare / floatLess (Utils.hpp:81-103)
FLOAT_EPS100 = float(np.float32(np.finfo(np.float32).eps * 100))


def float_compare(a, b):
    m = torch.abs(torch.minimum(a, b))
    return (a == b) | (torch.abs(a - b) < m * FLOAT_EPS100)


def float_less(a, b):
    return (a < b) & ~float_compare(a, b)


@functools.lru_cache(maxsize=None)
def triangular_decode(max_alleles: int):
    """Decode tables for the triangular genotype index g = hi*(hi+1)/2 + lo."""
    g = max_alleles * (max_alleles + 1) // 2
    lo = np.zeros(g, dtype=np.int64)
    hi = np.zeros(g, dtype=np.int64)
    idx = 0
    for b in range(max_alleles):
        for a in range(b + 1):
            lo[idx] = a
            hi[idx] = b
            idx += 1
    return lo, hi


def _scatter_sum(vals, index, size):
    """out[..., j] = sum of vals[..., o] over o with index[..., o] == j;
    indices outside [0, size) (the -1 allele of padded variants) drop out,
    as in the JAX package's one-hot contractions."""
    inside = (index >= 0) & (index < size)
    out = torch.zeros(vals.shape[:-1] + (size,), dtype=vals.dtype,
                      device=vals.device)
    return out.scatter_add_(-1, torch.where(inside, index, 0),
                            torch.where(inside, vals, 0))


def bucket_stats(mult, inter, counts, member, hap_allele, num_alleles, ploidy,
                 tally, w, oa, ob, a_cap, t_top, min_gpp, min_nak, fak_thresh,
                 packed, missing=None, mac_extra=None):
    """One chunk's posterior statistics (stats.py:235-677). Genotype and
    allele tallies are exact integer scatter-adds, GT follows from integer
    tie counting, and NAK/FAK/MAC are float32 contractions; MAC sums over
    the t_top outcomes of highest total tally (ties to the lower index, as
    lax.top_k). missing = (nak_m, fak_m, mac_m) [C, S] replaces the stats
    of a nested child's `*` allele where its own are empty; mac_extra
    [C, S, V, A] adds to the MAC numerator.

    packed: (gt_tally, al_tally [C,S,V,*] int32, denom [C,S] int32, gt
    [C,S,V,2] int8, saf uint8, nak/fak/mac float16); else (gpp, app, gq,
    gt int32, saf uint8, nak, fak, mac) in float32."""
    c, k, h = mult.shape
    s = counts.shape[2]
    o = oa.shape[0]
    v_cap = hap_allele.shape[2]
    g_cap = a_cap * (a_cap + 1) // 2
    dev = tally.device
    oa, ob = oa.to(torch.int64), ob.to(torch.int64)
    glo_np, ghi_np = triangular_decode(a_cap)
    glo = torch.as_tensor(glo_np, device=dev)
    ghi = torch.as_tensor(ghi_np, device=dev)
    f32 = torch.float32

    ploidy = ploidy.to(torch.int64)
    is_dip = ploidy == PLOIDY_DIPLOID                       # [C, S]
    is_hap = ploidy == PLOIDY_HAPLOID
    valid_s = ploidy != PLOIDY_NULL
    b_ok = (is_dip & valid_s).to(f32)[:, :, None]

    tall = tally.sum(dim=1).to(torch.int64)                 # [C, S, O]
    tally_f = tally.to(f32)                                 # [C, ch, S, O]
    denom = tall.sum(dim=2)                                 # [C, S]
    denom_f = torch.clamp_min(denom.to(f32), 1.0)

    sentinel = num_alleles.to(torch.int64) - 1              # [C, V]
    hap_allele_ext = torch.cat(
        [hap_allele.to(torch.int64), sentinel[:, None, :]], dim=1
    )                                                       # [C, H+1, V]

    wf = w.to(f32)                                          # [C, ch, K]
    counts_pos_t = (counts > 0).to(f32).permute(0, 2, 1)    # [C, S, K]

    # top-T outcomes by total tally; ties to the lower index (lax.top_k)
    sel_o = torch.sort(tall, dim=-1, descending=True,
                       stable=True).indices[..., :t_top]    # [C, S, T]
    sel_a_h = oa[sel_o]
    sel_b_h = ob[sel_o]
    me = torch.cat([mult.to(torch.int64),
                    torch.zeros((c, k, 1), dtype=torch.int64, device=dev)], 2)

    def at_hap(x, idx):
        """x [C, K, H+1] at per-(s, t) haplotypes idx [C, S, T] -> [C, K, S, T]."""
        xe = x[:, :, None, :].expand(c, k, s, x.shape[-1])
        return torch.gather(xe, 3, idx[:, None, :, :].expand(c, k, s, t_top))

    dip_sel = at_hap(me, sel_a_h) + at_hap(me, sel_b_h)
    mult_tot_sel = dip_sel + inter.to(torch.int64)[..., None]
    val_sel = counts.to(f32)[..., None] / torch.clamp_min(
        mult_tot_sel.to(f32), 1.0)                          # [C, K, S, T]
    del dip_sel, mult_tot_sel

    member_all = unpack_member_bits(member, h)              # [C, K, V, H]
    fak_thresh = fak_thresh.to(dev, f32)[None, :, None]
    t_sel = torch.gather(
        tally_f, 3, sel_o[:, None].expand(c, tally.shape[1], s, t_top))
    ar_a = torch.arange(a_cap, device=dev)

    outs = []
    for v in range(v_cap):
        al_ext = hap_allele_ext[:, :, v]                    # [C, H+1]
        al_a = al_ext[:, oa]                                # [C, O]
        al_b = al_ext[:, ob]
        lo = torch.minimum(al_a, al_b)
        hi = torch.maximum(al_a, al_b)
        g_pair = (hi * (hi + 1)) // 2 + lo

        # ---- exact genotype / allele tallies ----
        ex = lambda idx: idx[:, None, :].expand(c, s, o)   # noqa: E731
        gt_dip = _scatter_sum(tall, ex(g_pair), g_cap)
        gt_hap = _scatter_sum(tall, ex(al_a), g_cap)
        gt_int = torch.where(is_dip[..., None], gt_dip, gt_hap) \
            * valid_s[..., None]                            # [C, S, G]
        al_dip = _scatter_sum(tall, ex(al_a), a_cap) + _scatter_sum(
            tall * (al_a != al_b)[:, None, :], ex(al_b), a_cap)
        al_hap = _scatter_sum(tall, ex(al_a), a_cap)
        al_tally = torch.where(is_dip[..., None], al_dip, al_hap) \
            * valid_s[..., None]                            # [C, S, A]

        max_tally = gt_int.max(dim=2).values
        n_max = (gt_int == max_tally[..., None]).sum(dim=2)
        arg_g = torch.argmax(gt_int, dim=2)
        max_gpp = max_tally.to(f32) / denom_f

        # ---- k-mer evidence (NAK/FAK) ----
        memb_f = member_all[:, :, v, :].to(f32)             # [C, K, H]
        n_hv = torch.einsum("cxk,ckh->cxh", wf, memb_f)
        fr_sum = torch.einsum("cxk,csk,ckh->cxsh", wf, counts_pos_t, memb_f)
        n_ext = torch.cat([n_hv, torch.zeros_like(n_hv[..., :1])], dim=2)
        fr_ext = torch.cat([fr_sum, torch.zeros_like(fr_sum[..., :1])], dim=3)
        n_at_a, n_at_b = n_ext[:, :, oa], n_ext[:, :, ob]   # [C, ch, O]
        fr_frac_a = fr_ext[..., oa] / torch.clamp_min(n_at_a, 1.0)[:, :, None]
        fr_frac_b = fr_ext[..., ob] / torch.clamp_min(n_at_b, 1.0)[:, :, None]
        n_pos_a = (n_at_a > 0).to(f32)[:, :, None]
        n_pos_b = (n_at_b > 0).to(f32)[:, :, None]
        ma_oh = (al_a[..., None] == ar_a).to(f32)           # [C, O, A]
        mb_oh = (al_b[..., None] == ar_a).to(f32)

        def contract(wa, wb):
            return (
                torch.einsum("cxso,coa->csa", wa, ma_oh) * valid_s.to(f32)[..., None]
                + torch.einsum("cxso,coa->csa", wb, mb_oh) * b_ok
            )

        calls = contract(tally_f, tally_f)
        nak_num = contract(tally_f * n_at_a[:, :, None], tally_f * n_at_b[:, :, None])
        fak_den = contract(tally_f * n_pos_a, tally_f * n_pos_b)
        fak_num = contract(tally_f * n_pos_a * fr_frac_a,
                           tally_f * n_pos_b * fr_frac_b)
        nak = nak_num / torch.clamp_min(calls, 1.0)
        fak = torch.where(fak_den > 0, fak_num / torch.clamp_min(fak_den, 1.0),
                          torch.full_like(fak_num, -1.0))
        if missing is not None:
            nak_m, fak_m, mac_m = missing                   # each [C, S]
            is_missing = ar_a[None, None, :] == sentinel[:, v, None, None]
            sub = is_missing & float_compare(nak, torch.zeros_like(nak))
            nak = torch.where(sub, nak_m[:, :, None], nak)
            fak = torch.where(sub, fak_m[:, :, None], fak)

        # ---- MAC over the top-T outcomes ----
        memb_ext = torch.cat([member_all[:, :, v, :].to(torch.int64),
                              torch.zeros_like(me[..., :1])], dim=2)
        mn_a = torch.einsum("cxk,ckst->cxst", wf,
                            val_sel * at_hap(memb_ext, sel_a_h).to(f32))
        mn_b = torch.einsum("cxk,ckst->cxst", wf,
                            val_sel * at_hap(memb_ext, sel_b_h).to(f32))

        def n_at(idx):
            return torch.gather(
                n_ext[:, :, None, :].expand(c, n_ext.shape[1], s, h + 1), 3,
                idx[:, None].expand(c, n_ext.shape[1], s, t_top))

        n_sel_a, n_sel_b = n_at(sel_a_h), n_at(sel_b_h)     # [C, ch, S, T]
        al_sel_a = torch.gather(al_ext, 1, sel_a_h.reshape(c, -1)).reshape(
            c, s, t_top)
        al_sel_b = torch.gather(al_ext, 1, sel_b_h.reshape(c, -1)).reshape(
            c, s, t_top)
        ia = ((al_sel_a[..., None] == ar_a) & (sel_a_h < h)[..., None]).to(f32)
        ib = ((al_sel_b[..., None] == ar_a) & (sel_b_h < h)[..., None]).to(f32)
        wa = (t_sel * (n_sel_a > 0))[..., None] * ia[:, None]  # [C,ch,S,T,A]
        wb = (t_sel * (n_sel_b > 0))[..., None] * ib[:, None]
        mac_num = (
            wa * (mn_a / torch.clamp_min(n_sel_a, 1.0))[..., None]
            + wb * (mn_b / torch.clamp_min(n_sel_b, 1.0))[..., None]
        ).sum(dim=(1, 3))                                   # [C, S, A]
        mac_den = (wa + wb).sum(dim=(1, 3))
        if mac_extra is not None:
            mac_num = mac_num + mac_extra[:, :, v, :]
        mac = torch.where(mac_den > 0, mac_num / torch.clamp_min(mac_den, 1.0),
                          torch.full_like(mac_num, -1.0))
        if missing is not None:
            mac = torch.where(sub & (mac < 0), mac_m[:, :, None], mac)

        # ---- filters + GT decode ----
        has_post = al_tally > 0
        filt = torch.where(
            has_post & float_less(nak, torch.full_like(nak, min_nak)), 1, 0)
        nak_nonzero = ~float_compare(nak, torch.zeros_like(nak))
        filt = filt + torch.where(
            has_post & nak_nonzero & float_less(fak, fak_thresh.expand_as(fak)),
            2, 0)
        gt_lo = torch.where(is_dip, glo[arg_g],
                            torch.where(is_hap, arg_g, torch.full_like(arg_g, MISSING)))
        gt_hi = torch.where(is_dip, ghi[arg_g], torch.full_like(arg_g, MISSING))
        thresh_ok = ~float_less(max_gpp, torch.full_like(max_gpp, min_gpp))
        filt_lo = torch.gather(
            filt, 2, torch.clamp(gt_lo, 0, a_cap - 1)[..., None])[..., 0]
        filt_hi = torch.where(
            is_dip,
            torch.gather(filt, 2, torch.clamp(gt_hi, 0, a_cap - 1)[..., None])[..., 0],
            torch.zeros_like(filt_lo))
        called = ((n_max == 1) & thresh_ok & (filt_lo == 0) & (filt_hi == 0)
                  & (max_tally > 0) & (is_dip | is_hap))
        gt_lo = torch.where(called, gt_lo, torch.full_like(gt_lo, MISSING))
        gt_hi = torch.where(called & is_dip, gt_hi, torch.full_like(gt_hi, MISSING))
        gt = torch.stack([gt_lo, gt_hi], dim=-1)
        if packed:
            outs.append((gt_int, al_tally, gt, filt, nak, fak, mac))
            continue
        phred = -10.0 * torch.log10(torch.clamp_min(1.0 - max_gpp, 1e-12))
        gq = torch.where(max_tally == denom, torch.full_like(phred, 99.0),
                         torch.where(max_tally == 0, torch.zeros_like(phred),
                                     phred))
        outs.append((gt_int.to(f32) / denom_f[..., None],
                     al_tally.to(f32) / denom_f[..., None], gq, gt, filt, nak,
                     fak, mac))

    stacked = [torch.stack(x, dim=2) for x in zip(*outs)]
    if packed:
        gt_t, al_t, gt, saf, nak, fak, mac = stacked
        return (gt_t.to(torch.int32), al_t.to(torch.int32),
                denom.to(torch.int32), gt.to(torch.int8), saf.to(torch.uint8),
                nak.to(torch.float16), fak.to(torch.float16),
                mac.to(torch.float16))
    gpp, app, gq, gt, saf, nak, fak, mac = stacked
    return (gpp, app, gq, gt.to(torch.int32), saf.to(torch.uint8), nak, fak,
            mac)


def _mac_slot(lv, dval, h_sel):
    """One slot's shared-k-mer MAC correction (gibbs.py:1287-1323) at the
    drawn outcomes' haplotypes h_sel [C, ch, S] -> [C, ch, S, V, A]."""
    mac = lv.mac
    c = h_sel.shape[0]
    h = lv.hap_valid.shape[1]
    a_cap = mac["acc"].shape[-1]
    cidx = torch.arange(c, device=h_sel.device)[:, None, None]
    msel = mac["mem"].permute(0, 3, 1, 2)[cidx, h_sel]      # [C,ch,S,Q,V]
    dmn = torch.einsum("cxsq,cxsqv->cxsv", dval, msel.to(torch.float32))
    n_hv = mac["n_hv"]                                      # [C,ch,V,H+1]
    n_at = torch.gather(
        n_hv.permute(0, 1, 3, 2), 2,
        h_sel[..., None].expand(h_sel.shape + (n_hv.shape[2],)))
    al_at = mac["ha"].to(torch.int64)[cidx, h_sel]          # [C,ch,S,V]
    gate = (n_at > 0).to(torch.float32) \
        * (h_sel < h).to(torch.float32)[..., None]
    contrib = dmn / torch.clamp_min(n_at, 1.0) * gate
    a_oh = al_at[..., None] == torch.arange(a_cap, device=h_sel.device)
    return contrib[..., None] * a_oh.to(torch.float32)


def _parent_links(lv):
    """[(rows of lv, parent level, parent rows)] per parent level."""
    pl = lv.parent_level.to(torch.int64)
    return [(torch.nonzero(pl == p)[:, 0], p,
             lv.parent_row.to(torch.int64)[pl == p])
            for p in sorted(set(pl.tolist()) - {-1})]


def _nested_level_step(levels, lv, active, links, keys, pool, t, burn_in):
    """One iteration of one rank level of the coupled scan (gibbs.py:
    1169-1349): ploidy from the parents' current outcomes, the static LL
    plus the shared k-mers at the pool's current state, the Gibbs step, the
    pool update, the MAC correction and the tally. Rows where active [C]
    is false (in no group) keep their state."""
    c, ch, s, o = lv.ll.shape
    dev = lv.ll.device
    ploidy = lv.ploidy.to(torch.int64)[:, None, :].expand(c, ch, s).clone()
    for rows, pl, prows in links:
        po = levels[pl].ocur[prows].to(torch.int64)         # [n, ch, S]
        ploidy[rows] = torch.gather(lv.retain[rows].to(torch.int64), 1,
                                    po.reshape(len(rows), -1)
                                    ).reshape(-1, ch, s)

    ll = lv.ll
    sh = lv.sh
    o_old = lv.ocur.to(torch.int64)
    if sh is not None:
        slot = sh["slot"].to(torch.int64)                   # [C, Q]
        q = slot.shape[1]
        own_old = own_multiplicity(sh["dip"], o_old)        # [C, ch, S, Q]
        pool_g = pool[slot].permute(0, 2, 3, 1)             # [C, ch, S, Q]
        cnt = sh["counts"].permute(0, 2, 1)[:, None]        # [C, 1, S, Q]
        inter_q = sh["inter"].permute(0, 2, 1)[:, None]
        m_ext = torch.where(cnt > 0, pool_g - own_old, 0)
        m_cand = torch.clamp_max(
            sh["dip"][:, None, None] + inter_q[..., None] + m_ext[..., None],
            sh["mmax"])                                     # [C,ch,S,Q,O]
        tcut = sh["tcut"]                                   # [C, Q, S, M]
        m_rows = tcut.shape[3]
        base = ((torch.arange(c, device=dev)[:, None, None, None] * q
                 + torch.arange(q, device=dev)) * s
                + torch.arange(s, device=dev)[:, None]) * m_rows  # [C,1,S,Q]
        flat = base[..., None] + torch.clamp_min(m_cand, 0)
        vals = torch.where(m_cand >= 0, tcut.reshape(-1)[flat],
                           torch.zeros((), device=dev))
        ll_sh = torch.einsum("cxq,cxsqo->cxso", sh["w"].to(torch.float32),
                             vals)
        ll_sh[..., -1] = 0.0
        ll = ll + ll_sh

    n = c * ch
    rep = lambda x: x.repeat_interleave(ch, dim=0)         # noqa: E731
    freqs, o_sel = gibbs_step(
        prng.fold_in(keys.reshape(n, 2), t), lv.freqs, ll.reshape(n, s, o),
        ploidy.reshape(n, s), rep(lv.hap_valid), rep(lv.sparsity),
        rep(lv.use_sparse), lv.osp.torch)
    lv.freqs.copy_(torch.where(rep(active)[:, None], freqs, lv.freqs))
    o_sel = torch.where(active[:, None, None],
                        o_sel.reshape(c, ch, s).to(torch.int64), o_old)

    if sh is not None:
        own_new = own_multiplicity(sh["dip"], o_sel)
        valid = sh["valid"][:, None, None, :]
        delta = torch.where(valid, own_new - own_old, 0)
        pool.index_add_(0, slot.reshape(-1),
                        delta.permute(0, 3, 1, 2).reshape(c * q, ch, s)
                        .to(pool.dtype))
        if lv.mac is not None and t >= burn_in:
            ext_new = torch.where(
                valid, pool[slot].permute(0, 2, 3, 1) - own_new, 0)
            mult_stat = (own_new + inter_q).to(torch.float32)
            counts_f = cnt.to(torch.float32)
            val_stat = counts_f / torch.clamp_min(mult_stat, 1.0)
            val_dyn = counts_f / torch.clamp_min(
                mult_stat + ext_new.to(torch.float32), 1.0)
            dval = (val_dyn - val_stat) \
                * sh["w"].to(torch.float32)[:, :, None, :]  # [C,ch,S,Q]
            lv.mac["acc"] += (_mac_slot(lv, dval, lv.osp.oa[o_sel])
                              + _mac_slot(lv, dval, lv.osp.ob[o_sel])) \
                * active[:, None, None, None, None]

    lv.ocur.copy_(o_sel)
    if t >= burn_in:
        lv.tally.scatter_add_(-1, o_sel[..., None], active[:, None, None, None]
                              .to(lv.tally.dtype).expand(c, ch, s, 1))


def nested_sweep(levels, pool, groups, t0, t1, burn_in):
    """Iterations t0..t1-1 of the coupled scan over rank levels (the scan of
    gibbs.genotype_nested), level-major: every level's clusters step
    together on the state the lower levels left. Only the rows that groups
    (offsets, members [N, 2] (level, row)) lists are sampled. Updates each
    level's freqs, ocur, tally and MAC accumulator, and the pool, in
    place."""
    ch = levels[0].ocur.shape[1]
    members = groups[1].to(torch.int64)
    actives = []
    for l, lv in enumerate(levels):
        active = torch.zeros(lv.ll.shape[0], dtype=torch.bool)
        active[members[members[:, 0] == l, 1]] = True
        actives.append(active.to(lv.ll.device))
    chains = torch.arange(ch, dtype=torch.int64)
    keys = [
        pair_keys(lv.key.reshape(1, 2).expand(ch, 2).to(lv.ll.device),
                  chains.to(lv.ll.device), lv.cluster_id)
        for lv in levels
    ]
    links = [_parent_links(lv) for lv in levels]
    for t in range(t0, t1):
        for lv, act, li, kl in zip(levels, actives, links, keys):
            _nested_level_step(levels, lv, act, li, kl, pool, t, burn_in)


def lane_lookup(keys, payload, valid, queries):
    """Payload rows [N, P] of the queries in one shard of the sorted lane
    table (sharded_table.py:118-148): the JAX package's vectorised
    lower-bound search of depth + 1 steps, depth = ceil(log2 M), over
    (hi, lo) int64 pairs compared lexicographically; zeros where the row
    found is not the query or is a pad row."""
    m, n = keys.shape[0], queries.shape[0]
    dev = queries.device
    out = torch.zeros((n, payload.shape[1]), dtype=torch.uint8, device=dev)
    if m == 0 or n == 0:
        return out
    depth = max((max(m, 2) - 1).bit_length(), 1)
    qh, ql = queries[:, 0], queries[:, 1]
    lo = torch.zeros(n, dtype=torch.int64, device=dev)
    hi = torch.full((n,), m, dtype=torch.int64, device=dev)
    for _ in range(depth + 1):
        mid = (lo + hi) >> 1
        km = keys[torch.clamp(mid, max=m - 1)]
        go_right = (km[:, 0] < qh) | ((km[:, 0] == qh) & (km[:, 1] < ql))
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    at = torch.clamp(lo, max=m - 1)
    k = keys[at]
    hit = (k[:, 0] == qh) & (k[:, 1] == ql) & valid[at]
    return torch.where(hit[:, None], payload[at], out)


def bloom_query(bits, word, shift):
    """Bloom membership [N] (bloom.py:133-142): gather each hash's word,
    test its bit, AND over the H hashes."""
    got = bits[word.to(torch.int64)]                          # [H, N] int32
    return ((got >> shift.to(torch.int32)) & 1).to(torch.bool).all(dim=0)
