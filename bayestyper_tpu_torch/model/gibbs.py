"""The Gibbs engine of the sequential genotype path, in torch.

Counterpart of the stacked path of bayestyper_tpu/model/gibbs.py: the same
outcome space, PRNG streams and per-(cluster, chain) semantics, with the hot
programs as hand-written kernels (kernels/):

  * subsample masks       -> kernels.subsample_masks
  * the k-mer cap         -> kernels.kmer_cap
  * LL + noise terms      -> kernels.ll_noise_terms
  * the 350-step scan     -> kernels.gibbs_sweep (all iterations, one launch)
  * the noise-chain step  -> kernels.noise_step (one launch per class and
                             iteration)
  * the joint-chain step  -> kernels.joint_step (the same, with the tally)
  * the rate update       -> kernels.noise_rate_update (one noise_rates
                             launch per iteration) from
                             kernels.noise_rate_draws (one per scan)
  * the coupled scan      -> kernels.nested_sweep (all iterations and rank
                             levels, one launch)

The JAX package's single-bucket forms run the same kernels: genotype_bucket
and the *_multi programs are the stacked programs on one-chunk stacks (the
JAX package documents them as bit-identical, gibbs.py:779-780, 2065), and
noise_chain is the noise chains' scan with its own key derivation. Over a
mesh (parallel/mesh.py) the noise and joint chains take one stack per
cluster shard (noise_chains_sharded, joint_chains_sharded): every shard
steps on its device and the rate scan sums the shards' int32 statistics
exactly before each rate update, so any shard count gives one device's
bits. The JAX
package's [B, C, ch, S, O] layout is kept; its flat S*O storage and u16
tally carries were TPU padding workarounds and are not needed here.
Keys are int64 tensors [..., 2] (ops/prng.py). Host-side inputs (keys,
outcome tables) are small and built on the CPU, then moved to the bucket's
device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import kernels
from ..constants import (
    GIBBS_BURN_IN,
    GIBBS_SAMPLES,
    KMER_SUBSAMPLING_RATE,
    NUM_GIBBS_CHAINS,
    PLOIDY_DIPLOID,
    PLOIDY_HAPLOID,
    PLOIDY_NULL,
)
from ..ops import prng
from ..ops.sampling import NEG_INF
from .buckets import ClusterBucket, slice_bucket, unpack_member_bits
from .draws import own_multiplicity, pair_keys, sample_outcomes


@dataclasses.dataclass(frozen=True, eq=False)
class OutcomeSpace:
    """Static outcome enumeration for a bucket's haplotype capacity H.

    oa/ob index into H+1 where index H is the missing-haplotype sentinel.
    Layout: [diploid pairs (i<=j) | haploid singles | null].
    """

    num_haplotypes: int
    oa: np.ndarray        # [O] int32
    ob: np.ndarray        # [O] int32
    het_bonus: np.ndarray  # [O] f32: log(2) on heterozygous pairs
    ploidy_mask: np.ndarray  # [3, O] bool: valid outcomes per ploidy level

    @property
    def num_outcomes(self):
        return self.oa.shape[0]

    @property
    def num_pairs(self):
        h = self.num_haplotypes
        return h * (h + 1) // 2


@functools.lru_cache(maxsize=None)
def make_outcome_space(num_haplotypes: int) -> OutcomeSpace:
    h = num_haplotypes
    ii, jj = np.triu_indices(h)
    oa = np.concatenate([ii, np.arange(h), [h]]).astype(np.int32)
    ob = np.concatenate([jj, np.full(h, h), [h]]).astype(np.int32)
    num_pairs = ii.shape[0]
    o = oa.shape[0]

    het = np.zeros(o, dtype=np.float32)
    het[:num_pairs] = np.where(ii != jj, np.log(2.0), 0.0)

    mask = np.zeros((3, o), dtype=bool)
    mask[PLOIDY_DIPLOID, :num_pairs] = True
    mask[PLOIDY_HAPLOID, num_pairs : num_pairs + h] = True
    mask[PLOIDY_NULL, o - 1] = True
    return OutcomeSpace(h, oa, ob, het, mask)


@dataclasses.dataclass(frozen=True)
class OutcomeTensors:
    """An OutcomeSpace on a device: int64 indices for torch, int32 copies
    for the kernels."""

    oa: torch.Tensor
    ob: torch.Tensor
    het_bonus: torch.Tensor
    ploidy_mask: torch.Tensor
    oa32: torch.Tensor
    ob32: torch.Tensor

    @property
    def torch(self):
        return (self.oa, self.ob, self.het_bonus, self.ploidy_mask)


@functools.lru_cache(maxsize=None)
def outcome_tensors(num_haplotypes: int, device) -> OutcomeTensors:
    osp = make_outcome_space(num_haplotypes)
    dev = torch.device(device)
    oa = torch.as_tensor(osp.oa, device=dev)
    ob = torch.as_tensor(osp.ob, device=dev)
    return OutcomeTensors(
        oa=oa.to(torch.int64), ob=ob.to(torch.int64),
        het_bonus=torch.as_tensor(osp.het_bonus, device=dev),
        ploidy_mask=torch.as_tensor(osp.ploidy_mask, device=dev),
        oa32=oa.contiguous(), ob32=ob.contiguous(),
    )


# Salts separating the per-slot uniform streams (subsample vs cap visit
# order); arbitrary odd constants (the JAX package's).
_SUBSAMPLE_SALT = 0x9E3779B9
_CAP_SALT = 0x85EBCA77


@dataclasses.dataclass(frozen=True)
class GibbsConfig:
    num_chains: int = NUM_GIBBS_CHAINS
    burn_in: int = GIBBS_BURN_IN
    num_samples: int = GIBBS_SAMPLES
    kmer_subsampling_rate: float = KMER_SUBSAMPLING_RATE
    max_total_mult: int = 32
    # exact shuffled-order per-(haplotype, variant) kmer cap; set by the host
    # only when some pool exceeds the cap
    max_haplotype_variant_kmers: int = 500
    apply_cap: bool = False
    # the JAX package's hint that some k-mer has an intercluster
    # multiplicity (it skips a TPU gather without one); the LL kernel reads
    # inter_mult either way, so no result depends on it
    has_inter: bool = True


def _chain_base(key, num_chains):
    """Genotype-mode chain keys: one base key, chain index as the fold."""
    base = key.reshape(1, 2).expand(num_chains, 2).contiguous()
    return base, torch.arange(num_chains, dtype=torch.int64, device=key.device)


def subsample_masks(key, kmer_valid, num_chains, rate=KMER_SUBSAMPLING_RATE,
                    cluster_ids=None):
    """Per-chain Bernoulli k-mer subsets [C, chains, K] bool, keyed per
    (cluster, chain, slot) as gibbs.subsample_masks (gibbs.py:140-168)."""
    c = kmer_valid.shape[0]
    if cluster_ids is None:
        cluster_ids = torch.arange(c, dtype=torch.int64, device=kmer_valid.device)
    base, fold = _chain_base(key.cpu(), num_chains)
    return kernels.subsample_masks(base, fold, cluster_ids, kmer_valid, rate,
                                   _SUBSAMPLE_SALT)


def apply_kmer_cap(base_keys, fold, w, member_packed, num_haplotypes, cap,
                   cluster_ids):
    """Exact per-chain shuffled-order k-mer cap per (haplotype, variant)
    (gibbs.py:171-231) through kernels.kmer_cap: k-mers are visited in the
    order of argsort of a per-slot stable uniform; a kept k-mer survives iff
    one of its memberships is still under the cap. The engine runs it only
    when some pool exceeds the cap."""
    return kernels.kmer_cap(base_keys, fold, cluster_ids, w, member_packed,
                            num_haplotypes, cap, _CAP_SALT)


def _subsample_with_cap(base_keys, fold, bucket, cfg):
    """Subsample masks [C, ch, K]; the key is split only when the cap
    applies, so the no-cap stream is the common one (gibbs.py:666-682)."""
    if not cfg.apply_cap:
        return kernels.subsample_masks(
            base_keys, fold, bucket.cluster_id, bucket.kmer_valid,
            cfg.kmer_subsampling_rate, _SUBSAMPLE_SALT,
        )
    ks = prng.split(base_keys, 2)
    w = kernels.subsample_masks(
        ks[:, 0], fold, bucket.cluster_id, bucket.kmer_valid,
        cfg.kmer_subsampling_rate, _SUBSAMPLE_SALT,
    )
    return apply_kmer_cap(ks[:, 1], fold, w, bucket.member,
                          bucket.num_haplotypes,
                          cfg.max_haplotype_variant_kmers, bucket.cluster_id)


def compute_log_likelihoods(bucket, outcomes: OutcomeSpace, tables, w,
                            max_total_mult: int, include_noise_row=True):
    """LL[C, chains, S, O] with the null column zeroed (gibbs.py:254-464)."""
    osp = outcome_tensors(outcomes.num_haplotypes, bucket.mult.device)
    mmax = min(max_total_mult, tables.shape[1] - 1)
    ll, _ = kernels.ll_noise_terms(
        bucket.mult, bucket.inter_mult, bucket.counts, w, tables, mmax,
        osp.oa32, osp.ob32, include_noise_row=include_noise_row,
    )
    return ll


def compute_noise_terms(bucket, outcomes: OutcomeSpace, tables, w,
                        max_total_mult: int = 32):
    """(A, B, C0) [C, ch, S, O] noise sufficient-statistic constants
    (gibbs.py:467-515), from the same kernel pass as the LL."""
    osp = outcome_tensors(outcomes.num_haplotypes, bucket.mult.device)
    mmax = min(max_total_mult, tables.shape[1] - 1)
    _, abc = kernels.ll_noise_terms(
        bucket.mult, bucket.inter_mult, bucket.counts, w, tables, mmax,
        osp.oa32, osp.ob32, include_noise_row=False, noise_terms=True,
    )
    return abc


def _freqs0(sbucket, num_chains):
    """Per-chain uniform initial frequencies over real haplotypes:
    [..., C, chains, H] for hap_valid [..., C, H]."""
    hv = sbucket.hap_valid
    nh = hv.sum(dim=-1, keepdim=True).to(torch.float32)
    f0 = torch.where(hv, 1.0 / torch.clamp_min(nh, 1.0),
                     torch.zeros_like(nh))
    return f0.unsqueeze(-2).expand(
        hv.shape[:-1] + (num_chains, hv.shape[-1])).contiguous()


def _cluster_fields(sbucket):
    """Per-cluster Gibbs inputs flattened over the chunk axis."""
    s = sbucket.counts.shape[-1]
    h = sbucket.hap_valid.shape[-1]
    return (sbucket.ploidy.reshape(-1, s), sbucket.hap_valid.reshape(-1, h),
            sbucket.sparsity.reshape(-1), sbucket.use_sparse.reshape(-1),
            sbucket.cluster_id.reshape(-1))


def genotype_stacked(base_key, sbucket, tables, outcomes: OutcomeSpace,
                     cfg: GibbsConfig):
    """Frozen-noise genotyping of a [B]-stacked bucket (gibbs.py:1842-1935).

    Returns (tally [B, C, ch, S, O] int32, w [B, C, ch, K] bool)."""
    num_iters = cfg.burn_in + cfg.num_samples
    ch = cfg.num_chains
    b, c = sbucket.mult.shape[:2]
    s = sbucket.counts.shape[3]
    o = outcomes.num_outcomes
    dev = sbucket.mult.device
    osp = outcome_tensors(outcomes.num_haplotypes, dev)

    ks = prng.split(base_key.cpu(), 2)
    sub_base, fold = _chain_base(ks[0], ch)
    chain_base, _ = _chain_base(ks[1], ch)
    ws, lls = [], []
    for bi in range(b):
        bucket_b = slice_bucket(sbucket, bi)
        w = _subsample_with_cap(sub_base, fold, bucket_b, cfg)
        ws.append(w)
        lls.append(compute_log_likelihoods(
            bucket_b, outcomes, tables, w, cfg.max_total_mult,
            include_noise_row=True,
        ))
    w = torch.stack(ws)
    ll = torch.stack(lls).reshape(b * c * ch, s, o)
    del lls
    freqs = _freqs0(sbucket, ch).reshape(b * c * ch, -1)
    tally = torch.zeros((b * c * ch, s, o), dtype=torch.int32, device=dev)
    _, tally, _ = kernels.gibbs_sweep(
        ll, *_cluster_fields(sbucket), chain_base, fold, freqs, 0, num_iters,
        cfg.burn_in, osp, tally,
    )
    return tally.reshape(b, c, ch, s, o), w


def _one_chunk(bucket):
    """A bucket as a [1]-stacked one (views, no copy)."""
    return ClusterBucket(**{f.name: getattr(bucket, f.name)[None]
                            for f in dataclasses.fields(ClusterBucket)})


def genotype_bucket(base_key, bucket, tables, outcomes: OutcomeSpace,
                    cfg: GibbsConfig):
    """Frozen-noise genotyping of one bucket (gibbs.py:700-767):
    genotype_stacked on a one-chunk stack, so the keys are derived as
    there. Returns (tally [C, ch, S, O] int32, w [C, ch, K] bool)."""
    tally, w = genotype_stacked(base_key, _one_chunk(bucket), tables,
                                outcomes, cfg)
    return tally[0], w[0]


def genotype_buckets_multi(base_key, buckets, tables, outcomes_list, cfgs):
    """Frozen-noise genotyping of several buckets (gibbs.py:770-856): each
    bucket is its own genotype_bucket call (one gibbs_sweep launch, as each
    has its own outcome space), so every result is that call's. Returns
    (tallies, ws), tuples matching buckets."""
    num_iters = cfgs[0].burn_in + cfgs[0].num_samples
    if any(cfg.burn_in + cfg.num_samples != num_iters for cfg in cfgs):
        raise ValueError("co-scheduled buckets must share the iteration "
                         "count")
    out = [genotype_bucket(base_key, bucket, tables, outcomes, cfg)
           for bucket, outcomes, cfg in zip(buckets, outcomes_list, cfgs)]
    return tuple(t for t, _ in out), tuple(w for _, w in out)


def _as_device(x, dev, dtype=None):
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=dev, dtype=dtype)


def _shared_tables(bucket, outcomes: OutcomeSpace, tables, w, sh, cfg, dev):
    """The per-level shared-k-mer tables of the coupled scan (gibbs.py:
    1073-1107): counts, intercluster and diplotype multiplicities of the
    shared rows, their subsample masks, and Tcut[c, q, s, m] =
    tables[s, m, counts_sh[c, q, s]]."""
    mmax = min(cfg.max_total_mult, tables.shape[1] - 1)
    sh_idx = _as_device(sh["sh_idx"], dev, torch.int64)            # [C, Q]
    valid = _as_device(sh["sh_valid"], dev, torch.bool)
    c, q = sh_idx.shape
    s = bucket.num_samples
    h = bucket.num_haplotypes
    rows = lambda x, n: torch.gather(                               # noqa: E731
        x, 1, sh_idx[:, :, None].expand(c, q, n)).to(torch.int32)
    counts_sh = rows(bucket.counts, s)                              # [C, Q, S]
    me = torch.cat([rows(bucket.mult, h),
                    torch.zeros((c, q, 1), dtype=torch.int32, device=dev)], 2)
    osp = outcome_tensors(outcomes.num_haplotypes, dev)
    tab = tables[:, : mmax + 1, :].permute(0, 2, 1)                 # [S,256,M]
    return dict(
        slot=_as_device(sh["sh_slot"], dev, torch.int32).contiguous(),
        valid=valid.contiguous(), counts=counts_sh.contiguous(),
        inter=rows(bucket.inter_mult, s).contiguous(),
        dip=(me[:, :, osp.oa] + me[:, :, osp.ob]).contiguous(),     # [C, Q, O]
        w=(torch.gather(w, 2, sh_idx[:, None, :].expand(c, w.shape[1], q))
           & valid[:, None, :]).contiguous(),                       # [C, ch, Q]
        tcut=tab[torch.arange(s, device=dev), counts_sh.to(torch.int64)]
        .to(torch.float32).contiguous(),                            # [C,Q,S,M]
        mmax=mmax,
    )


def _mac_tables(bucket, w, sh, a_cap, num_chains, dev):
    """The MAC sibling-fold tables of a shared level (gibbs.py:1108-1160):
    member bits of the shared rows, per-(chain, variant, haplotype)
    subsampled k-mer counts, the haplotype -> allele map with the sentinel
    row, and the zeroed accumulator."""
    sh_idx = _as_device(sh["sh_idx"], dev, torch.int64)
    c, q = sh_idx.shape
    k, h, v = bucket.num_kmers, bucket.num_haplotypes, bucket.num_variants
    words = bucket.member.shape[3]
    mem_rows = torch.gather(
        bucket.member, 1, sh_idx[:, :, None, None].expand(c, q, v, words))
    ext = lambda x: torch.cat(                                      # noqa: E731
        [x, torch.zeros_like(x[..., :1])], dim=-1)
    member_all = unpack_member_bits(bucket.member, h).reshape(c, k, v * h)
    n_hv = torch.einsum("cxk,ckm->cxm", w.to(torch.float32),
                        member_all.to(torch.float32)).reshape(
                            c, num_chains, v, h)
    sentinel = bucket.num_alleles.to(torch.int32) - 1
    return dict(
        mem=ext(unpack_member_bits(mem_rows, h).to(torch.uint8)).contiguous(),
        n_hv=ext(n_hv).contiguous(),
        ha=torch.cat([bucket.hap_allele.to(torch.int32), sentinel[:, None, :]],
                     dim=1).contiguous(),
        acc=torch.zeros((c, num_chains, bucket.num_samples, v, a_cap),
                        dtype=torch.float32, device=dev),
    )


def _initial_outcomes(base_key, level, bucket, outcomes: OutcomeSpace,
                      num_chains, dev):
    """[C, ch, S] int32 starting outcomes, uniform over each sample's
    chromosome-ploidy-valid outcomes (gibbs.py:1376-1402); padded clusters
    start at the null outcome."""
    c, s = bucket.ploidy.shape
    o = outcomes.num_outcomes
    osp = outcome_tensors(outcomes.num_haplotypes, dev)
    valid = osp.ploidy_mask[bucket.ploidy.to(torch.int64)]           # [C,S,O]
    logits = torch.where(valid, torch.zeros((), device=dev),
                         torch.full((), NEG_INF, device=dev))
    k_init = prng.fold_in(prng.fold_in(base_key, level), 0x696E6974)  # "init"
    keys = pair_keys(
        k_init.reshape(1, 2).expand(num_chains, 2).to(dev),
        torch.arange(num_chains, device=dev), bucket.cluster_id)     # [C,ch,2]
    o_init = sample_outcomes(
        keys.reshape(-1, 2), logits.repeat_interleave(num_chains, dim=0)
    ).reshape(c, num_chains, s)
    return torch.where(bucket.cluster_valid[:, None, None], o_init,
                       torch.full_like(o_init, o - 1)).to(torch.int32)


@dataclasses.dataclass
class NestedSetup:
    """The precomputed coupled scan: its levels, subsample masks, initial
    pool and groups (kernels.nested_sweep's inputs)."""

    levels: list
    ws: list
    pool: torch.Tensor
    groups: tuple
    num_iters: int
    burn_in: int

    def clone(self):
        """A copy whose carried state (freqs, outcomes, tallies, MAC
        accumulators, pool) is fresh, so the scan can run again."""
        levels = []
        for lv in self.levels:
            mac = None if lv.mac is None else dict(lv.mac,
                                                   acc=lv.mac["acc"].clone())
            levels.append(dataclasses.replace(
                lv, freqs=lv.freqs.clone(), ocur=lv.ocur.clone(),
                tally=lv.tally.clone(), mac=mac))
        return dataclasses.replace(self, levels=levels,
                                   pool=self.pool.clone())

    def run(self):
        """The whole scan: (tallies, ws, mac_extras) per level."""
        kernels.nested_sweep(self.levels, self.pool, self.groups, 0,
                             self.num_iters, self.burn_in)
        mac_extras = [lv.mac["acc"].sum(dim=1) if lv.mac is not None
                      else None for lv in self.levels]
        return [lv.tally for lv in self.levels], self.ws, mac_extras


def nested_setup(base_key, buckets, parent_levels, parent_rows,
                 retain_tables, shared_infos, tables, outcomes_list, cfgs,
                 num_pool=0, acaps=None, *, groups) -> NestedSetup:
    """The per-level precompute of genotype_nested, in torch on the
    buckets' device through the existing kernels: subsample + cap, the
    static LL without the shared k-mers, the shared and MAC tables, the
    initial outcomes and the pool (gibbs.py:1051-1431). groups is the
    scan's (offsets, members), as kernels.nested_sweep takes it."""
    cfg0 = cfgs[0]
    ch = cfg0.num_chains
    dev = buckets[0].mult.device
    base_key = base_key.cpu()
    o_pad = max(o.num_outcomes for o in outcomes_list)

    levels, ws = [], []
    pool = torch.zeros((max(num_pool, 1), ch, buckets[0].num_samples),
                       dtype=torch.int32, device=dev)
    for l, (bucket, outcomes, cfg) in enumerate(zip(buckets, outcomes_list,
                                                    cfgs)):
        ks = prng.split(prng.fold_in(base_key, l), 2)
        k_sub, k_chain = ks[0], ks[1]
        sub_base, fold = _chain_base(k_sub, ch)
        w = _subsample_with_cap(sub_base, fold, bucket, cfg)
        ws.append(w)
        sh_info = shared_infos[l]
        w_base = w
        if sh_info is not None:
            # shared k-mers leave the static LL: their multiplicity depends
            # on the siblings' state and is scored per iteration
            w_base = w & ~_as_device(sh_info["sh_mask"], dev,
                                     torch.bool)[:, None, :]
        c, _, h = bucket.mult.shape
        retain = torch.zeros((c, o_pad), dtype=torch.int8)
        rt = _as_device(retain_tables[l], "cpu", torch.int8)
        retain[:, : rt.shape[1]] = rt
        lv = kernels.NestedLevel(
            ll=compute_log_likelihoods(bucket, outcomes, tables, w_base,
                                       cfg.max_total_mult,
                                       include_noise_row=True).contiguous(),
            ploidy=bucket.ploidy.contiguous(),
            parent_level=_as_device(parent_levels[l], dev, torch.int32),
            parent_row=_as_device(parent_rows[l], dev, torch.int32),
            retain=retain.to(dev), hap_valid=bucket.hap_valid.contiguous(),
            sparsity=bucket.sparsity.contiguous(),
            use_sparse=bucket.use_sparse.contiguous(),
            cluster_id=bucket.cluster_id.to(torch.int64).contiguous(),
            key=k_chain, osp=outcome_tensors(outcomes.num_haplotypes, dev),
            freqs=_freqs0(bucket, ch).reshape(c * ch, h).contiguous(),
            ocur=_initial_outcomes(base_key, l, bucket, outcomes, ch, dev),
            tally=torch.zeros((c, ch, bucket.num_samples,
                               outcomes.num_outcomes), dtype=torch.int32,
                              device=dev),
        )
        if sh_info is not None:
            lv.sh = _shared_tables(bucket, outcomes, tables, w, sh_info, cfg,
                                   dev)
            if acaps is not None:
                lv.mac = _mac_tables(bucket, w, sh_info, acaps[l], ch, dev)
            # the pool starts at every cluster's initial contributions
            own0 = own_multiplicity(lv.sh["dip"], lv.ocur.to(torch.int64))
            own0 = torch.where(lv.sh["valid"][:, None, None, :], own0, 0)
            pool.index_add_(0, lv.sh["slot"].to(torch.int64).reshape(-1),
                            own0.permute(0, 3, 1, 2)
                            .reshape(-1, ch, own0.shape[2]).to(torch.int32))
        levels.append(lv)
    return NestedSetup(levels=levels, ws=ws, pool=pool, groups=groups,
                       num_iters=cfg0.burn_in + cfg0.num_samples,
                       burn_in=cfg0.burn_in)


def genotype_nested(base_key, buckets, parent_levels, parent_rows,
                    retain_tables, shared_infos, tables, outcomes_list, cfgs,
                    num_pool=0, acaps=None, *, groups):
    """Frozen-noise genotyping of coupled cluster groups: containment
    families and groups sharing multicluster k-mers (gibbs.py:980-1451;
    see the JAX package for the model). Clusters are laid out in rank
    levels; every iteration runs the levels in order, so each cluster
    samples on the current outcomes of the lower-ranked members of its
    group: its ploidy from its parent's outcome through its retain table,
    and its shared k-mers at own + siblings' current multiplicity.

    The precompute is nested_setup; the 350-iteration scan is one
    kernels.nested_sweep launch. Arguments are the JAX package's (tensors
    or numpy arrays), plus groups = (offsets [G+1], members [N, 2] (level,
    row)) int32: each coupled group's real clusters in level order (the
    engine's rank layout). Rows in no group (padding) are not sampled and
    keep zero tallies. Returns (tallies, ws, mac_extras) per level: tally
    [C, ch, S, O_l] int32, w [C, ch, K_l] bool, mac_extra [C, S, V_l, A_l]
    f32 or None."""
    return nested_setup(base_key, buckets, parent_levels, parent_rows,
                        retain_tables, shared_infos, tables, outcomes_list,
                        cfgs, num_pool, acaps, groups=groups).run()


@dataclasses.dataclass
class NoiseClass:
    """Per-class state of the noise and joint chains (_noise_setup):
    the subsample masks, the rate-independent LL part llg (c0 folded in),
    the noise statistics a and b, the pooling mask, the chains' keys in the
    kernels' form and their frequencies; the joint chains' tally."""

    w: torch.Tensor          # [B, C, ch, K]
    llg: torch.Tensor        # [N, S, O], N = B*C*ch
    a: torch.Tensor          # [N, S, O]
    b: torch.Tensor          # [N, S, O]
    cv: torch.Tensor         # [B*C] f32: clusters that pool their statistics
    fields: tuple            # _cluster_fields of the stacked bucket
    chain_base: torch.Tensor  # [ch, 2]
    fold: torch.Tensor       # [ch]
    freqs: torch.Tensor      # [N, H]
    osp: OutcomeTensors
    tally: torch.Tensor | None = None  # [N, S, O] int32 (joint chains)


def _noise_setup(k_sub, k_chain, sbucket, pool_mask, tables,
                 outcomes: OutcomeSpace, cfg: GibbsConfig):
    """Per-class precompute of the noise and joint chains (gibbs.py:
    1938-1992): chain x subsamples with k_sub[x] and draws its Gibbs keys
    from k_chain[x], each folded with the cluster id and 0 ([ch, 2] each).
    pool_mask [B, C]: the clusters whose statistics pool (the noise phase's
    single-cluster groups; every real cluster in joint mode)."""
    ch = k_sub.shape[0]
    b, c = sbucket.mult.shape[:2]
    s = sbucket.counts.shape[3]
    o = outcomes.num_outcomes
    dev = sbucket.mult.device
    osp = outcome_tensors(outcomes.num_haplotypes, dev)
    mmax = min(cfg.max_total_mult, tables.shape[1] - 1)
    fold = torch.zeros(ch, dtype=torch.int64)
    ws, llgs, aas, bbs = [], [], [], []
    for bi in range(b):
        bucket_b = slice_bucket(sbucket, bi)
        w = _subsample_with_cap(k_sub, fold, bucket_b, cfg)
        llg, (a, b_, c0) = kernels.ll_noise_terms(
            bucket_b.mult, bucket_b.inter_mult, bucket_b.counts, w, tables,
            mmax, osp.oa32, osp.ob32, include_noise_row=False,
            noise_terms=True,
        )
        c0[..., -1] = 0.0
        ws.append(w)
        llgs.append(llg - c0)
        aas.append(a)
        bbs.append(b_)
        del c0
    n = b * c * ch
    return NoiseClass(
        w=torch.stack(ws),
        llg=torch.stack(llgs).reshape(n, s, o),
        a=torch.stack(aas).reshape(n, s, o),
        b=torch.stack(bbs).reshape(n, s, o),
        cv=pool_mask.reshape(-1).to(device=dev, dtype=torch.float32),
        fields=_cluster_fields(sbucket),
        chain_base=kernels.key_words(k_chain.contiguous(), dev),
        fold=kernels.key_words(fold, dev),
        freqs=_freqs0(sbucket, ch).reshape(n, -1),
        osp=osp,
    )


def _chain_keys(base_key, num_chains, chain0):
    """(k_master, k_noise) [ch, 2] of chains chain0.. (gibbs.py:2081-2087):
    fold_in(base_key, chain id), and that folded with "nois"."""
    chain_ids = chain0 + torch.arange(num_chains, dtype=torch.int64)
    k_master = prng.fold_in(base_key.cpu(), chain_ids)
    return k_master, prng.fold_in(k_master, 0x6E6F6973)           # "nois"


def _rate_scan(shards, class_step, k_noise, init_rates, noise_prior,
               num_iters):
    """The iterations shared by the noise and the joint chains.

    shards: per shard, the setups of its classes on its device. Each
    iteration runs class_step on every class of every shard, which adds the
    int32 statistics of its pooling clusters into its shard's
    count_sum/num_obs [ch, S]; the other shards' statistics are then summed
    exactly, in int32, into the first shard's, one noise_rates launch there
    draws the next rates and zeroes them (from the key-only draws of every
    iteration, one noise_rates_draws launch there before the first), and
    the rates are copied to the other shards, whose statistics are zeroed
    too: the psum and the replicated rate draw of the JAX package's mesh
    programs (parallel/mesh.py:63-89), so every shard count gives the bits
    of one.
    On a card an iteration is kernel launches and copies only, each on its
    device's stream. init_rates [ch, S] may lie on any device. Returns the
    trace [ch, iters, S] on the first shard's device."""
    prior_shape, prior_scale = noise_prior
    state = []
    for setups in shards:
        dev = setups[0].llg.device
        rates = _as_device(init_rates, dev, torch.float32).clone()
        count_sum = torch.zeros(rates.shape, dtype=torch.int32, device=dev)
        state.append((rates, torch.log(torch.clamp_min(rates, 1e-30)),
                      count_sum, torch.zeros_like(count_sum)))
    rates0, log_r0, cs0, no0 = state[0]
    trace = torch.empty((rates0.shape[0], num_iters, rates0.shape[1]),
                        dtype=torch.float32, device=rates0.device)
    draws = kernels.noise_rate_draws(
        kernels.key_words(k_noise, rates0.device), trace)
    for t in range(num_iters):
        for setups, (rates, log_r, count_sum, num_obs) in zip(shards, state):
            for su in setups:
                class_step(su, t, log_r, rates, count_sum, num_obs)
        for _, _, count_sum, num_obs in state[1:]:
            cs0.add_(count_sum.to(cs0.device))
            no0.add_(num_obs.to(no0.device))
            count_sum.zero_()
            num_obs.zero_()
        kernels.noise_rate_update(draws, cs0, no0, rates0, log_r0, trace, t,
                                  prior_shape, prior_scale)
        for rates, log_r, _, _ in state[1:]:
            rates.copy_(rates0)
            log_r.copy_(log_r0)
    return trace


def _noise_scan(k_sub, k_chain, k_noise, shards, init_rates, noise_prior,
                outcomes_list, cfgs):
    """The noise chains of keys k_sub, k_chain, k_noise [ch, 2] over the
    stacked classes of every shard, shards = [(sbuckets, pool_masks,
    tables)] each on its device: per iteration kernels.noise_step on every
    class, then the rate update (_rate_scan). Returns (rate_sum [ch, S],
    trace [ch, iters, S])."""
    num_iters = cfgs[0].burn_in + cfgs[0].num_samples
    setups = [
        [_noise_setup(k_sub, k_chain, sb, pm, tables, outcomes, cfg)
         for sb, pm, outcomes, cfg in zip(sbuckets, pool_masks, outcomes_list,
                                          cfgs)]
        for sbuckets, pool_masks, tables in shards
    ]

    def step(su, t, log_r, rates, count_sum, num_obs):
        su.freqs, _ = kernels.noise_step(
            su.llg, su.a, su.b, su.cv, log_r, rates, *su.fields,
            su.chain_base, su.fold, su.freqs, t, su.osp, count_sum, num_obs)

    trace = _rate_scan(setups, step, k_noise, init_rates, noise_prior,
                       num_iters)
    collected = (torch.arange(num_iters, device=trace.device)
                 >= cfgs[0].burn_in).to(torch.float32)
    rate_sum = (trace * collected[None, :, None]).sum(dim=1)
    return rate_sum, trace


def noise_chains_sharded(base_key, shards, init_rates, noise_prior,
                         outcomes_list, cfgs, num_chains, chain0=0):
    """All noise chains over the stacked size classes of every shard of a
    mesh (gibbs.py:2059-2147 on cluster-sharded buckets): shards =
    [(sbuckets, noise_valids, tables)], each shard's classes split on the
    cluster axis and on its device (engine._shard_stacked_for_mesh). Chain
    x is keyed by fold_in(base_key, chain0 + x). Returns (rate_sum
    [ch, S], trace [ch, iters, S]) on the first shard's device."""
    k_master, k_noise = _chain_keys(base_key, num_chains, chain0)
    ks = prng.split(k_master, 2)
    return _noise_scan(ks[:, 0], ks[:, 1], k_noise, shards, init_rates,
                       noise_prior, outcomes_list, cfgs)


def noise_chains_stacked(base_key, sbuckets, noise_valids, tables, init_rates,
                         noise_prior, outcomes_list, cfgs, num_chains,
                         chain0=0):
    """All noise chains over the stacked size classes (gibbs.py:2059-2147),
    chain x keyed by fold_in(base_key, chain0 + x): noise_chains_sharded
    on one shard. Returns (rate_sum [ch, S], trace [ch, iters, S])."""
    return noise_chains_sharded(
        base_key, [(sbuckets, noise_valids, tables)], init_rates, noise_prior,
        outcomes_list, cfgs, num_chains, chain0)


def joint_chains_sharded(base_key, shards, init_rates, noise_prior,
                         outcomes_list, cfgs, num_chains, chain0=0):
    """All joint noise + genotype chains over the stacked size classes of
    every shard of a mesh: shards = [(sbuckets, tables)], each on its
    device. Per iteration kernels.joint_step on every class of every shard,
    then the rate update over the shards' summed statistics (_rate_scan).

    Returns (tallies, ws, trace): per shard, per class, tally
    [B, C_shard, ch, S, O] int32 and w [B, C_shard, ch, K] bool on the
    shard's device, and the rate trace [ch, iters, S]."""
    num_iters = cfgs[0].burn_in + cfgs[0].num_samples
    burn_in = cfgs[0].burn_in
    k_master, k_noise = _chain_keys(base_key, num_chains, chain0)
    ks = prng.split(k_master, 2)
    setups = []
    for sbuckets, tables in shards:
        setups.append([])
        for sb, outcomes, cfg in zip(sbuckets, outcomes_list, cfgs):
            su = _noise_setup(ks[:, 0], ks[:, 1], sb, sb.cluster_valid,
                              tables, outcomes, cfg)
            su.tally = torch.zeros(su.llg.shape, dtype=torch.int32,
                                   device=su.llg.device)
            setups[-1].append(su)

    def step(su, t, log_r, rates, count_sum, num_obs):
        su.freqs, _ = kernels.joint_step(
            su.llg, su.a, su.b, su.cv, log_r, rates, *su.fields,
            su.chain_base, su.fold, su.freqs, t, su.osp, count_sum, num_obs,
            su.tally, burn_in)

    trace = _rate_scan(setups, step, k_noise, init_rates, noise_prior,
                       num_iters)
    tallies = [[su.tally.reshape(su.w.shape[:3] + su.llg.shape[1:])
                for su in shard] for shard in setups]
    return tallies, [[su.w for su in shard] for shard in setups], trace


def joint_chains_stacked(base_key, sbuckets, tables, init_rates, noise_prior,
                         outcomes_list, cfgs, num_chains, chain0=0):
    """All joint noise + genotype chains over the stacked size classes
    (--noise-genotyping; gibbs.py:2150-2260): every real cluster pools its
    noise statistics into its chain's per-iteration rate update, and the
    drawn outcomes are tallied from the burn-in on. joint_chains_sharded
    on one shard.

    Returns (tallies, ws, trace): per class tally [B, C, ch, S, O] int32 and
    w [B, C, ch, K] bool, and the rate trace [ch, iters, S]."""
    tallies, ws, trace = joint_chains_sharded(
        base_key, [(sbuckets, tables)], init_rates, noise_prior,
        outcomes_list, cfgs, num_chains, chain0)
    return tallies[0], ws[0], trace


def _one_device(axis_name):
    """The port runs a mesh from one controller: the cross-shard sum of the
    statistics lives in the mesh programs, not in a named axis."""
    if axis_name is not None:
        raise NotImplementedError(
            f"axis_name={axis_name!r}: no named mesh axis in the port; the "
            "cluster-sharded noise chain is parallel.mesh.noise_chain_sharded"
            " (one controller sums the shards' statistics)")


def noise_chain(base_key, bucket, tables, init_rates, noise_prior,
                outcomes: OutcomeSpace, cfg: GibbsConfig, chain_idx,
                axis_name=None):
    """One noise chain over a bucket of single-cluster groups (gibbs.py:
    859-974): keys (k_sub, k_chain, k_noise) = split(fold_in(base_key,
    chain_idx), 3); the masks of _subsample_with_cap(k_sub) for one chain,
    cluster keys fold_in(fold_in(k_chain, cid), 0), the bucket's real
    clusters pooling, and the rate update fixed_round_gamma(fold_in(
    k_noise, t), .): the noise chains' kernels with one chain. init_rates
    [S]. Returns (rate_sum [S], trace [iters, S])."""
    _one_device(axis_name)
    return _noise_chain(base_key, [(bucket, tables)], init_rates,
                        noise_prior, outcomes, cfg, chain_idx)


def _noise_chain(base_key, shards, init_rates, noise_prior, outcomes, cfg,
                 chain_idx):
    """noise_chain over the cluster shards [(bucket, tables)] of a mesh,
    each on its device (parallel.mesh.noise_chain_sharded)."""
    ks = prng.split(prng.fold_in(base_key.cpu(), chain_idx), 3)   # [3, 2]
    rate_sum, trace = _noise_scan(
        ks[0:1], ks[1:2], ks[2:3],
        [([_one_chunk(b)], [b.cluster_valid[None]], t) for b, t in shards],
        init_rates[None], noise_prior, [outcomes], [cfg])
    return rate_sum[0], trace[0]


def noise_chains_multi(base_key, buckets, tables, init_rates, noise_prior,
                       outcomes_list, cfgs, num_chains, chain0=0,
                       axis_name=None):
    """All noise chains over several buckets (gibbs.py:1454-1609):
    noise_chains_stacked over one-chunk stacks, each bucket's real clusters
    pooling. init_rates [ch, S]. Returns (rate_sum [ch, S], trace
    [ch, iters, S])."""
    _one_device(axis_name)
    return noise_chains_stacked(
        base_key, [_one_chunk(b) for b in buckets],
        [b.cluster_valid[None] for b in buckets], tables, init_rates,
        noise_prior, outcomes_list, cfgs, num_chains, chain0)


def noise_chain_multi(base_key, buckets, tables, init_rates, noise_prior,
                      outcomes_list, cfgs, chain_idx, axis_name=None):
    """Chain chain_idx of noise_chains_multi (gibbs.py:1612-1622):
    init_rates [S] -> (rate_sum [S], trace [iters, S])."""
    rate_sum, trace = noise_chains_multi(
        base_key, buckets, tables, init_rates[None], noise_prior,
        outcomes_list, cfgs, num_chains=1, chain0=chain_idx,
        axis_name=axis_name)
    return rate_sum[0], trace[0]


def joint_chains_multi(base_key, buckets, tables, init_rates, noise_prior,
                       outcomes_list, cfgs, num_chains, chain0=0,
                       axis_name=None):
    """All joint noise + genotype chains over several buckets (gibbs.py:
    1625-1791): joint_chains_stacked over one-chunk stacks. init_rates
    [ch, S]. Returns (tallies, ws, trace): per bucket tally [C, ch, S, O]
    int32 and w [C, ch, K] bool, and the rate trace [ch, iters, S]."""
    _one_device(axis_name)
    tallies, ws, trace = joint_chains_stacked(
        base_key, [_one_chunk(b) for b in buckets], tables, init_rates,
        noise_prior, outcomes_list, cfgs, num_chains, chain0)
    return tuple(t[0] for t in tallies), tuple(w[0] for w in ws), trace


def joint_chain_multi(base_key, buckets, tables, init_rates, noise_prior,
                      outcomes_list, cfgs, chain_idx, axis_name=None):
    """Chain chain_idx of joint_chains_multi (gibbs.py:2263-2277):
    init_rates [S] -> (tallies, ws, trace): per bucket tally [C, S, O]
    int32 and w [C, K] bool, and the rate trace [iters, S]."""
    tallies, ws, trace = joint_chains_multi(
        base_key, buckets, tables, init_rates[None], noise_prior,
        outcomes_list, cfgs, num_chains=1, chain0=chain_idx,
        axis_name=axis_name)
    return (tuple(t[:, 0] for t in tallies), tuple(w[:, 0] for w in ws),
            trace[0])
