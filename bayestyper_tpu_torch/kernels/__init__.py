"""The hand-written Hopper kernels of the genotype path, of the device k-mer
lookups (the lane table and the bloom query) and of the prior gamma draw,
and their wrappers.

Each wrapper takes tensors in the JAX package's layouts. For tensors on the
CPU it runs the kernel's plain PyTorch version (kernels/reference.py); for
CUDA tensors it launches the CUDA C++ kernel (csrc/*.cu) on the current
stream or raises — a failed build or launch never falls back. Every launch
adds one to LAUNCHES[name], so a run can show which kernels it went
through.

Six kernels keep large arrays in shared memory. Their launchers read the
card's opt-in shared memory per block and, for shapes past it, launch a
global-memory variant of the same kernel (the same arithmetic in the same
order): those launches count under LAUNCHES[name + "_global"] (GLOBAL).
The Gibbs kernels (gibbs_sweep, noise_step, joint_step) also take their
global-LL variant where it lets every exp of the step be cached in shared
memory (H64 from 13 to 24 samples).

The kernels are compiled at first use by torch.utils.cpp_extension.load
(ninja runs one compiler per source, in parallel) for sm_90a into BUILD_DIR
(git-ignored), and bound through csrc/bindings.cpp, which checks every
tensor against what its kernel reads. Sources are built with -fmad=false so
float arithmetic rounds as the plain versions' does.
"""

from __future__ import annotations

import dataclasses
import os
import threading

import numpy as np
import torch

from . import reference

KERNELS = ("subsample_masks", "ll_noise_terms", "gibbs_sweep", "noise_step",
           "kmer_cap", "bucket_stats", "nested_sweep", "joint_step",
           "noise_rates", "unpack_bucket", "lane_lookup", "bloom_query",
           "gamma_draw")

# the jitted JAX program each kernel replaces (no Pallas kernel exists)
REPLACES = {
    "subsample_masks": "bayestyper_tpu/model/gibbs.py:140",
    "ll_noise_terms": "bayestyper_tpu/model/gibbs.py:254",
    "gibbs_sweep": "bayestyper_tpu/model/gibbs.py:1843",
    "noise_step": "bayestyper_tpu/model/gibbs.py:2059",
    "kmer_cap": "bayestyper_tpu/model/gibbs.py:171",
    "bucket_stats": "bayestyper_tpu/model/stats.py:235",
    "nested_sweep": "bayestyper_tpu/model/gibbs.py:980",
    "joint_step": "bayestyper_tpu/model/gibbs.py:2184",
    "noise_rates": "bayestyper_tpu/model/gibbs.py:2127",
    "unpack_bucket": "bayestyper_tpu/engine.py:1439",
    "lane_lookup": "bayestyper_tpu/parallel/sharded_table.py:118",
    "bloom_query": "bayestyper_tpu/ops/bloom.py:133",
    "gamma_draw": "bayestyper_tpu/engine.py:1707",
}

# the kernels with a global-memory variant, and its launch-count name
GLOBAL = {name: f"{name}_global" for name in (
    "gibbs_sweep", "noise_step", "joint_step", "kmer_cap", "bucket_stats",
    "nested_sweep")}

LAUNCHES = dict.fromkeys(KERNELS + tuple(GLOBAL.values()), 0)

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.environ.get(
    "BT_TORCH_BUILD_DIR",
    os.path.normpath(os.path.join(CSRC, os.pardir, os.pardir, os.pardir,
                                  ".torch_ext_build")),
)
SOURCES = ("bindings.cpp",) + tuple(f"{name}.cu" for name in KERNELS)
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-fmad=false")

_MODULE = None
# wrappers may be called from a thread pool (the count gathering's): the
# build runs once, and every launch is counted
_LOCK = threading.Lock()


def reset_launch_counts():
    with _LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def build():
    """Compile (unless ninja finds the build up to date) and load the
    kernels' extension; a failed build raises with the compilers' output."""
    global _MODULE
    with _LOCK:
        if _MODULE is None:
            from torch.utils import cpp_extension

            os.makedirs(BUILD_DIR, exist_ok=True)
            _MODULE = cpp_extension.load(
                name="bt_kernels",
                sources=[os.path.join(CSRC, f) for f in SOURCES],
                extra_include_paths=[CSRC], extra_cflags=["-O3"],
                extra_cuda_cflags=list(NVCC_FLAGS), build_directory=BUILD_DIR,
            )
    return _MODULE


def _launch(name, *args):
    out = getattr(build(), name)(*args)
    with _LOCK:
        LAUNCHES[name] += 1
    return out


def _launch_layout(name, *args):
    """_launch for a kernel of GLOBAL: its binding returns (out, layout);
    a launch of the global-memory variant (layout > 0) counts under
    GLOBAL[name]."""
    out, layout = getattr(build(), name)(*args)
    with _LOCK:
        LAUNCHES[GLOBAL[name] if layout else name] += 1
    return out


def _u32(t, device):
    """uint32 values held in int64 -> the same bits as int32 on `device`;
    int32 words (key_words' output) pass through. The conversion runs where
    t lies; host keys then go to a card in one copy from pinned memory that
    does not wait for the stream's earlier work."""
    if t.dtype != torch.int32:
        t = t & 0xFFFFFFFF
        t = torch.where(t >= 2 ** 31, t - 2 ** 32, t).to(torch.int32)
    if t.device.type == "cpu" and torch.device(device).type == "cuda":
        return t.contiguous().pin_memory().to(device, non_blocking=True)
    return t.to(device).contiguous()


def _u64(t, device):
    """Keys as the plain versions read them: uint32 values in int64 on
    `device`, from either form."""
    return t.to(device, torch.int64) & 0xFFFFFFFF


def key_words(keys, device):
    """Keys [..., 2] (or fold words) in the form the kernels read on
    `device`: uint32 bits in int32 on CUDA, unchanged elsewhere. A loop that
    hands the same keys to a launch per iteration converts them once."""
    return _u32(keys, device) if torch.device(device).type == "cuda" else keys


def _per_pair(x, ch):
    return x.repeat_interleave(ch, dim=0)


def subsample_masks(base_keys, fold, cluster_id, kmer_valid, rate, salt):
    """Bernoulli(rate) k-mer subsets [C, ch, K] bool; chain x of cluster c
    draws with fold_in(fold_in(base_keys[x], cluster_id[c]), fold[x])."""
    if not kmer_valid.is_cuda:
        return _plain_subsample_masks(base_keys, fold, cluster_id,
                                      kmer_valid, rate, salt)
    dev = kmer_valid.device
    return _launch("subsample_masks", _u32(base_keys, dev), _u32(fold, dev),
                   cluster_id.to(torch.int64).contiguous(),
                   kmer_valid.contiguous(), float(rate), int(salt))


def pack_bits(mask):
    """Bool masks [..., K] as int32 words [..., ceil(K / 32)]: bit j of word
    i is element 32 i + j (model.buckets.unpack_member_bits inverts it)."""
    k = mask.shape[-1]
    if k % 32:
        mask = torch.cat([mask, mask.new_zeros(mask.shape[:-1] + (-k % 32,))],
                         dim=-1)
    octets = mask.contiguous().view(torch.uint8).reshape(
        mask.shape[:-1] + (-1, 8))
    shifts = torch.arange(8, dtype=torch.uint8, device=mask.device)
    return (octets << shifts).sum(-1, dtype=torch.uint8).view(torch.int32)


def ll_noise_terms(mult, inter, counts, w, tables, mmax, oa, ob,
                   include_noise_row=True, noise_terms=False):
    """LL [C, ch, S, O] f32 (null column zeroed) and, with noise_terms,
    (A, B, C0) [C, ch, S, O]; else None. w [C, ch, K] bool: the subsample
    masks, which the kernel reads packed (pack_bits)."""
    if not mult.is_cuda:
        return reference.ll_noise_terms(mult, inter, counts, w, tables, mmax,
                                        oa, ob, include_noise_row,
                                        noise_terms)
    out = _launch("ll_noise_terms",
                  *(x.contiguous() for x in (mult, inter, counts)),
                  pack_bits(w), tables.to(torch.float32).contiguous(),
                  int(mmax), oa.to(torch.int32).contiguous(),
                  ob.to(torch.int32).contiguous(), bool(include_noise_row),
                  bool(noise_terms))
    return out[0], (tuple(out[1:]) if noise_terms else None)


def _plain_gibbs_sweep(ll, ploidy, hap_valid, sparsity, use_sparse,
                       cluster_id, base_keys, fold, freqs, t0, t1, burn_in,
                       osp, tally=None):
    """gibbs_sweep's plain version, with the wrapper's signature."""
    ch = base_keys.shape[0]
    dev = ll.device
    keys = reference.pair_keys(_u64(base_keys, dev), _u64(fold, dev),
                               cluster_id).reshape(-1, 2)
    return reference.gibbs_sweep(
        ll, _per_pair(ploidy, ch), _per_pair(hap_valid, ch),
        _per_pair(sparsity, ch), _per_pair(use_sparse, ch), keys, freqs,
        t0, t1, burn_in, osp.torch, tally)


def gibbs_sweep(ll, ploidy, hap_valid, sparsity, use_sparse, cluster_id,
                base_keys, fold, freqs, t0, t1, burn_in, osp, tally=None):
    """Iterations t0..t1-1 of the frozen-noise Gibbs scan.

    ll [N, S, O] with N = Ncl * ch pairs in (cluster, chain) order; per-
    cluster fields [Ncl, ...]; freqs [N, H] (updated in place on the card);
    tally [N, S, O] int32 or None (incremented for t >= burn_in). Returns
    (freqs, tally, o_sel [N, S] int32 of the last iteration)."""
    if not ll.is_cuda:
        return _plain_gibbs_sweep(ll, ploidy, hap_valid, sparsity, use_sparse,
                                  cluster_id, base_keys, fold, freqs, t0, t1,
                                  burn_in, osp, tally)
    dev = ll.device
    osel = _launch_layout("gibbs_sweep",
                   *(x.contiguous() for x in (ll, ploidy, hap_valid, sparsity,
                                              use_sparse)),
                   cluster_id.to(torch.int64).contiguous(),
                   _u32(base_keys, dev), _u32(fold, dev), osp.oa32, osp.ob32,
                   freqs, tally, int(t0), int(t1), int(burn_in))
    return freqs, tally, osel


def _noise_pair_args(llg, cv, ploidy, hap_valid, sparsity, use_sparse,
                     cluster_id, base_keys, fold):
    """noise_step's and joint_step's per-pair plain-version arguments."""
    ch = base_keys.shape[0]
    dev = llg.device
    keys = reference.pair_keys(_u64(base_keys, dev), _u64(fold, dev),
                               cluster_id).reshape(-1, 2)
    return (_per_pair(cv, ch), _per_pair(ploidy, ch),
            _per_pair(hap_valid, ch), _per_pair(sparsity, ch),
            _per_pair(use_sparse, ch), keys)


def _plain_noise_step(llg, a, b, cv, log_r, rates, ploidy, hap_valid,
                      sparsity, use_sparse, cluster_id, base_keys, fold,
                      freqs, t, osp, count_sum, num_obs):
    """noise_step's plain version, with the wrapper's signature."""
    cvp, pl, hv, sp, us, keys = _noise_pair_args(
        llg, cv, ploidy, hap_valid, sparsity, use_sparse, cluster_id,
        base_keys, fold)
    return reference.noise_step(llg, a, b, cvp, log_r, rates, pl, hv, sp, us,
                                keys, freqs, t, osp.torch, count_sum, num_obs)


def noise_step(llg, a, b, cv, log_r, rates, ploidy, hap_valid, sparsity,
               use_sparse, cluster_id, base_keys, fold, freqs, t, osp,
               count_sum, num_obs):
    """One noise-chain iteration of every pair: llg/a/b [N, S, O] f32,
    cv [Ncl] f32, log_r/rates [ch, S], freqs [N, H] (updated in place on
    the card), count_sum/num_obs [ch, S] int32 accumulated. Returns
    (freqs, o_sel [N, S] int32)."""
    if not llg.is_cuda:
        return _plain_noise_step(llg, a, b, cv, log_r, rates, ploidy,
                                 hap_valid, sparsity, use_sparse, cluster_id,
                                 base_keys, fold, freqs, t, osp, count_sum,
                                 num_obs)
    dev = llg.device
    osel = _launch_layout("noise_step",
                   *(x.contiguous() for x in (llg, a, b, cv, log_r, rates,
                                              ploidy, hap_valid, sparsity,
                                              use_sparse)),
                   cluster_id.to(torch.int64).contiguous(),
                   _u32(base_keys, dev), _u32(fold, dev), osp.oa32, osp.ob32,
                   freqs, count_sum, num_obs, int(t))
    return freqs, osel


def _plain_joint_step(llg, a, b, cv, log_r, rates, ploidy, hap_valid,
                      sparsity, use_sparse, cluster_id, base_keys, fold,
                      freqs, t, osp, count_sum, num_obs, tally, burn_in):
    """joint_step's plain version, with the wrapper's signature."""
    cvp, pl, hv, sp, us, keys = _noise_pair_args(
        llg, cv, ploidy, hap_valid, sparsity, use_sparse, cluster_id,
        base_keys, fold)
    return reference.joint_step(llg, a, b, cvp, log_r, rates, pl, hv, sp, us,
                                keys, freqs, t, osp.torch, count_sum, num_obs,
                                tally, burn_in)


def joint_step(llg, a, b, cv, log_r, rates, ploidy, hap_valid, sparsity,
               use_sparse, cluster_id, base_keys, fold, freqs, t, osp,
               count_sum, num_obs, tally, burn_in):
    """One joint noise + genotype iteration of every pair: noise_step's
    arguments with cv [Ncl] the clusters' validity, plus tally [N, S, O]
    int32, incremented at the drawn outcomes for t >= burn_in. Returns
    (freqs, o_sel [N, S] int32)."""
    if not llg.is_cuda:
        return _plain_joint_step(llg, a, b, cv, log_r, rates, ploidy,
                                 hap_valid, sparsity, use_sparse, cluster_id,
                                 base_keys, fold, freqs, t, osp, count_sum,
                                 num_obs, tally, burn_in)
    dev = llg.device
    osel = _launch_layout("joint_step",
                   *(x.contiguous() for x in (llg, a, b, cv, log_r, rates,
                                              ploidy, hap_valid, sparsity,
                                              use_sparse)),
                   cluster_id.to(torch.int64).contiguous(),
                   _u32(base_keys, dev), _u32(fold, dev), osp.oa32, osp.ob32,
                   freqs, count_sum, num_obs, tally, int(t), int(burn_in))
    return freqs, osel


def _plain_noise_rates(k_noise, count_sum, num_obs, rates, log_r, trace, t,
                       prior_shape, prior_scale):
    """noise_rates' plain version, with the wrapper's signature."""
    reference.noise_rates(_u64(k_noise, rates.device), count_sum, num_obs,
                          rates, log_r, trace, t, prior_shape, prior_scale)


def noise_rates(k_noise, count_sum, num_obs, rates, log_r, trace, t,
                prior_shape, prior_scale):
    """The gamma rate update closing iteration t of the noise or joint
    chains, in place: rates/log_r [ch, S] f32 from the int32 statistics
    count_sum/num_obs [ch, S] (then zeroed) and the chains' noise keys
    k_noise [ch, 2]; trace [ch, T, S] gets column t."""
    if not rates.is_cuda:
        return _plain_noise_rates(k_noise, count_sum, num_obs, rates, log_r,
                                  trace, t, prior_shape, prior_scale)
    _launch("noise_rates", _u32(k_noise, rates.device), count_sum, num_obs,
            rates, log_r, trace, int(t), float(prior_shape),
            float(prior_scale))


def _plain_gamma_draw(keys, alpha):
    """gamma_draw's plain version, with the wrapper's signature."""
    return reference.gamma_draw(_u64(keys, alpha.device), alpha)


def gamma_draw(keys, alpha):
    """jax.random.gamma per row: keys [N, 2], alpha [N, E] float32 ->
    [N, E] float32, element e of row n drawn with split(keys[n], E)[e] by
    Marsaglia-Tsang with JAX's rejection loops (ops/prng.gamma)."""
    if not alpha.is_cuda:
        return _plain_gamma_draw(keys, alpha)
    return _launch("gamma_draw", _u32(keys, alpha.device),
                   alpha.to(torch.float32).contiguous())


def unpack_bucket(flat_counts, flat_inter_fm, flat_mult, flat_member, lens,
                  gcol, k):
    """A chunk's dense [C, K, *] bucket tensors from its ragged k-mer rows
    (see reference.unpack_bucket): (counts, inter, mult, member,
    kmer_valid)."""
    if not flat_counts.is_cuda:
        return reference.unpack_bucket(flat_counts, flat_inter_fm, flat_mult,
                                       flat_member, lens, gcol, k)
    return tuple(_launch("unpack_bucket",
                         *(x.contiguous() for x in (flat_counts, flat_inter_fm,
                                                    flat_mult, flat_member)),
                         lens.to(torch.int64).contiguous(),
                         gcol.to(torch.int64).contiguous(), int(k)))


def _plain_subsample_masks(base_keys, fold, cluster_id, kmer_valid, rate,
                           salt):
    """subsample_masks' plain version, with the wrapper's signature."""
    dev = kmer_valid.device
    return reference.subsample_masks(_u64(base_keys, dev), _u64(fold, dev),
                                     cluster_id, kmer_valid, rate, salt)


def kmer_cap(base_keys, fold, cluster_id, w, member, num_haplotypes, cap,
             salt):
    """The exact shuffled-order k-mer cap of subsample masks w [C, ch, K]
    per (haplotype, variant); member [C, K, V, W] packed bits. Chain x of
    cluster c visits its k-mers in the order of its keyed slot uniforms."""
    if not w.is_cuda:
        return _plain_kmer_cap(base_keys, fold, cluster_id, w, member,
                               num_haplotypes, cap, salt)
    dev = w.device
    return _launch_layout("kmer_cap", _u32(base_keys, dev), _u32(fold, dev),
                   cluster_id.to(torch.int64).contiguous(), w.contiguous(),
                   member.contiguous(), int(num_haplotypes), int(cap),
                   int(salt))


def _plain_kmer_cap(base_keys, fold, cluster_id, w, member, num_haplotypes,
                    cap, salt):
    """kmer_cap's plain version, with the wrapper's signature."""
    dev = w.device
    return reference.kmer_cap(_u64(base_keys, dev), _u64(fold, dev),
                              cluster_id, w, member, num_haplotypes, cap,
                              salt)


def bucket_stats(mult, inter, counts, member, hap_allele, num_alleles, ploidy,
                 tally, w, oa, ob, a_cap, t_top, min_gpp, min_nak, fak_thresh,
                 packed, missing=None, mac_extra=None):
    """Posterior statistics of one chunk from its tallies [C, ch, S, O] and
    masks [C, ch, K] (see reference.bucket_stats for the outputs); missing
    (nak, fak, mac) [C, S] each, mac_extra [C, S, V, A] f32 or None."""
    if not tally.is_cuda:
        return reference.bucket_stats(
            mult, inter, counts, member, hap_allele, num_alleles, ploidy,
            tally, w, oa, ob, a_cap, t_top, min_gpp, min_nak, fak_thresh,
            packed, missing, mac_extra)
    dev = tally.device
    if missing is not None:
        missing = torch.stack([x.to(dev, torch.float32) for x in missing])
    out = _launch_layout(
        "bucket_stats",
        *(x.contiguous() for x in (mult, inter, counts, member, hap_allele,
                                   num_alleles, ploidy, tally, w)),
        oa.to(torch.int32).contiguous(), ob.to(torch.int32).contiguous(),
        fak_thresh.to(dev, torch.float32).contiguous(),
        None if missing is None else missing.contiguous(),
        None if mac_extra is None else mac_extra.contiguous(),
        int(a_cap), int(t_top), float(min_gpp), float(min_nak), bool(packed))
    return tuple(out)


@dataclasses.dataclass
class NestedLevel:
    """One rank level of the coupled scan, as tensors on one device.

    The static part (ll, ploidy, parent links, retain table, cluster
    fields, the level's chain key and outcome tables) is read; freqs,
    ocur (the current outcome per (cluster, chain, sample)), tally and the
    MAC accumulator are carried and updated in place. sh holds the shared
    k-mer tables (slot, valid [C, Q]; counts, inter [C, Q, S]; dip
    [C, Q, O]; w [C, ch, Q]; tcut [C, Q, S, M]; mmax) or None; mac the MAC
    fold tables (mem [C, Q, V, H+1] uint8; n_hv [C, ch, V, H+1] f32; ha
    [C, H+1, V] int32; acc [C, ch, S, V, A] f32) or None."""

    ll: torch.Tensor            # [C, ch, S, O] f32, null column zero
    ploidy: torch.Tensor        # [C, S] int8 chromosome ploidy
    parent_level: torch.Tensor  # [C] int32, -1 = no containment parent
    parent_row: torch.Tensor    # [C] int32
    retain: torch.Tensor        # [C, O_pad] int8: ploidy per parent outcome
    hap_valid: torch.Tensor     # [C, H] bool
    sparsity: torch.Tensor      # [C] f32
    use_sparse: torch.Tensor    # [C] bool
    cluster_id: torch.Tensor    # [C] int64
    key: torch.Tensor           # [2] uint32 words (int64): the level's chain key
    osp: object                 # model.gibbs.OutcomeTensors
    freqs: torch.Tensor         # [C * ch, H] f32
    ocur: torch.Tensor          # [C, ch, S] int32
    tally: torch.Tensor         # [C, ch, S, O] int32
    sh: dict | None = None
    mac: dict | None = None


_SH_FIELDS = ("slot", "valid", "counts", "inter", "dip", "w", "tcut")
_MAC_FIELDS = ("mem", "n_hv", "ha", "acc")


def order_groups(groups):
    """groups = (offsets [G+1], members [N, 2]) with the groups in
    descending order of size, ties in their given order: the deepest
    serial chains take the first blocks of the coupled scan."""
    off = groups[0].cpu().numpy().astype(np.int64)
    members = groups[1].cpu().numpy().reshape(-1, 2)
    sizes = off[1:] - off[:-1]
    order = np.argsort(-sizes, kind="stable")
    rows = np.repeat(off[:-1][order], sizes[order]) + (
        np.arange(sizes.sum()) - np.repeat(np.cumsum(sizes[order]) -
                                           sizes[order], sizes[order]))
    new_off = np.concatenate([[0], np.cumsum(sizes[order])])
    return (torch.from_numpy(new_off.astype(np.int32)),
            torch.from_numpy(members[rows].astype(np.int32)))


def nested_tables(levels, groups):
    """The coupled scan's member tables (CPU int32), for groups in launch
    order: members [N, 4] (level, row, the index of its containment parent
    within its group or -1, its valid shared rows); qrows [NQ, 2] (q, the
    slot within its group's dense pool range, numbered in order of first
    use), member after member; the groups' dense ranges as offsets pofs
    [G+1] into gslot [P], the global pool slot of each. Raises where a
    parent is not an earlier member of its child's group or a pool slot is
    shared by two groups."""
    off = groups[0].cpu().numpy().astype(np.int64)
    mem = groups[1].cpu().numpy().reshape(-1, 2).astype(np.int64)
    n = mem.shape[0]
    gid = np.repeat(np.arange(off.size - 1), off[1:] - off[:-1])
    at = {l: np.flatnonzero(mem[:, 0] == l) for l in np.unique(mem[:, 0])}
    index = [np.full(lv.ll.shape[0], -1, np.int64) for lv in levels]
    for l, m in at.items():
        index[l][mem[m, 1]] = m
    parent = np.full(n, -1, np.int64)
    linked = np.zeros(n, bool)
    pair_m, pair_q, pair_slot = [], [], []
    for l, m in at.items():
        lv, r = levels[l], mem[m, 1]
        plv = lv.parent_level.cpu().numpy()[r]
        prw = lv.parent_row.cpu().numpy()[r]
        linked[m] = plv >= 0
        for p in np.unique(plv[plv >= 0]):
            sel = plv == p
            parent[m[sel]] = index[p][prw[sel]]
        if lv.sh is not None:
            valid = lv.sh["valid"].cpu().numpy()[r]
            mi, q = np.nonzero(valid)
            pair_m.append(m[mi])
            pair_q.append(q)
            pair_slot.append(lv.sh["slot"].cpu().numpy()[r][mi, q])
    bad = linked & ((parent < 0) | (gid[np.maximum(parent, 0)] != gid)
                    | (parent >= np.arange(n)))
    if bad.any():
        raise ValueError(f"member {mem[np.argmax(bad)].tolist()}: its "
                         f"containment parent is not an earlier member of "
                         f"its group")
    local = np.where(linked, parent - off[gid], -1)
    cat = lambda x: np.concatenate(x) if x else np.zeros(0, np.int64)  # noqa: E731
    pm, pq, ps = cat(pair_m), cat(pair_q), cat(pair_slot)
    order = np.lexsort((pq, pm))                   # member after member
    pm, pq, ps = pm[order], pq[order], ps[order]
    pg = gid[pm]
    # dense slots: each group's slots numbered by first use
    _, first, inverse = np.unique(np.stack([pg, ps], 1), axis=0,
                                  return_index=True, return_inverse=True)
    uniq = np.argsort(first, kind="stable")        # (group, slot) pairs by use
    ug, us = pg[first[uniq]], ps[first[uniq]]
    by_group = np.argsort(ug, kind="stable")
    rank = np.empty(uniq.size, np.int64)
    counts = np.bincount(ug, minlength=off.size - 1)
    starts = np.concatenate([[0], np.cumsum(counts)])
    rank[uniq[by_group]] = np.arange(uniq.size) - starts[ug[by_group]]
    if np.unique(us).size != us.size:
        raise ValueError("a pool slot is shared by two groups")
    rows = np.stack([mem[:, 0], mem[:, 1], local,
                     np.bincount(pm, minlength=n)], 1)
    qrows = np.stack([pq, rank[inverse.reshape(-1)]], 1)
    as_i32 = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.int32))  # noqa: E731
    return (as_i32(rows), as_i32(qrows), as_i32(starts),
            as_i32(us[by_group]))


def nested_sweep(levels, pool, groups, t0, t1, burn_in):
    """Iterations t0..t1-1 of the coupled scan (gibbs.genotype_nested).

    levels: NestedLevel per rank level; pool [P, ch, S] int32, the shared
    k-mers' summed contributions; groups = (offsets [G+1], members [N, 2]
    (level, row)) int32: the coupled groups, each in level order, no two
    members at one level. On the card one block per (group, chain), deepest
    groups first (order_groups), runs all iterations over its group's
    members with the group's state in shared memory where it fits
    (nested_tables lays it out); groups never interact, so this equals the
    level-major scan of the plain version. Rows in no group are not
    sampled."""
    if not pool.is_cuda:
        return reference.nested_sweep(levels, pool, groups, t0, t1, burn_in)
    empty = torch.empty(0, device=pool.device)
    flat, ints = [], []
    for lv in levels:
        flat += [lv.ll, lv.ploidy, lv.parent_level, lv.parent_row, lv.retain,
                 lv.hap_valid, lv.sparsity, lv.use_sparse, lv.cluster_id,
                 lv.osp.oa32, lv.osp.ob32, lv.freqs, lv.ocur, lv.tally]
        flat += [lv.sh[f] if lv.sh else empty for f in _SH_FIELDS]
        flat += [lv.mac[f] if lv.mac else empty for f in _MAC_FIELDS]
        key = lv.key.tolist()
        ints += [int(lv.sh["mmax"]) if lv.sh else 0, key[0], key[1]]
    ordered = order_groups(groups)
    members, qrows, pofs, gslot = nested_tables(levels, ordered)
    _launch_layout("nested_sweep", flat, ints, pool, members, ordered[0],
                   qrows, pofs, gslot, int(t0), int(t1), int(burn_in))


def lane_lookup(keys, payload, valid, queries):
    """Each query's payload row [N, P] uint8 from one shard of a sorted lane
    table: keys [M, 2] int64 (hi, lo) rows in ascending order, payload
    [M, P] uint8, valid [M] bool, queries [N, 2] int64; zeros where a query
    is absent or its row is a pad row."""
    if not keys.is_cuda:
        return reference.lane_lookup(keys, payload, valid, queries)
    return _launch("lane_lookup", keys.contiguous(), payload.contiguous(),
                   valid.contiguous(), queries.contiguous())


def bloom_query(bits, word, shift):
    """Bloom membership [N] bool: bits [W] the filter's uint32 words (in
    int32), word [H, N] word indices and shift [H, N] bit offsets; a query
    is present when all of its H bits are set."""
    if not bits.is_cuda:
        return reference.bloom_query(bits, word, shift)
    return _launch("bloom_query", bits.contiguous(),
                   word.to(torch.int32).contiguous(),
                   shift.to(torch.int32).contiguous())


# each kernel's plain PyTorch version, called with the wrapper's arguments;
# the wrappers use them for CPU tensors, chip_smoke.py on the card
PLAIN = {
    "subsample_masks": _plain_subsample_masks,
    "ll_noise_terms": reference.ll_noise_terms,
    "gibbs_sweep": _plain_gibbs_sweep,
    "noise_step": _plain_noise_step,
    "kmer_cap": _plain_kmer_cap,
    "bucket_stats": reference.bucket_stats,
    "nested_sweep": reference.nested_sweep,
    "joint_step": _plain_joint_step,
    "noise_rates": _plain_noise_rates,
    "unpack_bucket": reference.unpack_bucket,
    "lane_lookup": reference.lane_lookup,
    "bloom_query": reference.bloom_query,
    "gamma_draw": _plain_gamma_draw,
}
