"""The plain reference that decides `correct`: a genotype-likelihood judge.

It imports numpy and torch only (nothing of the program, nor jax), and
takes only the benchmark's own inputs: the genome, the candidate variants
and each sample's raw k-mer counts, as the generator made them. From
these it works out again what the program derives:

  * variant groups: variants whose k-mer windows overlap (the clusters);
  * every haplotype of a group (each variant ref or alt; a variant inside
    an alternative deletion carries `*`), its k-mers, and each k-mer's
    multiplicity elsewhere in the genome;
  * each sample's k-mer counts at those k-mers, looked up in its table
    (the generator's counts, which its KMC files hold);
  * each sample's count distribution: mean and variance of the counts of
    genome-unique k-mers outside every group (a method-of-moments
    negative binomial, as BayesTyper fits its own).

For a sample and a diploid pair of haplotypes (i, j), a k-mer x occurs
2 * background(x) + occ_i(x) + occ_j(x) times, and its count has the
negative-binomial log-likelihood of that multiplicity (a Poisson of rate
1e-3 where it is 0). Summed over the group's k-mers that gives LL(i, j).

The program's outputs are then judged, as a served model's tokens are:

  * gap: for a called genotype at variant v, the best LL over all pairs
    less the best LL over pairs whose alleles at v are the call. 0 where
    the call is the likelihood's best; a wrong call at 50x lies hundreds
    of nats below. `worst_gap_nats` is the largest over every judged call.
  * missed: among (variant, sample) where the likelihood's best allele
    pair leads every other allele pair at v by `confident_nats` or more, the
    share that the program left uncalled or called otherwise.
  * low posterior: among the same, the share called right whose genotype
    posterior (the VCF's GPP at the call) lies under `gpp_floor`.
  * nb gap: the largest relative gap between the program's haploid NB
    mean of a sample and the reference's.
  * noise gap: the widest |ln| of the ratio of the program's noise rate
    of a sample to the reference's: the gamma posterior mean of a Poisson
    rate over the k-mers that the likelihood's best pair gives no copy, in
    the groups that the noise scan reads (whole groups with no allele
    inside another's), a `kmer_subsampling_rate` share of them a chain.
  * noise rows: the (chain, iteration) rows of the noise-parameter file
    missing or extra against the configuration's chains, burn-in and
    samples (exact).

Every variant of every group is judged, in every unit of the window. A
group of more than `max_haplotypes` haplotypes (judge.json's 65, which a
configuration may raise: the coupled mix's 64-SNV family and families of 7
or 8 SNVs under a deletion) is judged in local windows: the members that no
k-mer joins, each window with the members whose alleles lie around it (each
SNV with its parent deletion), over the k-mers of the window alone. A
variant that no group or window of at most `max_haplotypes` holds is not
judged, and `unjudged_share` counts it.

The pairs' likelihoods are computed in blocks of groups of one shape on the
device. A group of at most SMALL_HAPLOTYPES haplotypes gathers each pair's
multiplicity of every k-mer. A larger one (a dense SNV family, a deletion
over 7 SNVs or more) splits each k-mer's term by its occurrences in the two haplotypes:
where a k-mer occurs at most once in every haplotype, with f_d its term at
multiplicity 2 * background + d,

    f(2bg + a + b) = f_0 + (a + b)(f_1 - f_0) + ab(f_2 - 2 f_1 + f_0),

so LL(i, j) = sum f_0 + u_i + u_j + (A diag(f_2 - 2 f_1 + f_0) A^T)_ij per
sample, A the [H, X] occurrence matrix: one float64 matrix product a
sample. The k-mers that some haplotype holds twice or more go through the
gather, in blocks of pairs. The noise k-mers' number and counts are products
of the same form over the indicator of no occurrence.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import kmers

STAR = 2
NOISE_RATE = 1e-3
# the gap of a call that no pair of haplotypes makes, and of a mean that is
# not a number (finite, for JSON)
NO_PAIR_GAP = 1e30
# groups of at most this many haplotypes gather every pair's multiplicities
# (the judge's reach before a configuration could raise it); larger ones take
# the matrix products
SMALL_HAPLOTYPES = 65
# the judge settings a configuration may state (its "judge" key)
CONFIG_KEYS = ("max_haplotypes",)
_POW = 4 ** np.arange(26, -1, -1, dtype=np.int64)


def small_lanes(seq: bytes, k: int):
    """Canonical (hi, lo) int64 numpy lanes of a short sequence's k-mers."""
    codes = kmers._CODE[np.frombuffer(seq, np.uint8)].astype(np.int64)
    n = len(codes) - k + 1
    if n <= 0:
        z = np.zeros(0, np.int64)
        return z, z
    win = np.lib.stride_tricks.sliding_window_view(codes, k)
    n_hi = min(kmers.N_HI, k)
    w_hi, w_lo = _POW[kmers.N_HI - n_hi:], 4 ** np.arange(k - n_hi - 1, -1, -1,
                                                           dtype=np.int64)
    f_hi, f_lo = win[:, :n_hi] @ w_hi, win[:, n_hi:] @ w_lo
    rc = 3 - win[:, ::-1]
    r_hi, r_lo = rc[:, :n_hi] @ w_hi, rc[:, n_hi:] @ w_lo
    fwd = (f_hi < r_hi) | ((f_hi == r_hi) & (f_lo <= r_lo))
    return np.where(fwd, f_hi, r_hi), np.where(fwd, f_lo, r_lo)


def variant_groups(variants, k, seq_len):
    """Lists of variant indices whose k-mer windows overlap (variants sorted
    by position), with each group's region [a, b)."""
    groups = []
    for vi, (pos, ref, _) in enumerate(variants):
        a, b = max(0, pos - k + 1), min(seq_len, pos + len(ref) + k - 1)
        if groups and a < groups[-1][2]:
            groups[-1][0].append(vi)
            groups[-1][2] = max(groups[-1][2], b)
        else:
            groups.append([[vi], a, b])
    return [(g, a, b) for g, a, b in groups]


def haplotypes(variants, members, limit):
    """Allele vectors over a group's variants (0 ref, 1 alt, STAR inside an
    alternative deletion), or None past `limit` haplotypes."""
    out = [[]]
    for m, vi in enumerate(members):
        pos = variants[vi][0]
        around = [n for n, u in enumerate(members[:m])
                  if variants[u][0] < pos < variants[u][0] + len(variants[u][1])]
        nxt = []
        for h in out:
            covered = any(h[n] == 1 for n in around)
            nxt.extend([h + [STAR]] if covered else [h + [0], h + [1]])
        if len(nxt) > limit:
            return None
        out = nxt
    return out


def apply(seq, a, b, variants, members, alleles):
    """The region [a, b) of a haplotype. An alternative allele that starts
    before the region (a deletion around a local window) puts none of its
    bases in it; the region resumes where its reference allele ends."""
    parts, cur = [], a
    for vi, al in zip(members, alleles):
        if al != 1:
            continue
        pos, ref, alt = variants[vi]
        if pos >= cur:
            parts.append(seq[cur:pos])
            parts.append(alt)
        cur = max(cur, pos + len(ref))
    parts.append(seq[cur:b])
    return "".join(parts).encode()


def _covers(u, v):
    """Whether variant u's reference allele lies around variant v's start."""
    return u[0] < v[0] < u[0] + len(u[1])


def local_windows(variants, members, k, seq_len):
    """A group too wide to enumerate, split into local windows: the members
    that no k-mer joins (starts more than k - 1 bases apart, each window
    [a, b) holding every k-mer over its members and no other member's
    reference bases), each with the members whose alleles lie around it,
    as (members, a, b). In the coupled mix these are each SNV under its
    parent deletion."""
    around = [u for u in members
              if any(_covers(variants[u], variants[v]) for v in members)]
    inner = [v for v in members if v not in around]
    parts = []
    for v in inner:
        pos, ref, _ = variants[v]
        if parts and pos - parts[-1][2] <= k - 2:
            parts[-1][0].append(v)
            parts[-1][2] = max(parts[-1][2], pos + len(ref))
        else:
            parts.append([[v], pos, pos + len(ref)])
    out = []
    for part, lo, hi in parts:
        a, b = max(0, lo - k + 1), min(seq_len, hi + k - 1)
        outer = [u for u in around if variants[u][0] < b
                 and variants[u][0] + len(variants[u][1]) > a]
        out.append((sorted(outer + part, key=lambda u: variants[u][0]), a,
                    b))
    return out


NOCALL = -100      # no record, or a record whose genotype is not called
UNKNOWN = -50      # a called allele the candidate does not have


def pair_code(a, b):
    """The code of an unordered allele pair (alleles 0, 1, STAR; -1 for
    an allele the candidate does not have, which matches no pair)."""
    lo, hi = min(a, b), max(a, b)
    return UNKNOWN if lo < 0 else lo * 3 + hi


@dataclasses.dataclass
class Group:
    members: list        # variant indices
    alleles: np.ndarray  # [H, V] allele of each haplotype at each member
    occ: np.ndarray      # [X, H] occurrences of each k-mer in each haplotype
    bg: np.ndarray       # [X] copies per haplotype elsewhere in the genome
    rows: np.ndarray     # [X] row of each k-mer in the judge's query
    single: bool         # a whole group with no allele inside another's:
                         # the program's noise scan reads it
    hits: tuple = None   # past SMALL_HAPLOTYPES, in place of occ: the
                         # (k-mer, haplotype) of every occurrence


class Judge:
    """Built after the window from the generator's inputs; scores the
    calls of every variant in a group of at most `max_haplotypes`
    haplotypes."""

    def __init__(self, sim, k, seed, device, spec):
        self.k = k
        self.device = device
        self.conf = spec["confident_nats"]
        self.budget = spec.get("block_elements", 1 << 25)
        self.num_variants = len(sim.variants)
        rng = np.random.default_rng(seed)
        seq = sim.seq
        variants = sim.variants
        g_hi, g_lo, g_n = kmers.count([seq.encode()], k, device)
        grouped = variant_groups(variants, k, len(seq))
        # every group's k-mers and occurrence matrix
        q_hi, q_lo, built = [], [], []
        base = 0
        self.unjudged = 0
        self.windows = 0
        todo = []
        for members, a, b in grouped:
            haps = haplotypes(variants, members, spec["max_haplotypes"])
            if haps is not None:
                todo.append((members, a, b, haps, True))
                continue
            judged = set()
            for part in local_windows(variants, members, k, len(seq)):
                haps = haplotypes(variants, part[0], spec["max_haplotypes"])
                if haps is not None:
                    todo.append((*part, haps, False))
                    judged.update(part[0])
                    self.windows += 1
            self.unjudged += len(set(members) - judged)
        for members, a, b, haps, whole in todo:
            lanes = [small_lanes(apply(seq, a, b, variants, members, h), k)
                     for h in haps]
            lanes.append(small_lanes(seq[a:b].encode(), k))
            hi = np.concatenate([p[0] for p in lanes])
            lo = np.concatenate([p[1] for p in lanes])
            order = np.lexsort((lo, hi))
            new = np.ones(len(order), bool)
            new[1:] = ((hi[order][1:] != hi[order][:-1])
                       | (lo[order][1:] != lo[order][:-1]))
            inv = np.empty(len(order), np.int64)
            inv[order] = np.cumsum(new) - 1
            first = order[new]
            col = np.repeat(np.arange(len(lanes)), [len(p[0]) for p in lanes])
            if len(haps) <= SMALL_HAPLOTYPES:
                occ = np.zeros((len(first), len(lanes)), np.int64)
                np.add.at(occ, (inv, col), 1)
            else:
                occ = (inv, col)
            q_hi.append(hi[first])
            q_lo.append(lo[first])
            built.append((members, np.array(haps), occ, base, len(first),
                          whole and STAR not in np.array(haps)))
            base += len(first)
        q_hi = torch.from_numpy(np.concatenate(q_hi)).to(device)
        q_lo = torch.from_numpy(np.concatenate(q_lo)).to(device)
        idx = kmers.lookup(g_hi, g_lo, q_hi, q_lo)
        genome_n = torch.where(idx >= 0, g_n[idx.clamp(min=0)],
                               torch.zeros_like(idx)).cpu().numpy()
        self.groups = []
        for members, haps, occ, b0, x, single in built:
            rows = np.arange(b0, b0 + x)
            if isinstance(occ, tuple):
                inv, col = occ
                ref = col == len(haps)
                bg = genome_n[b0:b0 + x] - np.bincount(inv[ref], minlength=x)
                self.groups.append(Group(members, haps, None, bg, rows,
                                         single, (inv[~ref], col[~ref])))
                continue
            bg = genome_n[b0:b0 + x] - occ[:, -1]
            self.groups.append(Group(members, haps, occ[:, :-1], bg, rows,
                                     single))
        # the count distribution's k-mers: genome-unique, outside groups
        outside = np.ones(len(seq) - k + 1, bool)
        for _, a, b in grouped:
            outside[a:max(a, b - k + 1)] = False
        pos = np.flatnonzero(outside)
        pos = pos[rng.choice(len(pos), min(len(pos), spec["nb_kmers"]),
                             replace=False)]
        p_hi, p_lo = kmers.lanes(kmers.encode(seq.encode(), device), k)
        pos_t = torch.from_numpy(pos).to(device)
        n_hi, n_lo = p_hi[pos_t], p_lo[pos_t]
        del p_hi, p_lo
        uniq = g_n[kmers.lookup(g_hi, g_lo, n_hi, n_lo)] == 1
        n_hi, n_lo = n_hi[uniq], n_lo[uniq]
        del g_hi, g_lo, g_n
        # each sample's counts at the judged k-mers and the NB k-mers
        counts, self.mean, self.ratio = [], [], []
        for t_hi, t_lo, t_c in sim.tables:
            t_hi = torch.from_numpy(t_hi).to(device)
            t_lo = torch.from_numpy(t_lo).to(device)
            t_c = torch.from_numpy(t_c).to(device).long()

            def at(h, lo_):
                i = kmers.lookup(t_hi, t_lo, h, lo_)
                return torch.where(i >= 0, t_c[i.clamp(min=0)],
                                   torch.zeros_like(i))

            counts.append(at(q_hi, q_lo))
            c = at(n_hi, n_lo).double()
            m, v = float(c.mean()), float(c.var())
            self.mean.append(m / 2.0)          # haploid: two copies
            self.ratio.append(max(v / m, 1.0 + 1e-6))
        self.counts = torch.stack(counts, 1).double()        # [Q, S]
        self.buckets = {}
        for gi, g in enumerate(self.groups):
            self.buckets.setdefault(g.alleles.shape, []).append(gi)
        # a bucket of large groups holds as many as keep its [G, P, S]
        # tensors within the block: keys (H, V, first group's place)
        for shape in [sh for sh in self.buckets if sh[0] > SMALL_HAPLOTYPES]:
            gis = self.buckets.pop(shape)
            pairs = shape[0] * (shape[0] + 1) // 2
            per = max(1, self.budget // (pairs * len(self.mean)))
            for c in range(0, len(gis), per):
                self.buckets[(*shape, c)] = gis[c:c + per]
        self._ll = {}
        self._noise = {}

    def bucket_ll(self, shape):
        """LL [G, P, S] of every diploid pair of the groups whose allele
        matrices have this shape, with the pairs' (i, j)."""
        if shape in self._ll:
            return self._ll[shape]
        if shape[0] > SMALL_HAPLOTYPES:
            return self._large_ll(shape)
        dev = self.device
        h = shape[0]
        i, j = (torch.from_numpy(t).to(dev) for t in np.triu_indices(h))
        mean = torch.tensor(self.mean, dtype=torch.float64, device=dev)
        ratio = torch.tensor(self.ratio, dtype=torch.float64, device=dev)
        gis = self.buckets[shape]
        out = torch.zeros(len(gis), len(i), len(self.mean),
                          dtype=torch.float64, device=dev)
        # per pair: the k-mers it gives no copy at all (the noise k-mers)
        # and their counts in each sample
        n0 = torch.zeros(len(gis), len(i), dtype=torch.float64, device=dev)
        c0 = torch.zeros_like(out)
        start = 0
        while start < len(gis):
            stop, size = start, 0
            while stop < len(gis) and (stop == start or size + len(
                    self.groups[gis[stop]].rows) * len(i) <= self.budget):
                size += len(self.groups[gis[stop]].rows) * len(i)
                stop += 1
            part = [self.groups[g] for g in gis[start:stop]]
            occ = torch.from_numpy(np.concatenate([g.occ for g in part])).to(dev)
            bg = torch.from_numpy(np.concatenate([g.bg for g in part])).to(dev)
            rows = torch.from_numpy(np.concatenate([g.rows for g in part])).to(dev)
            gid = torch.repeat_interleave(
                torch.arange(len(part), device=dev),
                torch.tensor([len(g.rows) for g in part], device=dev))
            c = self.counts[rows]                                 # [X, S]
            mult = 2 * bg[:, None] + occ[:, i] + occ[:, j]        # [X, P]
            mvals = torch.unique(mult)
            tab = torch.stack([_log_count_prob(c, int(m), mean, ratio)
                               for m in mvals.tolist()])          # [M, X, S]
            x = c.shape[0]
            flat = (torch.searchsorted(mvals, mult) * x
                    + torch.arange(x, device=dev)[:, None])       # [X, P]
            for s in range(c.shape[1]):
                out[start:stop, :, s].index_add_(
                    0, gid, tab[:, :, s].reshape(-1)[flat])
            zero = (mult == 0).double()                           # [X, P]
            n0[start:stop].index_add_(0, gid, zero)
            c0[start:stop].index_add_(0, gid, zero[:, :, None] * c[:, None])
            start = stop
        self._ll[shape] = (out, i, j)
        self._noise[shape] = (n0, c0)
        return self._ll[shape]

    def _large_ll(self, key):
        """bucket_ll of a bucket of groups past SMALL_HAPLOTYPES, by the
        matrix products of the module's docstring: group by group, the
        k-mers that some haplotype holds twice or more in blocks of pairs."""
        dev = self.device
        h = key[0]
        i, j = (torch.from_numpy(t).to(dev) for t in np.triu_indices(h))
        flat_ij = i * h + j
        mean = torch.tensor(self.mean, dtype=torch.float64, device=dev)
        ratio = torch.tensor(self.ratio, dtype=torch.float64, device=dev)
        gis = self.buckets[key]
        num_s = len(self.mean)
        out = torch.zeros(len(gis), len(i), num_s, dtype=torch.float64,
                          device=dev)
        n0 = torch.zeros(len(gis), len(i), dtype=torch.float64, device=dev)
        c0 = torch.zeros_like(out)
        for gn, gi in enumerate(gis):
            g = self.groups[gi]
            x = len(g.rows)
            kmer, hap = (torch.from_numpy(t).to(dev) for t in g.hits)
            occ = torch.zeros(x, h, dtype=torch.float64, device=dev)
            occ.index_put_((kmer, hap),
                           torch.ones(len(kmer), dtype=torch.float64,
                                      device=dev), accumulate=True)
            bg = torch.from_numpy(g.bg).to(dev)
            c = self.counts[torch.from_numpy(g.rows).to(dev)]     # [X, S]
            once = occ.max(1).values <= 1
            # k-mers at most once in every haplotype: a product a sample
            xb = once.nonzero().squeeze(1)
            a = occ[xb].T.contiguous()                            # [H, XB]
            cb, mb = c[xb], 2 * bg[xb]
            mvals = torch.unique(torch.cat([mb, mb + 1, mb + 2]))
            tab = torch.stack([_log_count_prob(cb, int(m), mean, ratio)
                               for m in mvals.tolist()])          # [M, XB, S]
            at = torch.arange(len(xb), device=dev)
            f0, f1, f2 = (tab[torch.searchsorted(mvals, mb + d), at]
                          for d in range(3))                      # [XB, S]
            u = a @ (f1 - f0)                                     # [H, S]
            d2 = f2 - 2 * f1 + f0
            base = f0.sum(0)
            for s in range(num_s):
                q = (a * d2[:, s]) @ a.T                          # [H, H]
                out[gn, :, s] = (base[s] + u[i, s] + u[j, s]
                                 + q.reshape(-1)[flat_ij])
            del a, u, d2, tab
            # k-mers some haplotype holds twice or more: every pair's
            # multiplicity, in blocks of pairs
            xm = (~once).nonzero().squeeze(1)
            if len(xm):
                om, cm, bm = occ[xm].long(), c[xm], 2 * bg[xm]
                step = max(1, self.budget // (len(xm) * num_s))
                for p0 in range(0, len(i), step):
                    ii, jj = i[p0:p0 + step], j[p0:p0 + step]
                    mult = bm[:, None] + om[:, ii] + om[:, jj]    # [XM, Pb]
                    mv = torch.unique(mult)
                    tm = torch.stack([_log_count_prob(cm, int(m), mean, ratio)
                                      for m in mv.tolist()])      # [M, XM, S]
                    at = torch.arange(len(xm), device=dev)[:, None]
                    out[gn, p0:p0 + step] += tm[torch.searchsorted(mv, mult),
                                                at].sum(0)
            # the noise k-mers: no background copy and none in either
            zero = (occ[bg == 0] == 0).double().T                 # [H, X0]
            cz = c[bg == 0]
            n0[gn] = (zero @ zero.T).reshape(-1)[flat_ij]
            for s in range(num_s):
                c0[gn, :, s] = ((zero * cz[:, s]) @ zero.T).reshape(-1)[
                    flat_ij]
            del occ, zero
        self._ll[key] = (out, i, j)
        self._noise[key] = (n0, c0)
        return self._ll[key]

    def noise_rates(self, sub_rate, prior_shape, prior_scale):
        """[S] each sample's noise rate as the program's noise scan should
        find it: over the groups it reads (`single`), at the likelihood's
        best pair, the k-mers the pair gives no copy and their counts, a
        share `sub_rate` of them read by each chain; the mean of the
        gamma posterior (prior_shape + counts) / (1 / prior_scale + k-mers)."""
        num = torch.zeros(len(self.mean), dtype=torch.float64,
                          device=self.device)
        cnt = torch.zeros_like(num)
        for shape, gis in self.buckets.items():
            ll, _, _ = self.bucket_ll(shape)
            n0, c0 = self._noise[shape]
            use = torch.tensor([self.groups[g].single for g in gis],
                               device=self.device)
            best_p = ll.argmax(1)                                 # [G, S]
            num += (n0.gather(1, best_p) * use[:, None]).sum(0)
            cnt += (c0.gather(1, best_p[:, None]).squeeze(1)
                    * use[:, None]).sum(0)
        return ((prior_shape + sub_rate * cnt)
                / (1.0 / prior_scale + sub_rate * num)).cpu().numpy()

    def _pair_codes(self, shape):
        """[G, P, V] codes of each pair's alleles at each member."""
        _, i, j = self.bucket_ll(shape)
        al = torch.from_numpy(np.stack(
            [self.groups[g].alleles for g in self.buckets[shape]])).to(
                self.device)                                      # [G, H, V]
        a, b = al[:, i.cpu()], al[:, j.cpu()]
        return torch.minimum(a, b) * 3 + torch.maximum(a, b)

    def best_codes(self, num_variants):
        """[V, S] codes of the likelihood's best calls (for the tests)."""
        out = np.full((num_variants, len(self.mean)), NOCALL, np.int64)
        for shape, gis in self.buckets.items():
            ll, _, _ = self.bucket_ll(shape)
            code = self._pair_codes(shape)
            best_p = ll.argmax(1)                                 # [G, S]
            members = np.array([self.groups[g].members for g in gis])
            for v in range(shape[1]):
                out[members[:, v]] = code[:, :, v].gather(1, best_p).cpu()
        return out

    def judge(self, units_codes, units_nb_mean, units_gpp=None,
              units_noise=None, noise_ref=None, gpp_floor=0.99):
        """Scores over the units' calls, each a [V, S] code array (NOCALL
        where a variant has no called genotype): the worst gap, the share
        of confident (variant, sample) missed or called otherwise, the NB
        gap; with each unit's [V, S] posterior of its calls (units_gpp),
        the share of confident (variant, sample) called right whose
        posterior lies under gpp_floor; with each unit's [S] noise rates
        and the reference's (noise_ref), the widest |ln| of their ratio."""
        worst, missed, confident, calls, low = 0.0, 0, 0, 0, 0
        codes = [torch.from_numpy(c).to(self.device) for c in units_codes]
        gpps = [torch.from_numpy(g).to(self.device) for g in units_gpp or []]
        for shape, gis in self.buckets.items():
            ll, _, _ = self.bucket_ll(shape)
            pair = self._pair_codes(shape)                        # [G, P, V]
            best, best_p = ll.max(1)                              # [G, S]
            members = torch.tensor([self.groups[g].members for g in gis],
                                   device=self.device)            # [G, V]
            for v in range(shape[1]):
                code = pair[:, :, v]                              # [G, P]
                ref = code.gather(1, best_p)                      # [G, S]
                mine = code[:, :, None] == ref[:, None, :]        # [G, P, S]
                other = ll.masked_fill(mine, -math.inf).max(1).values
                sure = (best - other) >= self.conf
                for u, unit in enumerate(codes):
                    call = unit[members[:, v]]                    # [G, S]
                    called = call != NOCALL
                    match = code[:, :, None] == call[:, None, :]
                    cons = ll.masked_fill(~match, -math.inf).max(1).values
                    gap = torch.where(match.any(1), best - cons,
                                      torch.full_like(best, NO_PAIR_GAP))
                    if bool(called.any()):
                        worst = max(worst, float(gap[called].max()))
                    confident += int(sure.sum())
                    missed += int((sure & (~called | (gap > 0))).sum())
                    calls += int(called.sum())
                    if gpps:
                        post = gpps[u][members[:, v]]
                        low += int((sure & called & (gap <= 0)
                                    & ~(post >= gpp_floor)).sum())
        nb = 0.0
        for means in units_nb_mean:
            for s, m in enumerate(means):
                gap = abs(m - self.mean[s]) / self.mean[s]
                nb = max(nb, gap if math.isfinite(gap) else NO_PAIR_GAP)
        out = {"worst_gap_nats": float(worst),
               "missed_share": missed / max(confident, 1),
               "nb_mean_gap": float(nb), "confident": confident,
               "calls": calls,
               "unjudged_share": self.unjudged / max(self.num_variants, 1)}
        if gpps:
            out["low_gpp_share"] = low / max(confident, 1)
        if units_noise is not None:
            out["noise_rate_gap"] = max(
                (_log_gap(r, q) for rates in units_noise
                 for r, q in zip(rates, noise_ref)), default=0.0)
        return out


def _log_gap(rate, ref):
    """|ln(rate / ref)|, NO_PAIR_GAP where the rate is not a positive
    number."""
    rate = float(rate)
    if not (math.isfinite(rate) and rate > 0):
        return NO_PAIR_GAP
    return abs(math.log(rate / ref))


def _log_count_prob(c, m, mean, ratio):
    """log P(count c | multiplicity m) [X, S]: a negative binomial of mean
    mean * m and variance ratio times that, a Poisson of NOISE_RATE at 0."""
    if m == 0:
        lam = NOISE_RATE
        return -lam + c * math.log(lam) - torch.lgamma(c + 1)
    mu = mean * m
    r = mu / (ratio - 1.0)
    p = 1.0 / ratio
    return (torch.lgamma(c + r) - torch.lgamma(r) - torch.lgamma(c + 1)
            + r * torch.log(p) + c * torch.log1p(-p))


def read_calls(vcf_path, variants, num_samples):
    """([V, S] codes, [V, S] posteriors) of a VCF's calls: pair_code (NOCALL
    where a variant has no record or no called genotype), matched by
    position and REF, alleles mapped onto the reference's (0 ref, 1 alt,
    STAR); and the GPP of each called genotype (NaN where none)."""
    where = {(pos + 1, ref): vi for vi, (pos, ref, _) in enumerate(variants)}
    out = np.full((len(variants), num_samples), NOCALL, np.int64)
    gpp = np.full((len(variants), num_samples), np.nan)
    with open(vcf_path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            vi = where.get((int(f[1]), f[3]))
            if vi is None:
                continue
            alt = variants[vi][2]
            allele = [0] + [1 if a == alt else STAR if a == "*" else -1
                            for a in f[4].split(",")]
            keys = f[8].split(":")
            at = keys.index("GPP") if "GPP" in keys else -1
            for s in range(num_samples):
                field = f[9 + s].split(":")
                gt = field[0].replace("|", "/").split("/")
                if "." in gt:
                    continue
                out[vi, s] = pair_code(*(allele[int(a)] for a in gt))
                if 0 <= at < len(field) and len(gt) == 2:
                    lo, hi = sorted(int(a) for a in gt)
                    post = field[at].split(",")
                    idx = hi * (hi + 1) // 2 + lo
                    if idx < len(post) and post[idx] != ".":
                        gpp[vi, s] = float(post[idx])
    return out, gpp


def noise_rows_gap(path, num_chains, iterations):
    """The (chain, iteration) rows of a noise-parameter file that differ
    from the configuration's num_chains chains of `iterations` draws after
    their initial rates: rows missing plus rows extra (0 where it is
    whole; the final averaged row, chain 0, is not counted)."""
    want = {(c, t) for c in range(1, num_chains + 1)
            for t in range(iterations + 1)}
    seen = set()
    with open(path) as fh:
        next(fh)
        for line in fh:
            c, t = line.split("\t", 2)[:2]
            if int(c) > 0:
                seen.add((int(c), int(t)))
    return len(want ^ seen)
