"""Baum-Welch expected counts + re-estimation over the compiled model.

The reference carries a training path whose stated purpose is verifying the
forward/backward implementation (``forward_extract_posteriors``,
``barcode_hmm.c:3832-4109``; ``reestimate`` ``:5459-5679``;
``set_model_e_to_laplace`` ``:5395``; per-thread count merge ``:5694-5744``;
dispatched as MODE_TRAIN from ``run_pHMM``).  This module provides the same
capability on top of the batched engines:

* `expected_counts` runs backward + forward over a batch and accumulates
  posterior-weighted transition / emission / entry expectations per state
  (float64 accumulation);
* `reestimate` renormalises the counts with +1 Laplace pseudocounts into a
  new parameter set (the reference's mode-0 re-estimation);
* forward/backward consistency (f_score == b_score up to float tolerance) is
  asserted by the accompanying tests, mirroring the reference's use.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from ..constants import DD, DM, II, IM, ISKIP, MD, MI, MM, MSKIP
from ..logsum import p2sp_arr
from ..model import ModelBag, SegmentModel
from .exact import ExactEngine


@dataclass
class Counts:
    trans: List[np.ndarray]  # per segment [H, C, 9] f64
    m_emit: List[np.ndarray]  # [H, C, 5]
    i_emit: List[np.ndarray]  # [H, C, 5]
    s2M: List[np.ndarray]  # [H, C]
    s2I: List[np.ndarray]  # [H, C]


def _sp(x):
    with np.errstate(over="ignore"):
        return np.where(np.isneginf(x), 0.0, np.exp(x.astype(np.float64)))


def expected_counts(mb: ModelBag, seqs: np.ndarray, L: int) -> Counts:
    """Accumulate Baum-Welch expectations for a [B, L+1] batch (terminator
    padded like `ExactEngine.run_batch`)."""
    eng = ExactEngine(mb, use_native=False)
    b_score, Mb, Ib, silent_b = eng.backward(seqs, L)
    # plain forward pass (reuse decode's forward arrays via a fresh run)
    f_score, _bar, _labels, _r = eng.decode(seqs, L, Mb, Ib, b_score)

    counts = Counts(
        trans=[np.zeros((m.num_hmms, m.num_cols, 9)) for m in mb.models],
        m_emit=[np.zeros((m.num_hmms, m.num_cols, 5)) for m in mb.models],
        i_emit=[np.zeros((m.num_hmms, m.num_cols, 5)) for m in mb.models],
        s2M=[np.zeros((m.num_hmms, m.num_cols)) for m in mb.models],
        s2I=[np.zeros((m.num_hmms, m.num_cols)) for m in mb.models],
    )

    # recompute forward arrays with posterior-weighted count accumulation
    # (a compact clean-math version of forward_extract_posteriors)
    B = seqs.shape[0]
    nm = mb.num_models
    NEG = np.float32(-np.inf)
    silent_f = np.full((nm, L + 2, B), NEG, dtype=np.float32)
    Mf = [np.full((m.num_hmms, m.num_cols, L + 1, B), NEG, np.float32) for m in mb.models]
    If = [np.full((m.num_hmms, m.num_cols, L + 1, B), NEG, np.float32) for m in mb.models]
    Df = [np.full((m.num_hmms, m.num_cols, L + 1, B), NEG, np.float32) for m in mb.models]

    silent_f[0, 0] = mb.models[0].skip
    for j in range(1, nm):
        silent_f[j, 0] = silent_f[j - 1, 0] + mb.models[j].skip
    prev = np.full((L + 2, B), NEG, np.float32)
    prev[0] = 0.0

    from ..logsum import logsum

    for j in range(nm):
        m = mb.models[j]
        ps = prev if j == 0 else silent_f[j - 1]
        cs = silent_f[j]
        C = m.num_cols
        for f in range(m.num_hmms):
            tr = m.trans[f]
            me = m.m_emit[f]
            ie = m.i_emit[f]
            MB, IB, DB_ = Mb[j][f], Ib[j][f], None
            MF, IF, DF = Mf[j][f], If[j][f], Df[j][f]
            for i in range(1, L + 1):
                c = seqs[:, i - 1]
                MF[0, i] = ps[i - 1] + m.silent_to_M[f, 0] + me[0][c]
                post = _sp(MF[0, i] + MB[0, i] - b_score)
                counts.s2M[j][f, 0] += post.sum()
                np.add.at(counts.m_emit[j][f, 0], c, post)
                v = logsum(ps[i - 1] + m.silent_to_I[f, 0],
                           IF[0, i - 1] + tr[0, II])
                v = logsum(v, MF[0, i - 1] + tr[0, MI])
                IF[0, i] = v + ie[0][c]
                pI_entry = _sp(ps[i - 1] + m.silent_to_I[f, 0] + ie[0][c] + IB[0, i] - b_score)
                counts.s2I[j][f, 0] += pI_entry.sum()
                pII = _sp(IF[0, i - 1] + tr[0, II] + ie[0][c] + IB[0, i] - b_score)
                counts.trans[j][f, 0, II] += pII.sum()
                pMI = _sp(MF[0, i - 1] + tr[0, MI] + ie[0][c] + IB[0, i] - b_score)
                counts.trans[j][f, 0, MI] += pMI.sum()
                pIfull = _sp(IF[0, i] + IB[0, i] - b_score)
                np.add.at(counts.i_emit[j][f, 0], c, pIfull)
                for g in range(1, C):
                    v = ps[i - 1] + m.silent_to_M[f, g]
                    v = logsum(v, MF[g - 1, i - 1] + tr[g - 1, MM])
                    v = logsum(v, IF[g - 1, i - 1] + tr[g - 1, IM])
                    v = logsum(v, DF[g - 1, i] + tr[g - 1, DM])
                    MF[g, i] = v + me[g][c]
                    pM = _sp(MF[g, i] + MB[g, i] - b_score)
                    np.add.at(counts.m_emit[j][f, g], c, pM)
                    counts.s2M[j][f, g] += _sp(
                        ps[i - 1] + m.silent_to_M[f, g] + me[g][c] + MB[g, i] - b_score
                    ).sum()
                    counts.trans[j][f, g - 1, MM] += _sp(
                        MF[g - 1, i - 1] + tr[g - 1, MM] + me[g][c] + MB[g, i] - b_score
                    ).sum()
                    counts.trans[j][f, g - 1, IM] += _sp(
                        IF[g - 1, i - 1] + tr[g - 1, IM] + me[g][c] + MB[g, i] - b_score
                    ).sum()
                    counts.trans[j][f, g - 1, DM] += _sp(
                        DF[g - 1, i] + tr[g - 1, DM] + me[g][c] + MB[g, i] - b_score
                    ).sum()
                    v = ps[i - 1] + m.silent_to_I[f, g]
                    v = logsum(v, IF[g, i - 1] + tr[g, II])
                    v = logsum(v, MF[g, i - 1] + tr[g, MI])
                    IF[g, i] = v + ie[g][c]
                    pIf = _sp(IF[g, i] + IB[g, i] - b_score)
                    np.add.at(counts.i_emit[j][f, g], c, pIf)
                    counts.trans[j][f, g, II] += _sp(
                        IF[g, i - 1] + tr[g, II] + ie[g][c] + IB[g, i] - b_score
                    ).sum()
                    counts.trans[j][f, g, MI] += _sp(
                        MF[g, i - 1] + tr[g, MI] + ie[g][c] + IB[g, i] - b_score
                    ).sum()
                    v = logsum(MF[g - 1, i] + tr[g - 1, MD],
                               DF[g - 1, i] + tr[g - 1, DD])
                    DF[g, i] = v
                for g in range(C):
                    cs[i] = logsum(cs[i], MF[g, i] + tr[g, MSKIP])
                    cs[i] = logsum(cs[i], IF[g, i] + tr[g, ISKIP])
                cs[i] = logsum(cs[i], ps[i] + m.skip)
    return counts


def lattice_counts_to_counts(mb: ModelBag, CT: np.ndarray, E: np.ndarray) -> Counts:
    """Map psum-reduced lattice-space expectations (CT [5,S,S] transition
    mass, E [5,S] emission mass from parallel.mesh.DistributedTrainer) back
    to the reference's per-segment count arrays, so `reestimate` can consume
    fully distributed counts.

    Each lattice edge's mass splits across the reference count categories in
    proportion to that category's share of the edge weight
    (compile_count_decomposition); emissions come from E directly."""
    from .lattice import compile_count_decomposition

    entry, direct, dpart, meta = compile_count_decomposition(mb)
    A = entry + direct + dpart
    with np.errstate(divide="ignore", invalid="ignore"):
        share = np.where(A > 0, CT.astype(np.float64) / A, 0.0)

    counts = Counts(
        trans=[np.zeros((m.num_hmms, m.num_cols, 9)) for m in mb.models],
        m_emit=[np.zeros((m.num_hmms, m.num_cols, 5)) for m in mb.models],
        i_emit=[np.zeros((m.num_hmms, m.num_cols, 5)) for m in mb.models],
        s2M=[np.zeros((m.num_hmms, m.num_cols)) for m in mb.models],
        s2I=[np.zeros((m.num_hmms, m.num_cols)) for m in mb.models],
    )
    entry_mass = (share * entry).sum(axis=(0, 1))  # per dst
    dm_mass = (share * dpart).sum(axis=(0, 1))
    direct_mass = (share * direct).sum(axis=0)  # [S, S]

    idx = {}
    Scnt = 0
    for j, m in enumerate(mb.models):
        for f in range(m.num_hmms):
            for g in range(m.num_cols):
                idx[("M", j, f, g)] = Scnt
                Scnt += 1
                idx[("I", j, f, g)] = Scnt
                Scnt += 1

    for t, (j, f, g, kind) in meta.items():
        if kind == "M":
            counts.m_emit[j][f, g] += E[:, t]
            counts.s2M[j][f, g] += entry_mass[t]
            if g >= 1:
                pM = idx[("M", j, f, g - 1)]
                pI = idx[("I", j, f, g - 1)]
                counts.trans[j][f, g - 1, MM] += direct_mass[pM, t]
                counts.trans[j][f, g - 1, IM] += direct_mass[pI, t]
                counts.trans[j][f, g - 1, DM] += dm_mass[t]
        else:
            counts.i_emit[j][f, g] += E[:, t]
            counts.s2I[j][f, g] += entry_mass[t]
            counts.trans[j][f, g, II] += direct_mass[t, t]
            counts.trans[j][f, g, MI] += direct_mass[idx[("M", j, f, g)], t]
    return counts


def reestimate(mb: ModelBag, counts: Counts, pseudocount: float = 1.0) -> ModelBag:
    """+pseudocount Laplace renormalisation into a new parameter set
    (reference reestimate mode 0, barcode_hmm.c:5459-5679)."""
    import copy

    out = copy.deepcopy(mb)
    for j, m in enumerate(out.models):
        for f in range(m.num_hmms):
            for g in range(m.num_cols):
                em = counts.m_emit[j][f, g] + pseudocount
                m.m_emit[f, g] = p2sp_arr(em / em.sum())
                ei = counts.i_emit[j][f, g] + pseudocount
                m.i_emit[f, g] = p2sp_arr(ei / ei.sum())
                grp_m = counts.trans[j][f, g][[MM, MI, MD]] + pseudocount
                mskip = np.exp(np.float64(m.trans[f, g, MSKIP]))
                rest = max(1.0 - mskip, 0.0)
                m.trans[f, g, [MM, MI, MD]] = p2sp_arr(
                    grp_m / grp_m.sum() * rest
                )
                grp_i = counts.trans[j][f, g][[II, IM]] + pseudocount
                iskip = np.exp(np.float64(m.trans[f, g, ISKIP]))
                m.trans[f, g, [II, IM]] = p2sp_arr(
                    grp_i / grp_i.sum() * max(1.0 - iskip, 0.0)
                )
    return out
