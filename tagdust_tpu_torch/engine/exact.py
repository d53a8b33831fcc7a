"""Deterministic float32 DP engine, bit-compatible with the reference.

Implements the three dynamic programs of the reference engine —
``backward`` (``barcode_hmm.c:3439-3640``), ``forward`` (``:3655-3816``) and
``forward_max_posterior_decoding`` (``:4128-4525``, the production labeling
pass with the optimal-accuracy label DP) — with *identical float32 op
ordering*: every log-space accumulation goes through the same 16k-entry
table `logsum` in the same left-to-right association the C code uses, so
scores, posterior label paths and Q values are bit-identical to the
``-DRTEST`` reference build.

Differences in *shape*, not semantics: instead of per-column malloc'd slices
the DP state lives in dense arrays ``[H, C, L+2, B]`` vectorised over a batch
``B`` of same-length reads (the caller buckets by length).  The per-read
work is embarrassingly parallel, so batching over B preserves the exact
scalar op order per read.

Notable reference quirks reproduced here:

* the backward pass at position ``i == len`` reads the NUL terminator past
  the sequence end, which has nucleotide code 0 ('A')
  (``barcode_hmm.c:3512-3516``); callers must pad ``seqs[:, L] = 0``;
* the segment-skip term is added to the silent state once per *alternative*
  HMM, not once per segment (``:3600``, ``:3788``);
* the barcode-probability normalisation subtracts the per-segment total
  twice (``:4354-4418``);
* ``next_silent`` aliases ``previous_silent`` (``:4151-4152``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import numpy as np

from ..constants import DD, DM, II, IM, ISKIP, MD, MI, MM, MSKIP
from ..logsum import NEG_INF, logsum, p2sp, sp2p_arr
from ..model import ModelBag

_F32 = np.float32


@dataclass
class BatchResult:
    f_score: np.ndarray  # [B] f32
    b_score: np.ndarray  # [B] f32
    r_score: np.ndarray  # [B] f32
    bar_prob: np.ndarray  # [B] f32
    labels: np.ndarray  # [B, L+1] int32


class ExactEngine:
    """Dispatches to the native C++ engine (csrc/exact_engine.cpp) when
    available; the numpy implementation below is the readable reference and
    fallback (both produce bit-identical float32 results)."""

    def __init__(self, mb: ModelBag, use_native: bool = None):
        self.mb = mb
        if use_native is None:
            use_native = os.environ.get("TAGDUST_TPU_NO_NATIVE") != "1"
        self.flat = None
        if use_native:
            try:
                from .native import FlatModel

                self.flat = FlatModel(mb)
            except Exception:
                self.flat = None

    # ---------- backward ----------
    def backward(self, seqs: np.ndarray, L: int):
        """Returns (b_score[B], Mb, Ib, silent_b) with Mb/Ib lists of
        [H, C, L+2, B] arrays per segment."""
        mb = self.mb
        B = seqs.shape[0]
        nm = mb.num_models
        Mb: List[np.ndarray] = []
        Ib: List[np.ndarray] = []
        Db: List[np.ndarray] = []
        silent_b = np.full((nm, L + 2, B), NEG_INF, dtype=np.float32)
        for m in mb.models:
            H, C = m.num_hmms, m.num_cols
            Mb.append(np.full((H, C, L + 2, B), NEG_INF, dtype=np.float32))
            Ib.append(np.full((H, C, L + 2, B), NEG_INF, dtype=np.float32))
            Db.append(np.full((H, C, L + 2, B), NEG_INF, dtype=np.float32))

        prev_silent = np.full((L + 2, B), NEG_INF, dtype=np.float32)
        prev_silent[L + 1] = _F32(0.0)

        silent_b[nm - 1, L + 1] = _F32(_F32(0.0) + mb.models[nm - 1].skip)
        for j in range(nm - 2, -1, -1):
            silent_b[j, L + 1] = (silent_b[j + 1, L + 1] + mb.models[j].skip).astype(
                np.float32
            )

        for j in range(nm - 1, -1, -1):
            m = mb.models[j]
            psilent = prev_silent if j == nm - 1 else silent_b[j + 1]
            csilent = silent_b[j]
            C = m.num_cols
            last = C - 1
            for f in range(m.num_hmms):
                me = m.m_emit[f]  # [C,5]
                ie = m.i_emit[f]
                tr = m.trans[f]  # [C,9]
                MB, IB, DB = Mb[j][f], Ib[j][f], Db[j][f]
                for i in range(L, 0, -1):
                    c = seqs[:, i]  # seqa[i+1] (0-based seq[i]); i==L reads pad 'A'
                    cprev = seqs[:, i - 1]  # seqa[i]
                    # last column (barcode_hmm.c:3518-3543)
                    MB[last, i] = (psilent[i + 1] + tr[last, MSKIP]).astype(np.float32)
                    v = (psilent[i + 1] + tr[last, ISKIP]).astype(np.float32)
                    v = logsum(
                        v,
                        ((MB[last, i + 1] + tr[last, IM]).astype(np.float32) + me[last][c]).astype(np.float32),
                    )
                    v = logsum(
                        v,
                        ((IB[last, i + 1] + tr[last, II]).astype(np.float32) + ie[last][c]).astype(np.float32),
                    )
                    IB[last, i] = v
                    csilent[i] = logsum(
                        csilent[i],
                        ((MB[last, i] + m.silent_to_M[f, last]).astype(np.float32) + me[last][cprev]).astype(np.float32),
                    )
                    csilent[i] = logsum(
                        csilent[i],
                        ((IB[last, i] + m.silent_to_I[f, last]).astype(np.float32) + ie[last][cprev]).astype(np.float32),
                    )
                    DB[last, i] = NEG_INF
                    # interior columns, descending (:3544-3586)
                    for g in range(last - 1, -1, -1):
                        v = ((MB[g + 1, i + 1] + me[g + 1][c]).astype(np.float32) + tr[g, MM]).astype(np.float32)
                        v = logsum(v, (psilent[i + 1] + tr[g, MSKIP]).astype(np.float32))
                        v = logsum(
                            v,
                            ((IB[g, i + 1] + ie[g][c]).astype(np.float32) + tr[g, MI]).astype(np.float32),
                        )
                        v = logsum(v, (DB[g + 1, i] + tr[g, MD]).astype(np.float32))
                        MB[g, i] = v
                        v = ((IB[g, i + 1] + tr[g, II]).astype(np.float32) + ie[g][c]).astype(np.float32)
                        v = logsum(v, (psilent[i + 1] + tr[g, ISKIP]).astype(np.float32))
                        v = logsum(
                            v,
                            ((MB[g + 1, i + 1] + tr[g, IM]).astype(np.float32) + me[g + 1][c]).astype(np.float32),
                        )
                        IB[g, i] = v
                        v = (DB[g + 1, i] + tr[g, DD]).astype(np.float32)
                        v = logsum(
                            v,
                            ((MB[g + 1, i] + me[g + 1][cprev]).astype(np.float32) + tr[g, DM]).astype(np.float32),
                        )
                        DB[g, i] = v
                        csilent[i] = logsum(
                            csilent[i],
                            ((MB[g, i] + m.silent_to_M[f, g]).astype(np.float32) + me[g][cprev]).astype(np.float32),
                        )
                        csilent[i] = logsum(
                            csilent[i],
                            ((IB[g, i] + m.silent_to_I[f, g]).astype(np.float32) + ie[g][cprev]).astype(np.float32),
                        )
                    # segment skip, added once per alternative HMM (:3600)
                    csilent[i] = logsum(csilent[i], (psilent[i] + m.skip).astype(np.float32))

        b_score = silent_b[0, 1].copy()
        return b_score, Mb, Ib, silent_b

    # ---------- forward + max-posterior decoding ----------
    def decode(self, seqs: np.ndarray, L: int, Mb, Ib, b_score: np.ndarray):
        """forward_max_posterior_decoding (barcode_hmm.c:4128-4525)."""
        mb = self.mb
        B = seqs.shape[0]
        nm = mb.num_models
        H_total = mb.total_hmm_num

        Mf: List[np.ndarray] = []
        If: List[np.ndarray] = []
        Df: List[np.ndarray] = []
        silent_f = np.full((nm, L + 2, B), NEG_INF, dtype=np.float32)
        for m in mb.models:
            h, C = m.num_hmms, m.num_cols
            Mf.append(np.full((h, C, L + 1, B), NEG_INF, dtype=np.float32))
            If.append(np.full((h, C, L + 1, B), NEG_INF, dtype=np.float32))
            Df.append(np.full((h, C, L + 1, B), NEG_INF, dtype=np.float32))

        silent_f[0, 0] = _F32(_F32(0.0) + mb.models[0].skip)
        for j in range(1, nm):
            silent_f[j, 0] = (silent_f[j - 1, 0] + mb.models[j].skip).astype(np.float32)

        dyn = np.full((L + 1, H_total, B), NEG_INF, dtype=np.float32)
        total_prob = np.full((H_total, B), NEG_INF, dtype=np.float32)

        prev_silent = np.full((L + 2, B), NEG_INF, dtype=np.float32)
        prev_silent[0] = _F32(0.0)
        # next_silent aliases previous_silent in the reference (:4151-4152);
        # the len+1 entry is set but never read during this forward pass.

        hc = 0
        for j in range(nm):
            m = mb.models[j]
            psilent = prev_silent if j == 0 else silent_f[j - 1]
            csilent = silent_f[j]
            C = m.num_cols
            for f in range(m.num_hmms):
                me = m.m_emit[f]
                ie = m.i_emit[f]
                tr = m.trans[f]
                MF, IF, DF = Mf[j][f], If[j][f], Df[j][f]
                MBb, IBb = Mb[j][f], Ib[j][f]
                for i in range(1, L + 1):
                    c = seqs[:, i - 1]  # seqa[i]
                    # column 0 (:4220-4268)
                    MF[0, i] = ((psilent[i - 1] + m.silent_to_M[f, 0]).astype(np.float32) + me[0][c]).astype(np.float32)
                    post = ((MF[0, i] + MBb[0, i]).astype(np.float32) - b_score).astype(np.float32)
                    total_prob[hc] = logsum(total_prob[hc], post)
                    dyn[i, hc] = logsum(dyn[i, hc], post)
                    v = (psilent[i - 1] + m.silent_to_I[f, 0]).astype(np.float32)
                    v = logsum(v, (IF[0, i - 1] + tr[0, II]).astype(np.float32))
                    v = logsum(v, (MF[0, i - 1] + tr[0, MI]).astype(np.float32))
                    IF[0, i] = (v + ie[0][c]).astype(np.float32)
                    tpost = (
                        (((psilent[i - 1] + m.silent_to_I[f, 0]).astype(np.float32) + ie[0][c]).astype(np.float32)
                         + IBb[0, i]).astype(np.float32)
                        - b_score
                    ).astype(np.float32)
                    total_prob[hc] = logsum(total_prob[hc], tpost)
                    dyn[i, hc] = logsum(
                        dyn[i, hc], ((IF[0, i] + IBb[0, i]).astype(np.float32) - b_score).astype(np.float32)
                    )
                    DF[0, i] = NEG_INF
                    csilent[i] = logsum(csilent[i], (MF[0, i] + tr[0, MSKIP]).astype(np.float32))
                    csilent[i] = logsum(csilent[i], (IF[0, i] + tr[0, ISKIP]).astype(np.float32))
                    # interior columns (:4271-4334)
                    for g in range(1, C):
                        v = (psilent[i - 1] + m.silent_to_M[f, g]).astype(np.float32)
                        v = logsum(v, (MF[g - 1, i - 1] + tr[g - 1, MM]).astype(np.float32))
                        v = logsum(v, (IF[g - 1, i - 1] + tr[g - 1, IM]).astype(np.float32))
                        v = logsum(v, (DF[g - 1, i] + tr[g - 1, DM]).astype(np.float32))
                        MF[g, i] = (v + me[g][c]).astype(np.float32)
                        dyn[i, hc] = logsum(
                            dyn[i, hc], ((MF[g, i] + MBb[g, i]).astype(np.float32) - b_score).astype(np.float32)
                        )
                        v = (psilent[i - 1] + m.silent_to_I[f, g]).astype(np.float32)
                        v = logsum(v, (IF[g, i - 1] + tr[g, II]).astype(np.float32))
                        v = logsum(v, (MF[g, i - 1] + tr[g, MI]).astype(np.float32))
                        IF[g, i] = (v + ie[g][c]).astype(np.float32)
                        dyn[i, hc] = logsum(
                            dyn[i, hc], ((IF[g, i] + IBb[g, i]).astype(np.float32) - b_score).astype(np.float32)
                        )
                        v = (MF[g - 1, i] + tr[g - 1, MD]).astype(np.float32)
                        v = logsum(v, (DF[g - 1, i] + tr[g - 1, DD]).astype(np.float32))
                        DF[g, i] = v
                        csilent[i] = logsum(csilent[i], (MF[g, i] + tr[g, MSKIP]).astype(np.float32))
                        csilent[i] = logsum(csilent[i], (IF[g, i] + tr[g, ISKIP]).astype(np.float32))
                    csilent[i] = logsum(csilent[i], (psilent[i] + m.skip).astype(np.float32))
                hc += 1

        f_score = silent_f[nm - 1, L].copy()

        # ---- barcode probability (:4354-4429) ----
        hc = 0
        for j in range(nm):
            m = mb.models[j]
            if m.num_hmms > 1:
                g0 = hc
                ns1 = np.full(B, NEG_INF, dtype=np.float32)
                for f in range(m.num_hmms):
                    ns1 = logsum(ns1, total_prob[hc])
                    hc += 1
                for f in range(m.num_hmms):
                    total_prob[g0] = (total_prob[g0] - ns1).astype(np.float32)
                    g0 += 1
            else:
                hc += m.num_hmms

        hc = 0
        g_flag = 1
        ns0 = np.full(B, NEG_INF, dtype=np.float32)
        ns2 = np.full(B, _F32(0.0), dtype=np.float32)
        for j in range(nm):
            m = mb.models[j]
            if m.num_hmms > 1:
                g_flag = 0
                ns1 = np.full(B, NEG_INF, dtype=np.float32)
                for f in range(m.num_hmms):
                    if f != m.num_hmms - 1:
                        ns0 = np.where(total_prob[hc] > ns0, total_prob[hc], ns0)
                    ns1 = logsum(ns1, total_prob[hc])
                    hc += 1
                ns0 = (ns0 - ns1).astype(np.float32)
                ns2 = (ns2 + ns0).astype(np.float32)
            else:
                hc += m.num_hmms
        if g_flag:
            bar_prob = np.full(B, _F32(0.0), dtype=np.float32)
        else:
            bar_prob = np.where(ns2 > 0, _F32(0.0), ns2).astype(np.float32)

        # ---- optimal-accuracy label DP in probability space (:4431-4514) ----
        dynp = sp2p_arr(dyn)
        path = np.full((L + 1, H_total, B), -1, dtype=np.int32)
        tmat = mb.tmatrix
        for i in range(1, L + 1):
            prev = dynp[i - 1]
            cur = dynp[i]
            for jlab in range(H_total):
                mx = np.full(B, _F32(-1.0), dtype=np.float32)
                mv = np.full(B, -1, dtype=np.int32)
                for c in range(jlab + 1):
                    tmp = (prev[c] * tmat[c, jlab]).astype(np.float32)
                    gt = tmp > mx
                    mv = np.where(gt, c, mv)
                    mx = np.where(gt, tmp, mx)
                    if c == jlab:
                        eq = tmp == mx
                        mv = np.where(eq, c, mv)
                cur[jlab] = (cur[jlab] + mx).astype(np.float32)
                path[i, jlab] = mv

        labels = np.zeros((B, L + 1), dtype=np.int32)
        mx = np.full(B, _F32(-1.0), dtype=np.float32)
        mv = np.zeros(B, dtype=np.int32)
        for jlab in range(H_total):
            gt = dynp[L, jlab] > mx
            mv = np.where(gt, jlab, mv)
            mx = np.where(gt, dynp[L, jlab], mx)
        labels[:, L] = mv
        move = mv
        bidx = np.arange(B)
        for i in range(L, 0, -1):
            move = path[i][move, bidx]
            labels[:, i - 1] = move

        # ---- random model score (:4516-4523) ----
        bg = mb.models[0].background  # f32[5]
        per_base = p2sp(1.0 - (1.0 / float(_F32(mb.average_raw_length))))
        r_score = np.full(B, _F32(0.0), dtype=np.float32)
        for i in range(1, L + 1):
            c = seqs[:, i - 1]
            r_score = ((r_score + bg[c]).astype(np.float32) + per_base).astype(np.float32)
        r_score = (r_score + p2sp(1.0 / float(_F32(mb.average_raw_length)))).astype(
            np.float32
        )

        return f_score, bar_prob, labels, r_score

    def run_batch(self, seqs: np.ndarray, L: int) -> BatchResult:
        """backward + forward_max_posterior_decoding for same-length reads.

        ``seqs``: uint8 [B, L+1] with seqs[:, L] == 0 (terminator read by the
        backward pass, see module docstring)."""
        if self.flat is not None:
            f, b, r, bar, labels = self.flat.score_batch(seqs, L, mode=0)
            return BatchResult(
                f_score=f, b_score=b, r_score=r, bar_prob=bar, labels=labels
            )
        b_score, Mb, Ib, _sb = self.backward(seqs, L)
        f_score, bar_prob, labels, r_score = self.decode(seqs, L, Mb, Ib, b_score)
        return BatchResult(
            f_score=f_score,
            b_score=b_score,
            r_score=r_score,
            bar_prob=bar_prob,
            labels=labels,
        )

    def backward_only(self, seqs: np.ndarray, L: int) -> np.ndarray:
        """b_score only (arch auto-detection, MODE_ARCH_COMP)."""
        if self.flat is not None:
            return self.flat.score_batch(seqs, L, mode=1)[1]
        b_score, _, _, _ = self.backward(seqs, L)
        return b_score
