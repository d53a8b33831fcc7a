"""Confidence-threshold calibration by scoring model-emitted reads.

Re-implements ``estimateQthreshold`` (``calibrateQ.c:17-235``): when ``-Q``
is not given, simulate ``num_test`` reads — half sampled generatively from
the architecture HMM itself (``emit_read_sequence``,
``barcode_hmm.c:2696-3046``; with the null-N barcode prior zeroed first,
``calibrateQ.c:70-86``), half from the background random model
(``emit_random_sequence``, ``barcode_hmm.c:2599-2680``) — score all of them
with the engine, sort by Q and sweep for the threshold maximising
sensitivity+specificity (also computing FDR and Cohen's-kappa thresholds),
capped at 20 (``calibrateQ.c:150-212``).

Reference quirks reproduced:
* calibration force-sets the sequencer error rate to 0.05 and leaves it set
  (``calibrateQ.c:65``, ``:117``) — subsequent model builds in the same run
  therefore always use e=0.05;
* each ``emit_*_sequence`` call burns one rand() on entry, and the rejection
  loops reuse the last draw exactly as the C code does;
* the mapq sort is stable (glibc qsort is mergesort), matching the sweep's
  tie behaviour.
"""

from __future__ import annotations

import os
import time
from typing import List

import numpy as np

from .constants import DD, DM, II, IM, ISKIP, MD, MI, MM, MSKIP
from .logsum import NEG_INF, logsum, p2sp, sp2p
from .model import ModelBag, init_model_bag
from .rng import CRand
from .spans import span

_F32 = np.float32


def emit_random_sequence(mb: ModelBag, rng: CRand, average_length: int) -> np.ndarray:
    """barcode_hmm.c:2599-2680 (draw-for-draw identical)."""
    bg = mb.models[0].background
    r = float(rng.randf())
    seq: List[int] = []
    cont = 1.0 - (1.0 / float(_F32(average_length)))
    while len(seq) < average_length:
        while True:
            s = NEG_INF
            for nuc in range(5):
                s = logsum(s, bg[nuc])
                if r < float(sp2p(s)):
                    seq.append(nuc)
                    break
            r = float(rng.randf())
            if r > cont:
                break
        if len(seq) < average_length:
            seq.clear()
    return np.array(seq, dtype=np.uint8)


def emit_read_sequence(mb: ModelBag, rng: CRand, average_length: int) -> np.ndarray:
    """barcode_hmm.c:2696-3046 (draw-for-draw identical)."""
    rng.randf()  # entry draw, value unused (:2721)
    seq: List[int] = []
    nm = mb.num_models
    while len(seq) < average_length:
        state = 0
        column = 0
        hmm = 0
        segment = 0
        while True:
            r = float(rng.randf())
            if state == 0:
                m = mb.models[segment]
                ln = m.num_cols
                s = NEG_INF
                done = False
                for i in range(m.num_hmms):
                    for j in range(ln):
                        s = logsum(s, m.silent_to_M[i, j])
                        if r < float(sp2p(s)):
                            state, column, hmm = 1, j, i
                            done = True
                            break
                        s = logsum(s, m.silent_to_I[i, j])
                        if r < float(sp2p(s)):
                            state, column, hmm = 2, j, i
                            done = True
                            break
                    if done:
                        break
            elif state == 1:
                tr = mb.models[segment].trans[hmm, column]
                s = logsum(NEG_INF, tr[MM])
                if r < float(sp2p(s)):
                    state = 1
                    column += 1
                else:
                    s = logsum(s, tr[MI])
                    if r < float(sp2p(s)):
                        state = 2
                    else:
                        s = logsum(s, tr[MD])
                        if r < float(sp2p(s)):
                            state = 3
                            column += 1
                        else:
                            state = 0
                            segment += 1
                            column = 0
                            hmm = 0
            elif state == 2:
                tr = mb.models[segment].trans[hmm, column]
                s = logsum(NEG_INF, tr[II])
                if r < float(sp2p(s)):
                    state = 2
                else:
                    s = logsum(s, tr[IM])
                    if r < float(sp2p(s)):
                        state = 1
                        column += 1
                    else:
                        state = 0
                        segment += 1
                        column = 0
                        hmm = 0
            elif state == 3:
                tr = mb.models[segment].trans[hmm, column]
                s = logsum(NEG_INF, tr[DD])
                if r < float(sp2p(s)):
                    state = 3
                    column += 1
                else:
                    state = 1
                    column += 1

            # emission draw happens every iteration (:2939)
            r = float(rng.randf())
            if state == 1:
                em = mb.models[segment].m_emit[hmm, column]
                s = NEG_INF
                for nuc in range(5):
                    s = logsum(s, em[nuc])
                    if r < float(sp2p(s)):
                        seq.append(nuc)
                        break
            elif state == 2:
                em = mb.models[segment].i_emit[hmm, column]
                s = NEG_INF
                for nuc in range(5):
                    s = logsum(s, em[nuc])
                    if r < float(sp2p(s)):
                        seq.append(nuc)
                        break
            if segment == nm:
                break
        if len(seq) < average_length:
            seq.clear()
    return np.array(seq, dtype=np.uint8)


def estimate_q_threshold(param, rs, ssi, run_get_prob) -> float:
    """Full calibration; ``run_get_prob(mb, seqs_list) -> mapq array``.

    Mutates ``param.sequencer_error_rate`` to 0.05 (reference behaviour) and
    possibly ``ssi.max_seq_len``.  Returns the chosen threshold.
    """
    rng = CRand()
    seed = param.seed if param.seed else int(time.time() * 42) & 0xFFFFFFFF
    rng.srand(seed)

    num_test = 4000 if param.rtest else 400000
    binsize = num_test // 4

    param.sequencer_error_rate = float(_F32(0.05))  # calibrateQ.c:65
    mb = init_model_bag(rs, ssi, param.sequencer_error_rate, param.indel_frequency)

    # zero the null-N prior for B and S segments (calibrateQ.c:70-86)
    for i, m in enumerate(mb.models):
        if rs.types[i] in ("B", "S"):
            for j in range(m.num_hmms - 1):
                m.silent_to_M[j, 0] = p2sp(1.0 / float(_F32(m.num_hmms - 1)))
            m.silent_to_M[m.num_hmms - 1, 0] = NEG_INF

    avg_len = int(ssi.average_length)
    # parallel arrays instead of 400k EmittedRead objects: seqs (list of
    # code arrays) + rt (read_type per seq) — the sweep and the scorer
    # both consume arrays, so no per-read Python objects exist at all
    seqs: List[np.ndarray] = []
    with span("calibration.emit"):
        flat = None
        if os.environ.get("TAGDUST_TPU_NO_NATIVE") != "1":
            try:
                from .engine.native import FlatModel

                flat = FlatModel(mb)
            except Exception as e:  # noqa: BLE001 — loud downgrade, strict re-raise
                from .strict import fallback

                fallback(
                    "native-emitters",
                    e,
                    "native C++ read emitters unavailable; calibration emits "
                    "reads in pure Python (much slower)",
                )
                flat = None
        if flat is not None:
            # one native call per 32k-read slab (FlatModel._emit_batch) — the
            # per-read ctypes round trips used to cost ~24s of every
            # default-flag run; the LCG draw order is identical
            state = int(rng.next)
            state, model_seqs = flat.emit_read_batch(state, avg_len, binsize * 2)
            seqs.extend(model_seqs)
            n_model = len(seqs)
            state, rand_seqs = flat.emit_random_batch(
                state, avg_len, min(binsize * 2, num_test - len(seqs))
            )
            seqs.extend(rand_seqs)
            rng.next = np.uint32(state)
        else:
            for _ in range(binsize * 2):
                seqs.append(emit_read_sequence(mb, rng, avg_len))
            n_model = len(seqs)
            for _ in range(binsize * 2):
                seqs.append(emit_random_sequence(mb, rng, avg_len))
                if len(seqs) == num_test:
                    break
    rt = np.zeros(len(seqs), dtype=np.float64)
    rt[n_model:] = 1.0  # 1 = random-model read

    TN = float(len(seqs) - n_model)
    FN = float(n_model)

    # rebuild a clean model; grow if emitted sequences exceed max_seq_len
    # (calibrateQ.c:115-134)
    max_emitted = max((s.shape[0] for s in seqs), default=0)
    if max_emitted >= ssi.max_seq_len:
        ssi.max_seq_len = max_emitted
    mb = init_model_bag(rs, ssi, param.sequencer_error_rate, param.indel_frequency)

    with span("calibration.score"):
        mapq = np.asarray(run_get_prob(mb, seqs), dtype=np.float64)

    with span("calibration.sweep"):
        return _sweep(mapq, rt, TN, FN)


def _sweep(mapq: np.ndarray, rt: np.ndarray, TN: float, FN: float) -> float:
    """The threshold from the emitted reads' Q (``mapq``) and their kind
    (``rt``: 1.0 a random-model read), as ``estimate_q_threshold`` returns
    it."""
    order = np.argsort(-mapq, kind="stable")

    # vectorised sweep (calibrateQ.c:150-212).  The loop state is pure
    # cumulative counting, so TP/FP/TN/FN become exact-integer float64
    # cumsums and every per-step expression is evaluated element-wise with
    # the same operation order as the scalar loop — results are
    # bit-identical (the RTEST gold thresholds pin this), and the 400k-step
    # Python loop (~2 s of every default-flag run) disappears.
    readnum = len(mapq)
    rt_s = rt[order]
    mq = mapq[order]
    FPv = np.cumsum(rt_s)
    TPv = np.cumsum(1.0 - rt_s)
    TNv = TN - FPv
    FNv = FN - TPv
    with np.errstate(divide="ignore", invalid="ignore"):
        sens = np.where(TPv + FNv != 0.0, TPv / (TPv + FNv), 0.0)
        spec = np.where(TNv + FPv != 0.0, TNv / (TNv + FPv), 0.0)
        fdr = FPv / (FPv + TPv)  # FP+TP >= 1 after the first step
        P_e = ((TPv + FNv) / readnum) * ((TPv + FPv) / readnum) + (
            ((FPv + TNv) / readnum) * ((FNv + TNv) / readnum)
        )
        P_o = (TPv + TNv) / readnum
        tmp = (P_o - P_e) / (1.0 - P_e)

    thres = [1000.0, 1000.0, 1000.0, 0.0, 1000.0, 1000.0]
    m0 = fdr < 0.01
    m1 = ~m0 & (fdr < 0.05)
    m2 = ~m0 & ~(fdr < 0.05) & (fdr < 0.1)
    for k, m in ((0, m0), (1, m1), (2, m2)):
        nz = np.nonzero(m)[0]
        if nz.size:
            thres[k] = float(mq[nz[-1]])  # LAST step satisfying the branch
    ss = sens + spec
    # the scalar loop updates on strict '>', so the final value corresponds
    # to the FIRST step attaining the global max — np.argmax's tie rule
    i4 = int(np.argmax(ss))
    thres[3] = float(spec[i4] + sens[i4])
    thres[4] = float(mq[i4])
    i5 = int(np.argmax(tmp))
    if float(tmp[i5]) > 0.0:
        thres[5] = float(mq[i5])

    if thres[4] < 20:
        return float(_F32(thres[4]))
    return 20.0
