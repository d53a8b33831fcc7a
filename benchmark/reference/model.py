"""Architecture -> profile-HMM compiler producing dense parameter tensors.

This is the TPU-native counterpart of the reference model builder
(``init_model_bag``, ``barcode_hmm.c:5760-6011``;
``init_model_according_to_read_structure``, ``:4689-5084``;
``set_hmm_transition_parameters``, ``:1710-1881``).  Instead of linked
per-column structs it emits, per segment, dense float32 arrays

    trans[num_hmms, num_cols, 9]      (MM MI MD II IM DD DM MSKIP ISKIP)
    m_emit / i_emit[num_hmms, num_cols, 5]
    silent_to_M / silent_to_I[num_hmms, num_cols]
    skip                               (scalar)

plus the whole-architecture label table (``label[c] = (hmm<<16)|segment`` with
bit 31 marking skippable segments, ``:5954-5965``) and the upper-triangular
label-compatibility matrix used by the max-posterior label DP (``:5969-6006``).

Every arithmetic step reproduces the reference's float32 rounding:
``prob2scaledprob`` narrows through float32, sums of log-terms are float32
additions in the same association order, and the float32 table-logsum is used
where the reference accumulates with ``logsum()``.  This makes the compiled
tensors bit-identical to the C model and is what the deterministic engine
(and the RTEST golden tests) build on.  The TPU engine consumes the same
tensors (converted to a state-flat layout in `engine/lattice.py`).

Segment-type semantics (segment grammar, ``interface.c:503-516`` and manual):
R = read (insert-only, geometric length), B = barcode set (+null-N alt),
F = fingerprint/UMI, S = spacer (+null-N alt), P = partial 5'/3'/internal
linker (Gaussian length model), O = optional nt run, G = CAGE G-addition.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

import numpy as np

from .arch import ReadStructure
from .constants import DD, DM, II, IM, ISKIP, MD, MI, MM, MSKIP, NUC_CODE
from .logsum import NEG_INF, logsum, p2sp, sp2p
from .stats import SequenceStats

INV_SQRT_2PI = 0.3989422804014327  # misc.h:78

_F32 = np.float32


def gaussian_pdf(x: float, m: float, s: float) -> float:
    """misc.c:375-379, double precision."""
    a = (x - m) / s
    return INV_SQRT_2PI / s * math.exp(-0.5 * a * a)


def _fadd(*terms) -> np.float32:
    """Left-associated float32 addition chain (C float `+`)."""
    acc = _F32(terms[0])
    for t in terms[1:]:
        acc = _F32(acc + _F32(t))
    return acc


@dataclass
class SegmentModel:
    type: str
    seqs: List[str]
    trans: np.ndarray  # [H, C, 9] f32
    m_emit: np.ndarray  # [H, C, 5] f32
    i_emit: np.ndarray  # [H, C, 5] f32
    silent_to_M: np.ndarray  # [H, C] f32
    silent_to_I: np.ndarray  # [H, C] f32
    skip: np.float32
    background: np.ndarray  # [5] f32

    @property
    def num_hmms(self) -> int:
        return self.trans.shape[0]

    @property
    def num_cols(self) -> int:
        return self.trans.shape[1]


@dataclass
class ModelBag:
    models: List[SegmentModel]
    label: np.ndarray  # int64 [total_hmm_num]
    tmatrix: np.ndarray  # f32 [H+1, H+1] 0/1
    total_hmm_num: int
    average_raw_length: int
    current_dyn_length: int
    model_multiplier: np.float32
    rs: ReadStructure = None
    ssi: SequenceStats = None

    @property
    def num_models(self) -> int:
        return len(self.models)

    def digest(self) -> str:
        """Content hash over every parameter tensor: two ModelBags with equal
        digests compile to identical engines, so compiled engines (and their
        jitted device programs) are shared across controller invocations in
        one process instead of being rebuilt per run."""
        import hashlib

        h = hashlib.sha256()
        for m in self.models:
            h.update(m.type.encode())
            for s in m.seqs:
                h.update(s.encode() + b"\0")
            for arr in (m.trans, m.m_emit, m.i_emit, m.silent_to_M,
                        m.silent_to_I, m.background):
                h.update(np.ascontiguousarray(arr).tobytes())
            h.update(np.float32(m.skip).tobytes())
        h.update(np.ascontiguousarray(self.label).tobytes())
        h.update(np.ascontiguousarray(self.tmatrix).tobytes())
        h.update(
            f"{self.total_hmm_num}:{self.average_raw_length}:"
            f"{self.current_dyn_length}:{float(self.model_multiplier)}".encode()
        )
        return h.hexdigest()


def set_hmm_transition_parameters(
    trans: np.ndarray,
    length: int,
    base_error: float,
    indel_freq: float,
    mean: float,
    stdev: float,
) -> None:
    """Fill ``trans[col, 9]`` for one HMM, mirroring barcode_hmm.c:1710-1881.

    mean/stdev select the column-exit (MSKIP) model: (-1,-1) = no internal
    exits, (m,-1) = constant m/(len-1), (m,s) = Gaussian length distribution.
    """
    sum_prob = 0.0
    if mean > 0.0 and stdev > 0.0:
        for i in range(length + 1):
            sum_prob += gaussian_pdf(i, mean, stdev)

    def mskip_for(x: float) -> np.float32:
        if mean == -1.0 and stdev == -1.0:
            return p2sp(0.0)
        if mean > -1.0 and stdev == -1.0:
            return p2sp(mean / float(_F32(length - 1)))
        return p2sp(gaussian_pdf(x, mean, stdev) / sum_prob)

    if length == 1:
        trans[0, :] = NEG_INF
        trans[0, MSKIP] = p2sp(1.0)
        return

    if length == 2:
        msk = mskip_for(0.0)
        rest = p2sp(1.0 - float(sp2p(msk)))
        trans[0, MSKIP] = msk
        trans[0, MM] = _fadd(p2sp(1.0 - base_error * indel_freq), rest)
        trans[0, MI] = _fadd(p2sp(base_error * indel_freq), rest)
        trans[0, MD] = _fadd(p2sp(base_error * indel_freq * 0.0), rest)
        trans[0, II] = p2sp(1.0 - 0.999)
        trans[0, IM] = p2sp(0.999)
        trans[0, ISKIP] = NEG_INF
        trans[0, DD] = NEG_INF
        trans[0, DM] = NEG_INF
        trans[1, :] = NEG_INF
        trans[1, MSKIP] = p2sp(1.0)
        return

    # length >= 3 (barcode_hmm.c:1784-1879)
    def fill_col(col: int, x: float, mi_f: float, md_f: float, dd, dm) -> None:
        msk = mskip_for(x)
        rest = p2sp(1.0 - float(sp2p(msk)))
        trans[col, MSKIP] = msk
        trans[col, MM] = _fadd(p2sp(1.0 - base_error * indel_freq), rest)
        trans[col, MI] = _fadd(p2sp(base_error * indel_freq * mi_f), rest)
        trans[col, MD] = _fadd(p2sp(base_error * indel_freq * md_f), rest)
        trans[col, II] = p2sp(1.0 - 0.999)
        trans[col, IM] = p2sp(0.999)
        trans[col, ISKIP] = NEG_INF
        trans[col, DD] = dd
        trans[col, DM] = dm

    fill_col(0, 0.0, 0.5, 0.5, NEG_INF, NEG_INF)
    for i in range(1, length - 2):
        fill_col(i, float(i), 0.5, 0.5, p2sp(1.0 - 0.999), p2sp(0.999))
    # second-last column: x = length-1.0 (sic, barcode_hmm.c:1848)
    fill_col(length - 2, length - 1.0, 1.0, 0.0, NEG_INF, p2sp(1.0))
    trans[length - 1, :] = NEG_INF
    trans[length - 1, MSKIP] = p2sp(1.0)


def init_segment_model(
    rs: ReadStructure,
    key: int,
    background: List[float],
    base_error: float,
    indel_freq: float,
    assumed_length: int,
    dyn_length: int,
) -> SegmentModel:
    """Mirror of init_model_according_to_read_structure (barcode_hmm.c:4689)."""
    del dyn_length  # DP scratch is owned by the engines, not the model
    H = rs.numseq_in_segment(key)
    C = rs.seg_len(key)
    t = rs.types[key]
    bg = np.array([_F32(b) for b in background], dtype=np.float32)

    trans = np.full((H, C, 9), NEG_INF, dtype=np.float32)
    m_emit = np.zeros((H, C, 5), dtype=np.float32)
    i_emit = np.zeros((H, C, 5), dtype=np.float32)
    s2M = np.full((H, C), NEG_INF, dtype=np.float32)
    s2I = np.full((H, C), NEG_INF, dtype=np.float32)

    for h in range(H):
        tmp = rs.seqs[key][h]
        for j in range(C):
            cur = int(NUC_CODE[ord(tmp[j])])
            if cur < 4:
                for c in range(4):
                    if c == cur:
                        m_emit[h, j, c] = p2sp(
                            1.0
                            - float(sp2p(_F32(background[4])))
                            - base_error * (1.0 - indel_freq)
                        )
                    else:
                        m_emit[h, j, c] = p2sp(base_error * (1.0 - indel_freq) / 3.0)
                    i_emit[h, j, c] = _F32(background[c])
                m_emit[h, j, 4] = _F32(background[4])
                i_emit[h, j, 4] = _F32(background[4])
            elif cur == 4:
                for c in range(5):
                    m_emit[h, j, c] = _F32(background[c])
                    i_emit[h, j, c] = _F32(background[c])
            else:  # '.' -> certain N (barcode_hmm.c:4748-4760)
                for c in range(5):
                    m_emit[h, j, c] = p2sp(1.0) if c == 4 else NEG_INF
                    i_emit[h, j, c] = _F32(background[c])
        set_hmm_transition_parameters(trans[h], C, base_error, indel_freq, -1.0, -1.0)

    skip = p2sp(0.0)

    if t in ("B", "S"):
        for h in range(H):
            s2M[h, 0] = p2sp(1.0 / float(_F32(H)))
            s2I[h, 0] = NEG_INF
        skip = p2sp(0.0)
    elif t == "F":
        for h in range(H):
            s2M[h, 0] = p2sp(1.0 / float(_F32(H)))
        skip = p2sp(0.0)
    elif t == "P":
        for h in range(H):
            s2M[h, 0] = _fadd(p2sp(1.0 / float(_F32(H))), p2sp(1.0 - 0.01))
            for j in range(C):
                rest99 = p2sp(float(_F32(0.99)))
                trans[h, j, MM] = _fadd(p2sp(1.0 - base_error * indel_freq), rest99)
                trans[h, j, MI] = _fadd(
                    p2sp(base_error * indel_freq), p2sp(0.5), rest99
                )
                trans[h, j, MD] = _fadd(
                    p2sp(base_error * indel_freq), p2sp(0.5), rest99
                )
                trans[h, j, MSKIP] = p2sp(float(_F32(0.01)))
                trans[h, j, II] = _fadd(p2sp(1.0 - 0.999), rest99)
                trans[h, j, IM] = _fadd(p2sp(0.999), rest99)
                trans[h, j, ISKIP] = p2sp(float(_F32(0.01)))
                # DD/DM keep the set_hmm_transition_parameters values
        skip = p2sp(0.01)
    elif t == "O":
        for h in range(H):
            s2I[h, 0] = _fadd(p2sp(1.0 / float(_F32(H))), p2sp(0.5))
            for j in range(C):
                i_emit[h, j, :] = m_emit[h, j, :]
                m_emit[h, j, :] = NEG_INF
        skip = p2sp(0.5)
        trans[0, 0, :] = NEG_INF
        trans[0, 0, II] = p2sp(1.0 - 1.0 / float(_F32(C + 1)))
        trans[0, 0, ISKIP] = p2sp(1.0 / float(_F32(C + 1)))
    elif t == "G":
        for h in range(H):
            s2I[h, 0] = p2sp(0.8935878)
            for j in range(C):
                i_emit[h, j, :] = m_emit[h, j, :]
                m_emit[h, j, :] = NEG_INF
        skip = p2sp(1.0 - 0.8935878)
        # only MM/MI/MD/II/IM/DD/DM rewritten; MSKIP and ISKIP keep the
        # set_hmm defaults (barcode_hmm.c:5017-5039)
        for idx in (MM, MI, MD, IM, DD, DM):
            trans[0, 0, idx] = NEG_INF
        trans[0, 0, II] = p2sp(0.195)
    elif t == "R":
        for h in range(H):
            s2I[h, 0] = p2sp(1.0 / float(_F32(H)))
        for c in range(5):
            m_emit[0, 0, c] = _F32(background[c])
            i_emit[0, 0, c] = _F32(background[c])
        trans[0, 0, :] = NEG_INF
        trans[0, 0, II] = p2sp(1.0 - 1.0 / float(_F32(assumed_length)))
        trans[0, 0, ISKIP] = p2sp(1.0 / float(_F32(assumed_length)))
        skip = p2sp(0.0)

    return SegmentModel(
        type=t,
        seqs=rs.seqs[key],
        trans=trans,
        m_emit=m_emit,
        i_emit=i_emit,
        silent_to_M=s2M,
        silent_to_I=s2I,
        skip=np.float32(skip),
        background=bg,
    )


def init_model_bag(
    rs: ReadStructure,
    ssi: SequenceStats,
    sequencer_error_rate: float,
    indel_frequency: float,
) -> ModelBag:
    """Mirror of init_model_bag (barcode_hmm.c:5760-6011)."""
    base_error = float(_F32(sequencer_error_rate))
    indel_freq = float(_F32(indel_frequency))

    # expected R-segment length (barcode_hmm.c:5788-5810)
    read_length = int(ssi.average_length)
    for i in range(rs.num_segments):
        t = rs.types[i]
        if t == "G":
            read_length -= 2
        elif t == "R":
            pass
        elif t == "P":
            read_length -= len(rs.seqs[i][0]) // 2
        else:
            read_length -= len(rs.seqs[i][0])
    if read_length < 20:
        read_length = 20

    dyn_length = ssi.max_seq_len + 10
    models: List[SegmentModel] = []
    for i in range(rs.num_segments):
        seg_len = 2 if rs.types[i] == "G" else (read_length if rs.types[i] == "R" else 0)
        models.append(
            init_segment_model(
                rs, i, ssi.background, base_error, indel_freq, seg_len, dyn_length
            )
        )

    # 5' partial-segment Gaussian entry profile (barcode_hmm.c:5841-5904)
    if ssi.expected_5_len:
        mp = models[0]
        E5 = int(ssi.expected_5_len)
        sum_prob = p2sp(0.0)
        for h in range(mp.num_hmms):
            for j in range(E5):
                mp.silent_to_M[h, j] = _fadd(
                    p2sp(1.0 / float(_F32(mp.num_hmms))),
                    p2sp(gaussian_pdf(j, ssi.expected_5_len - ssi.mean_5_len, ssi.stdev_5_len)),
                )
                sum_prob = logsum(sum_prob, mp.silent_to_M[h, j])
            set_hmm_transition_parameters(
                mp.trans[h], E5, base_error, indel_freq, -1.0, -1.0
            )
        mp.skip = p2sp(
            gaussian_pdf(ssi.expected_5_len, ssi.mean_5_len - ssi.expected_5_len, ssi.stdev_5_len)
        )
        sum_prob = logsum(sum_prob, mp.skip)
        for h in range(mp.num_hmms):
            for j in range(E5):
                mp.silent_to_M[h, j] = _F32(mp.silent_to_M[h, j] - sum_prob)
        mp.skip = np.float32(_F32(mp.skip - sum_prob))

    # 3' partial segment (barcode_hmm.c:5907-5920)
    if ssi.expected_3_len:
        mp = models[-1]
        E3 = int(ssi.expected_3_len)
        sum_prob = 0.0
        for i in range(E3):
            sum_prob += gaussian_pdf(i, ssi.mean_3_len, ssi.stdev_3_len)
        g0 = gaussian_pdf(0, ssi.mean_3_len, ssi.stdev_3_len)
        mp.skip = np.float32(p2sp(g0 / sum_prob))
        for h in range(mp.num_hmms):
            mp.silent_to_M[h, 0] = _fadd(
                p2sp(1.0 / float(_F32(mp.num_hmms))), p2sp(1.0 - g0 / sum_prob)
            )
            set_hmm_transition_parameters(
                mp.trans[h], E3, base_error, indel_freq, ssi.mean_3_len, ssi.stdev_3_len
            )

    # internal P segments: constant-exit model (barcode_hmm.c:5922-5932)
    for c in range(1, len(models) - 1):
        if rs.types[c] == "P":
            mp = models[c]
            for h in range(mp.num_hmms):
                set_hmm_transition_parameters(
                    mp.trans[h], mp.num_cols, base_error, indel_freq, 0.1, -1.0
                )

    # labels + model multiplier (barcode_hmm.c:5952-5967)
    labels = []
    multiplier = _F32(1.0)
    for i, m in enumerate(models):
        multiplier = _F32(multiplier * _F32(m.num_hmms))
        for j in range(m.num_hmms):
            lab = (j << 16) | i
            if m.skip != p2sp(0.0):
                lab |= 0x80000000
            labels.append(lab)
    label = np.array(labels, dtype=np.int64)
    H = len(labels)

    # label-compatibility matrix (barcode_hmm.c:5969-6006)
    tmatrix = np.zeros((H + 1, H + 1), dtype=np.float32)
    for i in range(H):
        c = 1
        for j in range(i + 1, H):
            if (label[i] & 0xFFFF) + 1 == (label[j] & 0xFFFF):
                tmatrix[i, j] = 1
            if ((label[i] & 0xFFFF) < (label[j] & 0xFFFF)) and c:
                tmatrix[i, j] = 1
            if not (label[j] & 0x80000000):
                c = 0
        tmatrix[i, i] = 1

    return ModelBag(
        models=models,
        label=label,
        tmatrix=tmatrix,
        total_hmm_num=H,
        average_raw_length=int(ssi.average_length),
        current_dyn_length=dyn_length,
        model_multiplier=np.float32(p2sp(float(multiplier))),
        rs=rs,
        ssi=ssi,
    )
