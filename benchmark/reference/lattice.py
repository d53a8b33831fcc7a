"""Closure compiler: profile-HMM -> dense per-base transition matrices.

This is the TPU-first reformulation of the reference DP.  The reference
recurrence (``barcode_hmm.c:3655-3816``) walks a sparse lattice of
M/I/D/silent states per position with scalar log-space ops — ideal for a
CPU, hostile to a systolic array.  Here all *non-emitting* states (delete
chains within a step, the silent segment chain) are eliminated by transitive
closure on the host (float64), leaving only emitting M/I states plus a
virtual BEGIN state.  One DP step then becomes a dense linear-space matrix
product

    v[i] = v[i-1] @ A[c_i]          (A: [5, S, S], one matrix per base)

which maps straight onto the MXU, with per-step rescaling for range.  The
backward pass uses the transposed matrices, the posterior is the elementwise
product, and the observable outputs (f_score, per-position label posteriors,
barcode probability, Q) match the reference math including its structural
quirks:

* the segment-skip mass is multiplied by the number of alternative HMMs in
  the segment (the reference adds the skip term once per alternative,
  ``barcode_hmm.c:3788``);
* the initial silent chain uses plain skip products (``:3699-3705``);
* the barcode probability uses *entry-only* posteriors of column-0 states
  (``:4229``, ``:4254``) normalised per segment.

The only reference behaviour intentionally not carried over is the
read-past-the-end terminator artifact of its backward pass
(``barcode_hmm.c:3512-3516``); it perturbs b_score by a vanishing amount and
does not change decisions (asserted by tests).  Bit-exact replication lives
in `engine/exact`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .constants import DD, DM, II, IM, ISKIP, MD, MI, MM, MSKIP
from .model import ModelBag


def _lin(x) -> np.ndarray:
    """log-space float32 parameters -> linear-space float64."""
    return np.exp(np.asarray(x, dtype=np.float64))


@dataclass
class Lattice:
    A: np.ndarray  # [5, S, S] f32 — per-base step matrices (src, dst)
    Aent: np.ndarray  # [5, S, K] f32 — entry-only flows for bar_prob
    Uent: np.ndarray  # [S, K] f32 — base-independent entry rows
    Eent: np.ndarray  # [5, K] f32 — entry-state emissions (Aent = Uent ⊙ Eent)
    end: np.ndarray  # [S] f32 exit weights (f_score = v[L] @ end)
    state_label: np.ndarray  # [S] int32 -> global hmm-counter label
    num_labels: int
    ent_label: np.ndarray  # [K] int32 -> label of each entry-tracked state
    ent_kind: np.ndarray  # [K] int32 0=M0 (already in posterior) 1=I0
    bar_segments: List[Tuple[int, int, int]]  # (label_start, H, segment)
    begin: int  # BEGIN state index
    S: int
    background: np.ndarray  # [5] f32 linear
    avg_len: int
    tmatrix: np.ndarray  # [num_labels, num_labels] f32 0/1
    label_table: np.ndarray  # int64 per label (hmm<<16)|segment


def compile_lattice(mb: ModelBag) -> Lattice:
    nm = mb.num_models
    # enumerate emitting states: segment-major, hmm, column, M then I
    # (label order matches the reference hmm counter: (segment, hmm))
    idx = {}
    state_label = []
    S = 0
    label = 0
    for j, m in enumerate(mb.models):
        for f in range(m.num_hmms):
            for g in range(m.num_cols):
                idx[("M", j, f, g)] = S
                state_label.append(label)
                S += 1
                idx[("I", j, f, g)] = S
                state_label.append(label)
                S += 1
            label += 1
    BEGIN = S
    S += 1
    num_labels = label

    # linear-space params per segment
    trans = [_lin(m.trans) for m in mb.models]  # [H, C, 9]
    me = [_lin(m.m_emit) for m in mb.models]
    ie = [_lin(m.i_emit) for m in mb.models]
    s2M = [_lin(m.silent_to_M) for m in mb.models]
    s2I = [_lin(m.silent_to_I) for m in mb.models]
    skip = [float(np.exp(np.float64(m.skip))) for m in mb.models]

    # silent exit combos: u[j][s] with silent(j)[i] = sum_s u[j][s] * v[s,i]
    # u[-1] = 0 (virtual pre-segment silent is only live at i==0 via BEGIN)
    u = np.zeros((nm, S), dtype=np.float64)
    for j, m in enumerate(mb.models):
        if j > 0:
            # reference quirk: skip term added once per alternative HMM
            u[j] += u[j - 1] * (skip[j] * m.num_hmms)
        for f in range(m.num_hmms):
            for g in range(m.num_cols):
                u[j, idx[("M", j, f, g)]] += trans[j][f, g, MSKIP]
                u[j, idx[("I", j, f, g)]] += trans[j][f, g, ISKIP]

    # BEGIN silent chain at i==0: beta[j] = prod_{k<=j} skip_k (:3699-3705)
    beta = np.zeros(nm + 1, dtype=np.float64)
    beta[0] = 1.0  # silent(-1)[0]
    acc = 1.0
    for j in range(nm):
        acc *= skip[j]
        beta[j + 1] = acc

    def silent_row(j: int) -> np.ndarray:
        """Row over [S] sources giving silent(j)[i-1] when applied to
        v[i-1]; BEGIN carries the i-1==0 mass."""
        row = np.zeros(S, dtype=np.float64)
        if j >= 0:
            row[:] = u[j]
            row[BEGIN] = beta[j + 1]
        else:
            row[BEGIN] = beta[0]
        return row

    # build per-base step matrices
    A = np.zeros((5, S, S), dtype=np.float64)
    Aent_rows = []  # (col index in Aent, per-base rows [5, S])
    Uent_rows = []  # base-independent entry rows [S]
    Eent_rows = []  # entry-state emissions [5]
    ent_label = []
    ent_kind = []

    for j, m in enumerate(mb.models):
        psrow = silent_row(j - 1)
        H, C = m.num_hmms, m.num_cols
        for f in range(m.num_hmms):
            # per-column full-M rows (within-step D-chain closure), per base
            Mrows = np.zeros((C, 5, S), dtype=np.float64)
            Drow = np.zeros((5, S), dtype=np.float64)  # D at current column
            for g in range(C):
                raw = np.tile(psrow * s2M[j][f, g], (5, 1))
                if g >= 1:
                    raw[:, idx[("M", j, f, g - 1)]] += trans[j][f, g - 1, MM]
                    raw[:, idx[("I", j, f, g - 1)]] += trans[j][f, g - 1, IM]
                    raw += Drow * trans[j][f, g - 1, DM]
                for c in range(5):
                    Mrows[g, c] = raw[c] * me[j][f, g, c]
                # D(g) for the *next* column: D(g) = M(g-1)*MD + D(g-1)*DD
                if g >= 1:
                    Drow = (
                        Mrows[g - 1] * trans[j][f, g - 1, MD]
                        + Drow * trans[j][f, g - 1, DD]
                    )
                else:
                    Drow = np.zeros((5, S), dtype=np.float64)
                dst = idx[("M", j, f, g)]
                for c in range(5):
                    A[c, :, dst] = Mrows[g, c]
                # I state: no D involvement
                dstI = idx[("I", j, f, g)]
                entry_rowI = psrow * s2I[j][f, g]
                for c in range(5):
                    rowI = entry_rowI.copy()
                    rowI[idx[("I", j, f, g)]] += trans[j][f, g, II]
                    rowI[idx[("M", j, f, g)]] += trans[j][f, g, MI]
                    A[c, :, dstI] = rowI * ie[j][f, g, c]
            if H > 1:
                g = 0
                rowsM = np.stack([A[c, :, idx[("M", j, f, 0)]] for c in range(5)])
                rowsI = np.stack(
                    [psrow * s2I[j][f, 0] * ie[j][f, 0, c] for c in range(5)]
                )
                Aent_rows.append(rowsM)
                Uent_rows.append(psrow * s2M[j][f, 0])
                Eent_rows.append(me[j][f, 0])
                ent_label.append(state_label[idx[("M", j, f, 0)]])
                ent_kind.append(0)
                Aent_rows.append(rowsI)
                Uent_rows.append(psrow * s2I[j][f, 0])
                Eent_rows.append(ie[j][f, 0])
                ent_label.append(state_label[idx[("I", j, f, 0)]])
                ent_kind.append(1)

    # silent(nm-1)[L]: exits of last segment states + skip-chained exits;
    # BEGIN entry only matters for L==0
    endv = u[nm - 1].copy()
    endv[BEGIN] = beta[nm]

    Aent = (
        np.stack(Aent_rows, axis=-1) if Aent_rows else np.zeros((5, S, 0))
    )  # [K][5,S] -> [5,S,K]
    Uent = np.stack(Uent_rows, axis=-1) if Uent_rows else np.zeros((S, 0))
    Eent = np.stack(Eent_rows, axis=-1) if Eent_rows else np.zeros((5, 0))

    bar_segments = []
    lab0 = 0
    for j, m in enumerate(mb.models):
        if m.num_hmms > 1:
            bar_segments.append((lab0, m.num_hmms, j))
        lab0 += m.num_hmms

    return Lattice(
        A=A.astype(np.float32),
        Aent=np.asarray(Aent, dtype=np.float32),
        Uent=np.asarray(Uent, dtype=np.float32),
        Eent=np.asarray(Eent, dtype=np.float32),
        end=endv.astype(np.float32),
        state_label=np.array(state_label + [num_labels], dtype=np.int32),
        num_labels=num_labels,
        ent_label=np.array(ent_label, dtype=np.int32),
        ent_kind=np.array(ent_kind, dtype=np.int32),
        bar_segments=bar_segments,
        begin=BEGIN,
        S=S,
        background=_lin(mb.models[0].background).astype(np.float32),
        avg_len=mb.average_raw_length,
        tmatrix=mb.tmatrix[: mb.total_hmm_num, : mb.total_hmm_num].astype(np.float32),
        label_table=mb.label.copy(),
    )
