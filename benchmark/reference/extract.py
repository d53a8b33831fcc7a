"""Q scoring and read extraction from decoded label paths.

* Q score: ``P_wrong = 1 - bar_prob*P(x|M) / (P(x|M)+P(x|R))`` converted to a
  phred-style value clamped to [0, 40] — mirrors ``do_label_thread`` /
  ``do_probability_estimation`` (``barcode_hmm.c:2290-2338``, ``:2192-2233``;
  formula doc ``doc/User-Manual.tex:1325-1336``).
* Extraction walks the per-base label path, decodes barcode / fingerprint
  segments, enforces per-R-segment minimum lengths, and rewrites the read so
  only R bases remain with 65-valued spacers in between — mirrors
  ``extract_reads`` (``barcode_hmm.c:3172-3313``) and ``make_extracted_read``
  (``:3325-3356``).
"""

from __future__ import annotations

import math

import numpy as np

from .constants import (
    EXTRACT_FAIL_ARCHITECTURE_MISMATCH,
    EXTRACT_FAIL_BAR_FINGER_NOT_FOUND,
    EXTRACT_FAIL_READ_TOO_SHORT,
    EXTRACT_SUCCESS,
    SPACER,
)
from .batch import Read
from .logsum import NEG_INF, logsum
from .model import ModelBag

_F32 = np.float32


def compute_q(f_score, r_score, bar_prob) -> np.ndarray:
    """Vectorised Q computation (barcode_hmm.c:2298-2338), float32 exact.

    Transcendentals go through libm (math.exp/math.log10) per element to
    match glibc bit-for-bit after the 1-p cancellation."""
    f_score = np.asarray(f_score, dtype=np.float32)
    pbest = logsum(np.full_like(f_score, NEG_INF), f_score)
    pbest = logsum(pbest, np.asarray(r_score, dtype=np.float32))
    # ri->bar_prob is a double (io.h:86): the numerator and the subtraction
    # are evaluated in double precision before the float narrowing at the
    # scaledprob2prob() argument (barcode_hmm.c:2327)
    d64 = (
        np.asarray(bar_prob, dtype=np.float64)
        + f_score.astype(np.float64)
        - pbest.astype(np.float64)
    )
    d = d64.astype(np.float32)
    q = np.empty(d.shape, dtype=np.float32)
    for i, dv in enumerate(np.ravel(d)):
        e = 0.0 if np.isneginf(dv) else float(_F32(math.exp(float(dv))))
        p_wrong = float(_F32(1.0 - e))
        if p_wrong == 0.0:
            qq = _F32(40.0)
        elif p_wrong == 1.0:
            qq = _F32(0.0)
        elif p_wrong < 0.0 or math.isnan(p_wrong):
            qq = _F32(float("nan"))
        else:
            qq = _F32(-10.0 * math.log10(p_wrong))
        q.ravel()[i] = qq
    return q


def required_finger_length(rs) -> int:
    """Total F-segment length (extract_reads' required_finger_len,
    barcode_hmm.c:3188-3195).  THE one definition — the host extractors and
    the on-device decision pipeline must gate on the same value."""
    if rs is None:
        return 0
    return sum(
        len(rs.seqs[j][0])
        for j in range(rs.num_segments)
        if rs.types[j] == "F"
    )


def label_decode_tables(mb: ModelBag, rs) -> dict:
    """Per-label decode tables (segment id, alternative id, segment-type
    membership, null-N-alternative flag), indexed by label value.

    THE one definition consumed by both the host columnar extractor and
    the on-device decision pipeline (`engine/tpu.py:_label_tables`) — the
    device/host byte-equivalence contract requires a single source for the
    label encoding (c1 = label table entry, c2 = c1 & 0xFFFF segment,
    c3 = (c1 >> 16) & 0x7FFF alternative; extract_reads,
    barcode_hmm.c:3203-3231)."""
    lab_tab = np.asarray(mb.label, dtype=np.int64)
    seg = (lab_tab & 0xFFFF).astype(np.int32)
    alt = ((lab_tab >> 16) & 0x7FFF).astype(np.int32)
    types = rs.types if rs is not None else []
    nseg = rs.num_segments if rs is not None else 0
    types_arr = np.array([ord(t) for t in types] + [0], dtype=np.int32)
    nseq_arr = np.array(
        [rs.numseq_in_segment(j) for j in range(nseg)] + [0], dtype=np.int32
    )
    seg_clip = np.minimum(seg, len(types_arr) - 1)
    tcode = types_arr[seg_clip]
    is_B = tcode == ord("B")
    null_b = is_B & (
        alt == nseq_arr[np.minimum(seg_clip, len(nseq_arr) - 1)] - 1
    )
    return {
        "seg": seg,
        "alt": alt,
        "tcode": tcode,
        "is_F": tcode == ord("F"),
        "is_B": is_B,
        "is_R": tcode == ord("R"),
        "null_b": null_b,
    }


def extract_read(
    mb: ModelBag,
    rs,
    read: Read,
    labels: np.ndarray,
    minlen: int,
    confidence_threshold: float,
    matchstart: int = -1,
    matchend: int = -1,
) -> None:
    """Apply extract_reads (barcode_hmm.c:3172-3313) to one read in place.

    ``labels`` holds label indices for positions 0..len of the decoded
    subsequence (index 0 is the pre-sequence slot)."""
    L = read.len
    offset = 0
    if matchstart != -1 or matchend != -1:
        offset = matchstart
        L = matchend - matchstart

    required_finger_len = required_finger_length(rs)

    if confidence_threshold <= read.mapq:
        fingerlen = 0
        key = 0
        bar = -1
        mem = -1
        hmm_has_barcode = 0
        too_short = 0
        in_read = 0
        s_pos = 0
        lab_tab = mb.label
        for j in range(L):
            c1 = int(lab_tab[int(labels[j + 1])])
            c2 = c1 & 0xFFFF
            c3 = (c1 >> 16) & 0x7FFF
            t = rs.types[c2]
            if t == "F":
                fingerlen += 1
                # positions past the read's real length contribute 0 bits
                # (the C code reads out of bounds there, barcode_hmm.c:3215 —
                # undefined; this defined choice matches extract_batch)
                jj = j + offset
                b = int(read.seq[jj]) if jj < read.len else 0
                key = (key << 2) | (b & 0x3)
            if t == "B":
                hmm_has_barcode = 1
                bar = c3
                if bar == rs.numseq_in_segment(c2) - 1:
                    hmm_has_barcode = -1
                mem = c2
            if t == "R":
                s_pos += 1
                in_read = 1
            else:
                if in_read and s_pos < minlen:
                    too_short = 1
                    break
                in_read = 0
                s_pos = 0
        if in_read and s_pos < minlen:
            too_short = 1

        if not too_short:
            if hmm_has_barcode == -1:
                read.read_type = EXTRACT_FAIL_BAR_FINGER_NOT_FOUND
            elif hmm_has_barcode and required_finger_len:
                if fingerlen == required_finger_len and bar != -1:
                    _make_extracted(mb, rs, read, labels)
                    read.barcode = (mem << 16) | bar
                    read.fingerprint = (key << 8) | min(required_finger_len, 255)
                    read.read_type = EXTRACT_SUCCESS
                else:
                    read.read_type = EXTRACT_FAIL_BAR_FINGER_NOT_FOUND
            elif hmm_has_barcode:
                if bar != -1:
                    _make_extracted(mb, rs, read, labels)
                    read.barcode = (mem << 16) | bar
                    read.read_type = EXTRACT_SUCCESS
                else:
                    read.read_type = EXTRACT_FAIL_BAR_FINGER_NOT_FOUND
            elif required_finger_len:
                if fingerlen == required_finger_len:
                    _make_extracted(mb, rs, read, labels)
                    read.fingerprint = (key << 8) | min(required_finger_len, 255)
                    read.read_type = EXTRACT_SUCCESS
                else:
                    read.read_type = EXTRACT_FAIL_BAR_FINGER_NOT_FOUND
            else:
                _make_extracted(mb, rs, read, labels)
                read.read_type = EXTRACT_SUCCESS
        else:
            read.read_type = EXTRACT_FAIL_READ_TOO_SHORT
    else:
        read.read_type = EXTRACT_FAIL_ARCHITECTURE_MISMATCH


def extract_batch(
    mb: ModelBag,
    rs,
    reads,
    labels: np.ndarray,
    minlen: int,
    confidence_threshold: float,
    matchstart: int = -1,
    matchend: int = -1,
) -> None:
    """Per-read-object adapter over :func:`extract_batch_columnar`.

    Same observable behaviour as calling :func:`extract_read` per read (the
    equality is asserted by tests).  The real implementation is columnar;
    this wrapper converts, runs it, and copies results (and the rewritten
    seq/qual of successful reads) back onto the ``Read`` objects.
    """
    from .batch import ReadBatch

    B = len(reads)
    if B == 0:
        return
    batch = ReadBatch.from_reads(reads)
    batch.mapq = np.fromiter((r.mapq for r in reads), dtype=np.float64, count=B)
    extract_batch_columnar(
        mb, rs, batch, labels, minlen, confidence_threshold,
        matchstart, matchend,
    )
    for i, r in enumerate(reads):
        r.read_type = int(batch.read_type[i])
        if batch.read_type[i] == EXTRACT_SUCCESS:
            r.seq = batch.seq(i).copy()
            r.qual = batch.qual(i)
            if batch.barcode[i] != -1:
                r.barcode = int(batch.barcode[i])
            if batch.fingerprint[i] != -1 or i in batch.fp_big:
                r.fingerprint = batch.fp_value(i)


def extract_batch_columnar(
    mb: ModelBag,
    rs,
    batch,
    labels: np.ndarray,
    minlen: int,
    confidence_threshold: float,
    matchstart: int = -1,
    matchend: int = -1,
) -> None:
    """Vectorised extract_reads (barcode_hmm.c:3172-3356) over a whole chunk.

    All per-base work is NumPy array ops over the ``[B, L]`` label matrix and
    the batch's flat arenas — the production path that keeps the host side
    out of per-base Python loops.  Successful reads are rewritten IN PLACE in
    the batch's seq/qual arenas (non-R bases -> 65-spacer), and the result
    columns (``read_type``, ``barcode``, ``fingerprint``, ``mapq``-gated
    outcomes) are filled.

    ``labels`` is the ``[B, Lpad+1]`` int matrix from the batched engines
    (slot 0 = pre-read slot).
    """
    B = batch.B
    if B == 0:
        return
    offset = 0
    sub = matchstart != -1 or matchend != -1
    if sub:
        offset = matchstart

    full_lens = batch.lens
    seq_off = batch.seq_off[:-1]
    arena = batch.seq_arena
    cap = max(arena.shape[0] - 1, 0)
    dec_lens = (
        np.full(B, matchend - matchstart, dtype=np.int64) if sub else full_lens
    )
    Lfull = int(full_lens.max(initial=0))
    Ldec = max(int(dec_lens.max(initial=0)), 1)  # keep [B, Ldec] ops non-empty
    Lpad1 = labels.shape[1]

    required_finger_len = required_finger_length(rs)

    # tiny per-label lookup tables so the [B, L] work is bool/int32 only
    # (large-temporary footprint matters: first-touch page faults dominate
    # on some hosts); shared with the device decision pipeline
    T = label_decode_tables(mb, rs)
    seg_of = T["seg"]  # c2 per label index
    alt_of = T["alt"]  # c3 per label index
    is_F_label = T["is_F"]
    is_R_label = T["is_R"]
    null_of_label = T["null_b"]

    # decoded-region labels, positions j in [0, Ldec)
    lab_dec = np.zeros((B, Ldec), dtype=np.int32)
    w = min(Ldec, Lpad1 - 1)
    lab_dec[:, :w] = labels[:, 1 : w + 1]
    pos = np.arange(Ldec, dtype=np.int32)[None, :]
    valid = pos < dec_lens[:, None]

    tF = is_F_label[lab_dec] & valid
    tB = T["is_B"][lab_dec] & valid
    tR = is_R_label[lab_dec] & valid

    mapq = np.asarray(batch.mapq, dtype=np.float64)
    passed = confidence_threshold <= mapq  # NaN -> False -> mismatch

    fingerlen = tF.sum(axis=1, dtype=np.int32)

    # --- barcode: state after the LAST B-labelled position ---
    has_b = tB.any(axis=1)
    last_b = np.where(has_b, Ldec - 1 - np.argmax(tB[:, ::-1], axis=1), 0)
    rows = np.arange(B)
    lab_last = lab_dec[rows, last_b]
    bar = np.where(has_b, alt_of[lab_last], -1)
    mem = np.where(has_b, seg_of[lab_last], -1)
    # hmm_has_barcode: 0 none, 1 real, -1 null-N alternative
    hmm_has_barcode = np.where(
        has_b, np.where(null_of_label[lab_last], -1, 1), 0
    )

    # --- too-short: every maximal R run must reach minlen ---
    # run length ending at j = j - (index of last non-R position before j);
    # the accumulate runs column-by-column with a reused [B] carry (a whole
    # [B, L] ufunc.accumulate is pathologically slow in numpy)
    last_nonr = np.empty((B, Ldec), dtype=np.int32)
    carry = np.where(tR[:, 0], np.int32(-1), np.int32(0))  # [B]
    last_nonr[:, 0] = carry
    for j in range(1, Ldec):
        carry = np.where(tR[:, j], carry, np.int32(j))
        last_nonr[:, j] = carry
    runlen = pos - last_nonr  # only meaningful where tR
    nxt = np.zeros_like(tR)
    nxt[:, :-1] = tR[:, 1:]
    run_end = tR & ~nxt  # covers both interior ends and the final position
    too_short = (run_end & (runlen < minlen)).any(axis=1)

    # --- fingerprint keys: 2-bit packed F bases in read order ---
    key_arr = np.zeros(B, dtype=np.int64)
    fp_big: dict = {}
    if required_finger_len and Ldec:
        fi, fj = np.nonzero(tF)  # row-major: in-read order within each row
        # F positions past the read's real length contribute 0 bits (same
        # defined semantics as extract_read; the C code is out-of-bounds)
        idx = fj + offset
        in_bounds = idx < full_lens[fi]
        basebits = np.where(
            in_bounds,
            arena[np.minimum(seq_off[fi] + idx, cap)] & 0x3,
            0,
        ).astype(np.int64)
        nF = fi.shape[0]
        if nF:
            counts = fingerlen.astype(np.int64)
            starts_all = np.zeros(B, dtype=np.int64)
            np.cumsum(counts[:-1], out=starts_all[1:])
            if required_finger_len <= 27:
                # (key << 8) | len fits an int64 exactly up to 27 F bases
                pos_in_row = np.arange(nF, dtype=np.int64) - starts_all[fi]
                shift = 2 * (counts[fi] - 1 - pos_in_row)
                contrib = basebits << shift
                rows_nz = np.nonzero(counts > 0)[0]
                key_arr[rows_nz] = np.add.reduceat(
                    contrib, starts_all[rows_nz]
                )
            else:
                # huge UMIs: exact Python ints (the per-read path's
                # semantics; the reference C int overflows here)
                pyk: dict = {}
                for n in range(nF):
                    i = int(fi[n])
                    pyk[i] = (pyk.get(i, 0) << 2) | int(basebits[n])
                fp_big = pyk

    # --- outcome decision tree (extract_reads, barcode_hmm.c:3203-3304) ---
    finger_ok = fingerlen == required_finger_len
    if required_finger_len:
        success = np.where(
            hmm_has_barcode == 1,
            finger_ok & (bar != -1),
            np.where(hmm_has_barcode == 0, finger_ok, False),
        )
    else:
        success = np.where(
            hmm_has_barcode == 1,
            bar != -1,
            hmm_has_barcode == 0,
        )
    success = passed & ~too_short & success
    read_type = np.where(
        passed,
        np.where(
            too_short,
            EXTRACT_FAIL_READ_TOO_SHORT,
            np.where(success, EXTRACT_SUCCESS, EXTRACT_FAIL_BAR_FINGER_NOT_FOUND),
        ),
        EXTRACT_FAIL_ARCHITECTURE_MISMATCH,
    )

    # --- make_extracted_read over the FULL read length (labels index is NOT
    # offset by matchstart; beyond the label buffer reads as 0 — reference
    # quirks preserved, barcode_hmm.c:3325-3356).  The rewrite scatters
    # 65-spacers into the batch's seq/qual arenas in place, successful rows
    # only ---
    lab_full = np.zeros((B, Lfull), dtype=np.int32)
    wf = min(Lfull, Lpad1 - 1)
    lab_full[:, :wf] = labels[:, 1 : wf + 1]
    r_full = is_R_label[lab_full]
    posf = np.arange(Lfull, dtype=np.int64)[None, :]
    validf = posf < full_lens[:, None]
    blank = (~r_full) & validf & success[:, None]
    bi, bj = np.nonzero(blank)
    arena[seq_off[bi] + bj] = SPACER
    if batch.qual_len.shape[0]:
        has_q = batch.qual_len >= 0
        qmask = blank & has_q[:, None]
        qi, qj = np.nonzero(qmask)
        batch.qual_arena[batch.qual_off[qi] + qj] = SPACER

    batch.read_type[:] = read_type
    set_bar = success & (hmm_has_barcode == 1)
    batch.barcode[set_bar] = (
        (mem[set_bar].astype(np.int64) << 16) | bar[set_bar]
    )
    if required_finger_len:
        set_fp = success & np.ones(B, dtype=bool)
        fp_len = min(required_finger_len, 255)
        if fp_big:
            batch.fp_big = {
                i: (fp_big.get(i, 0) << 8) | fp_len
                for i in range(B)
                if set_fp[i]
            }
            # keep the array sentinel distinct so fp_value() consults fp_big
            batch.fingerprint[set_fp] = -2
        else:
            batch.fingerprint[set_fp] = (key_arr[set_fp] << 8) | fp_len


def apply_device_decisions(batch, res: dict, required_finger_len: int) -> None:
    """Apply ON-DEVICE extraction decisions to a columnar batch window.

    ``res`` is `TpuEngine.collect_pallas_decided` output: the device already
    evaluated extract_reads' decision tree (barcode_hmm.c:3203-3304) on the
    label path — threshold pass, per-R minlen, barcode alt + null-N
    rejection, fingerprint key — so the host work left is exactly the byte
    rewrite: scatter 65-spacers over non-keep positions of successful reads
    (make_extracted_read, :3325-3356) and store the result columns.  Only
    callable in the non-subrange, fingerprint<=27nt regime (the streaming
    runner gates on that); byte-equivalence with the host extractor is
    asserted by tests/test_multichip.py and the CLI invariance tests.
    """
    B = batch.B
    if B == 0:
        return
    batch.mapq[:] = res["mapq"].astype(np.float64)
    read_type = res["read_type"]
    batch.read_type[:] = read_type
    success = read_type == EXTRACT_SUCCESS
    bar_mem = res["bar_mem"]
    setb = bar_mem != -1
    batch.barcode[setb] = bar_mem[setb].astype(np.int64)
    if required_finger_len:
        fp_len = min(required_finger_len, 255)
        batch.fingerprint[success] = (
            res["fp_key"][success] << 8
        ) | fp_len

    lens = batch.lens
    Lfull = int(lens.max(initial=0))
    if Lfull == 0:
        return
    keep = res["keep"]  # [B, >=Lfull] (device width Lp >= Lfull)
    posf = np.arange(Lfull, dtype=np.int64)[None, :]
    validf = posf < lens[:, None]
    blank = (~keep[:, :Lfull]) & validf & success[:, None]
    bi, bj = np.nonzero(blank)
    seq_off = batch.seq_off[:-1]
    batch.seq_arena[seq_off[bi] + bj] = SPACER
    if batch.qual_len.shape[0]:
        has_q = batch.qual_len >= 0
        qmask = blank & has_q[:, None]
        qi, qj = np.nonzero(qmask)
        batch.qual_arena[batch.qual_off[qi] + qj] = SPACER


def _make_extracted(mb: ModelBag, rs, read: Read, labels: np.ndarray) -> None:
    """make_extracted_read (barcode_hmm.c:3325-3356): non-R bases -> spacer.

    Walks the *full* read length; label slots beyond the decoded range read
    as 0 (matching the zero-initialised label buffer in the reference)."""
    L = read.len
    lab_tab = mb.label
    seq = read.seq
    qual = list(read.qual) if read.qual is not None else None
    new_seq = np.empty(L, dtype=np.uint8)
    for j in range(L):
        li = int(labels[j + 1]) if j + 1 < labels.shape[0] else 0
        c2 = int(lab_tab[li]) & 0xFFFF
        if rs.types[c2] == "R":
            new_seq[j] = seq[j]
            if qual is not None:
                qual[j] = read.qual[j]
        else:
            new_seq[j] = SPACER
            if qual is not None:
                qual[j] = chr(SPACER)
    read.seq = new_seq
    if qual is not None:
        read.qual = "".join(qual)
