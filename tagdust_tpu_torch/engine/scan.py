"""Plain PyTorch versions of the four DP kernels, and the scan epilogue.

These transliterate the XLA scan engine of ``tagdust_tpu/engine/tpu.py``
(``backward_scan``, the ``fwd_step`` and traceback of ``_forward_backward``,
``_backward_scores``, ``_q_from_scores``, ``bar_fn`` and the r_log of the
random model) with the layout of the hand-written kernels at their wrapper
boundary:

* ``backward_pass``   (K1) -> stack [Lp+1, B, S], log-scale stack [Lp+1, B],
  logP_b [B].  Slot ``i`` holds the carry after positions ``i..Lp-1``;
* ``backward_scores`` (K4) -> logP_b [B]: K1 without the stack;
* ``forward_decode``  (K2) -> path [Lp, B, H] (int8 when H <= 127),
  dpfin [B, H], f_log [B], tp [B, K];
* ``traceback``       (K3) -> labels [B, Lp+1] int32, slot 0 = 0.

The CPU tests use them, ``FusedScorer`` runs them for CPU tensors, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.

A step has two forms.  Dense: one product over the one-hot expansion of
the carry (``[B, 5S] @ [5S, S(+K)]``), exactly as the JAX scan engine
computes it.  Grouped (``grouped=``, the tables of
``tables.grouped_tables``; K5, ``pallas_kernel.py:256-304``): a product per
span of the block diagonal, plus the silent-exit flows, and the entry
columns through ``(v[:, urows] @ Uent[urows]) * Eent[base]``.
All products run in full float32: TF32 is switched off in each call.

Two more plain versions mirror what the kernels' dense mode does instead of
the dense products: ``sliced_step``, the step over the tables of
``tables.sliced_tables`` as one chain per (read, output) in ascending input
order, and ``sparse_label_dp``, K2's label DP over the non-zero entries of
each column of ``tmat`` (``tables.label_tables``).
"""

from __future__ import annotations

import numpy as np
import torch

# number of calls of a plain version with CUDA tensors: the device main
# path never makes one (chip_smoke.py asserts it stays 0)
PLAIN_CUDA_CALLS = {"count": 0}


def _enter(t: torch.Tensor) -> None:
    """Full-f32 products (TF32 off for matmuls and cuDNN); count calls
    that land on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if t.is_cuda:
        PLAIN_CUDA_CALLS["count"] += 1


def _onehot(seqs: torch.Tensor) -> torch.Tensor:
    """[B, Lp] codes -> [B, Lp, 5] f32; codes >= 5 give a zero row."""
    c = torch.arange(5, device=seqs.device)
    return (seqs.long()[..., None] == c).to(torch.float32)


def _expand(v: torch.Tensor, oh: torch.Tensor) -> torch.Tensor:
    """[B, S] x [B, 5] -> [B, 5S] with layout (c, s)."""
    return (oh[:, :, None] * v[:, None, :]).reshape(v.shape[0], -1)


def _rescale(x: torch.Tensor):
    m = x.amax(dim=1, keepdim=True)
    m = torch.where(m > 0, m, torch.ones_like(m))
    return x / m, torch.log(m[:, 0])


def path_dtype(H: int) -> torch.dtype:
    return torch.int8 if H <= 127 else torch.int32


def _dense_step(M):
    return lambda x, oh: _expand(x, oh) @ M


def sliced_step(x, oh, sl: dict, nout: int):
    """The dense step ``x -> x @ M[base]`` from the step tables of ``M``
    (``tables.sliced_tables``; rows with code >= 5 give 0), as the dense
    kernels run it on swizzled carries: per (read, output) one chain over
    the output's listed inputs in ascending order, a light slice's zero
    padding included, with a multiply and an add where the kernels fuse
    them.  Every term beyond the non-zero ones is x * 0 + acc == acc for
    finite x >= 0, so the result is the chain over all inputs, zeros
    included."""
    from .tables import swizzle

    _enter(x)
    B, S = x.shape
    dev = x.device
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    xs = torch.zeros((B, -(-S // 32) * 32), dtype=torch.float32, device=dev)
    xs[:, t(swizzle(np.arange(S)))] = x
    ys = torch.zeros((B, -(-nout // 32) * 32), dtype=torch.float32, device=dev)
    hp, sp = sl["hv_ptr"], sl["sl_ptr"]
    for c in range(5):
        rows = torch.nonzero(oh[:, c] > 0)[:, 0]
        if rows.numel() == 0:
            continue
        xr = xs[rows]
        for h, o in enumerate(sl["hv_out"]):
            e = sl["hv_ent"][hp[h] : hp[h + 1], c]  # [n, 2]
            acc = torch.zeros(rows.numel(), dtype=torch.float32, device=dev)
            for i, v in zip(e[:, 0], e[:, 1].view(np.float32)):
                acc = acc + xr[:, int(i)] * float(v)
            ys[rows, int(o)] = acc
        for i in range(sl["sl_out"].shape[0]):
            idx = sl["sl_idx"][sp[i] : sp[i + 1]]  # [W, 32]
            val = sl["sl_val"][sp[i] : sp[i + 1], c]  # [W, 32]
            acc = torch.zeros((rows.numel(), 32), dtype=torch.float32, device=dev)
            for w in range(idx.shape[0]):
                acc = acc + xr[:, t(idx[w].astype(np.int64))] * t(val[w])
            outs = sl["sl_out"][i]
            keep = np.nonzero(outs >= 0)[0]
            ys[rows[:, None], t(outs[keep].astype(np.int64))] = acc[:, t(keep)]
    return ys[:, t(swizzle(np.arange(nout)))]


def label_dp(dp, tmat):
    """K2's label DP step over every source: ``(mx, mv)`` [B, H] with
    ``mx[j] = max_c dp[c] * tmat[c, j]`` and ``mv`` its first maximal
    source, then the diagonal override (``dp[j] * tmat[j, j] == mx[j]``
    takes ``j``)."""
    H = tmat.shape[0]
    scores = dp[:, :, None] * tmat[None, :, :]
    mx = scores.amax(dim=1)
    mv = torch.argmax(scores, dim=1)
    jidx = torch.arange(H, device=dp.device).expand(dp.shape[0], H)
    return mx, torch.where(dp * torch.diagonal(tmat)[None, :] == mx, jidx, mv)


def sparse_label_dp(dp, tm_ptr, tm_src, tm_val, tm_diag):
    """K2's label DP step over the non-zero entries of each column of
    ``tmat`` (``tables.label_tables``): ``(mx, mv)`` [B, H] with ``mx[j] =
    max_c dp[c] * tmat[c, j]`` and ``mv`` its source, the first maximal one,
    then the diagonal override.  The sources left out give 0 (dp >= 0), as
    the full loop's source 0 does, so a label whose listed candidates are
    all <= 0, or that has none, takes (0, 0)."""
    B, H = dp.shape
    ptr = tm_ptr.long()
    counts = ptr[1:] - ptr[:-1]
    mx = torch.full((B, H), -1.0, dtype=torch.float32, device=dp.device)
    mv = torch.full((B, H), -1, dtype=torch.long, device=dp.device)
    last = max(tm_src.numel() - 1, 0)
    for k in range(int(counts.max())):
        e = torch.clamp(ptr[:-1] + k, max=last)
        src = tm_src[e].long()
        cand = dp[:, src] * tm_val[e]
        better = (k < counts) & (cand > mx)
        mx = torch.where(better, cand, mx)
        mv = torch.where(better, src.expand(B, H), mv)
    none = mx <= 0
    mx = torch.where(none, torch.zeros_like(mx), mx)
    mv = torch.where(none, torch.zeros_like(mv), mv)
    jidx = torch.arange(H, device=dp.device).expand(B, H)
    return mx, torch.where(dp * tm_diag == mx, jidx, mv)


def _grouped_step(g: dict, fwd: bool):
    """The grouped step ``x -> x @ A[base]`` (fwd) or ``x @ A[base]^T``:
    block products over the spans, then the rank-nm silent-exit flow
    ``((x @ Uexit)[:, seg] * wvec[base])`` or its transpose
    ``((x * wvec[base]) @ Mseg) @ Uexit^T``."""
    spans = g["span"].tolist()
    tile = g["tile_f"] if fwd else g["tile_b"]
    uexit = g["uexit"]  # [nm, S]
    seg = g["seg"].long()
    mseg = torch.nn.functional.one_hot(seg, uexit.shape[0]).to(torch.float32)

    def step(x, oh):
        out = torch.empty_like(x)
        for s0, w, off in spans:
            blk = tile[off : off + 5 * w * w].view(5 * w, w)
            out[:, s0 : s0 + w] = _expand(x[:, s0 : s0 + w], oh) @ blk
        wsel = oh @ g["wvec"]
        if fwd:
            return out + (x @ uexit.T)[:, seg] * wsel
        return out + ((x * wsel) @ mseg) @ uexit

    return step


def _backward(seqs, lens, step, end, begin: int, spill: bool):
    _enter(seqs)
    B, Lp = seqs.shape
    S = end.shape[0]
    oh = _onehot(seqs)
    b = end[None, :].expand(B, S).clone()
    bls = torch.zeros(B, dtype=torch.float32, device=seqs.device)
    bstack = blstack = None
    if spill:
        bstack = torch.empty((Lp + 1, B, S), dtype=torch.float32, device=seqs.device)
        blstack = torch.empty((Lp + 1, B), dtype=torch.float32, device=seqs.device)
    for p in range(Lp - 1, -1, -1):
        if spill:
            bstack[p + 1] = b
            blstack[p + 1] = bls
        bn, lm = _rescale(step(b, oh[:, p]))
        act = p < lens
        b = torch.where(act[:, None], bn, b)
        bls = torch.where(act, bls + lm, bls)
    if spill:
        bstack[0] = b
        blstack[0] = bls
    logpb = torch.log(torch.clamp_min(b[:, begin], 1e-38)) + bls
    return bstack, blstack, logpb


def backward_pass(seqs, lens, Abwd, end, begin: int, grouped: dict = None):
    """K1: the rescaled backward recurrence with its stack spill."""
    step = _dense_step(Abwd) if grouped is None else _grouped_step(grouped, False)
    return _backward(seqs, lens, step, end, begin, spill=True)


def backward_scores(seqs, lens, Abwd, end, begin: int, grouped: dict = None):
    """K4: ``backward_pass`` without the stack; the same logP_b, bit for
    bit (MODE_ARCH_COMP, test_architectures.c:182-184)."""
    step = _dense_step(Abwd) if grouped is None else _grouped_step(grouped, False)
    return _backward(seqs, lens, step, end, begin, spill=False)[2]


def forward_decode(seqs, lens, Afwd, end, Lmap, ent_state, tmat, begin: int,
                   bstack, blstack, logpb, grouped: dict = None):
    """K2: forward recurrence, label and barcode-entry posteriors, and the
    fused optimal-accuracy label DP (barcode_hmm.c:4451)."""
    _enter(seqs)
    B, Lp = seqs.shape
    S = end.shape[0]
    H = tmat.shape[0]
    dev = seqs.device
    if grouped is None:
        K = Afwd.shape[1] - S
        dense = _dense_step(Afwd)

        def step(v, oh):
            Y = dense(v, oh)
            return Y[:, :S], Y[:, S:]
    else:
        K = grouped["eent"].shape[1]
        blocks = _grouped_step(grouped, True)
        urows = grouped["urows"].long()

        def step(v, oh):
            ve = (v[:, urows] @ grouped["uent"]) * (oh @ grouped["eent"])
            return blocks(v, oh), ve
    oh = _onehot(seqs)
    Lm = Lmap[:, :H]
    jidx = torch.arange(H, device=dev)[None, :].expand(B, H)
    ent = ent_state.long()
    v = torch.zeros((B, S), dtype=torch.float32, device=dev)
    v[:, begin] = 1.0
    fls = torch.zeros(B, dtype=torch.float32, device=dev)
    tp = torch.zeros((B, K), dtype=torch.float32, device=dev)
    dp = torch.zeros((B, H), dtype=torch.float32, device=dev)
    path = torch.empty((Lp, B, H), dtype=path_dtype(H), device=dev)
    for k in range(Lp):
        vn, ve = step(v, oh[:, k])
        bw = bstack[k + 1]
        # clamped: on padded steps the stale scales can overflow the exp
        w = torch.exp(torch.clamp_max(fls + blstack[k + 1] - logpb, 60.0))
        plab = ((vn * bw) @ Lm) * w[:, None]
        tpn = tp + ve * bw[:, ent] * w[:, None]
        vn2, lm = _rescale(vn)
        act = k < lens
        v = torch.where(act[:, None], vn2, v)
        fls = torch.where(act, fls + lm, fls)
        tp = torch.where(act[:, None], tpn, tp)
        mx, mv = label_dp(dp, tmat)
        dp = torch.where(act[:, None], plab + mx, dp)
        path[k] = torch.where(act[:, None], mv, jidx).to(path.dtype)
    f_log = torch.log(torch.clamp_min(v @ end, 1e-38)) + fls
    return path, dp, f_log, tp


def traceback(path, dpfin):
    """K3: walk the backpointers from argmax(dpfin); slot 0 stays 0."""
    _enter(path)
    Lp, B, _ = path.shape
    labels = torch.zeros((B, Lp + 1), dtype=torch.int32, device=path.device)
    move = torch.argmax(dpfin, dim=1)
    labels[:, Lp] = move.to(torch.int32)
    for i in range(Lp - 1, 0, -1):
        move = path[i].long().gather(1, move[:, None])[:, 0]
        labels[:, i] = move.to(torch.int32)
    return labels


# ---------------- epilogue (the `_get_pallas.full` tail) ----------------

def bar_log(tp: torch.Tensor, bar_segments) -> torch.Tensor:
    """Barcode log probability from the entry posteriors (tpu.py bar_fn)."""
    B = tp.shape[0]
    out = torch.zeros(B, dtype=torch.float32, device=tp.device)
    if tp.shape[1] == 0:
        return out
    per_f = tp[:, 0::2] + tp[:, 1::2]
    logs = torch.log(torch.clamp_min(per_f, 1e-38))
    col = 0
    for hn in bar_segments:
        seg = logs[:, col : col + hn]
        norm = torch.logsumexp(seg, dim=1)
        out = out + (seg[:, : hn - 1].amax(dim=1) - norm)
        col += hn
    return torch.clamp_max(out, 0.0)


def random_log(seqs, lens, bg_log, avg_len) -> torch.Tensor:
    """log P(x | random model) over the first ``lens`` positions."""
    Lp = seqs.shape[1]
    active = torch.arange(Lp, device=seqs.device)[None, :] < lens[:, None]
    r_per = torch.log1p(-1.0 / avg_len)
    emit = bg_log[torch.clamp(seqs.long(), max=bg_log.shape[0] - 1)]
    return (
        torch.where(active, emit, torch.zeros_like(emit)).sum(dim=1)
        + lens.to(torch.float32) * r_per
        + torch.log(1.0 / avg_len)
    )


def q_from_scores(f_log, r_log, bar) -> torch.Tensor:
    """Q as do_label_thread computes it (barcode_hmm.c:2318-2336),
    unclamped above 40, NaN for a negative p_wrong."""
    denom = torch.logaddexp(f_log, r_log)
    p_wrong = 1.0 - torch.exp(bar + f_log - denom)
    return torch.where(
        p_wrong == 0.0,
        torch.full_like(p_wrong, 40.0),
        torch.where(
            p_wrong == 1.0, torch.zeros_like(p_wrong), -10.0 * torch.log10(p_wrong)
        ),
    )
