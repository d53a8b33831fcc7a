"""The plain passes of the reference: the port's ``engine/scan.py``, its
dense step only (the grouped step and the kernels' sliced forms left out).

* ``backward_pass``   (K1) -> stack [Lp+1, B, S], log-scale stack [Lp+1, B],
  logP_b [B].  Slot ``i`` holds the carry after positions ``i..Lp-1``;
* ``backward_scores`` (K4) -> logP_b [B]: K1 without the stack;
* ``forward_decode``  (K2) -> path [Lp, B, H] (int8 when H <= 127),
  dpfin [B, H], f_log [B], tp [B, K];
* ``traceback``       (K3) -> labels [B, Lp+1] int32, slot 0 = 0.

A step is one product over the one-hot expansion of the carry
(``[B, 5S] @ [5S, S(+K)]``), in full float32 with TF32 off; under
``precision(True)``, the control, every product's operands are rounded to
TF32 first.
"""

from __future__ import annotations

import contextlib

import torch

# whether the products' operands are rounded to TF32 (the control)
_TF32 = {"on": False}


@contextlib.contextmanager
def precision(tf32: bool):
    """Run the passes inside with their products' operands rounded to TF32
    (``tf32``, the control; ``_tf32``) or in full float32."""
    old = _TF32["on"]
    _TF32["on"] = tf32
    try:
        yield
    finally:
        _TF32["on"] = old


def _enter(t: torch.Tensor) -> None:
    """Full-f32 products: TF32 off for matmuls and cuDNN (the control rounds
    its operands itself, the same on every device)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10-bit mantissa (to nearest), as the tensor
    cores read a float32 operand; ``x`` itself in full float32."""
    if not _TF32["on"]:
        return x
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``: full float32, or both operands in TF32 for the control."""
    return _tf32(a) @ _tf32(b)


def _dense_step(M):
    return lambda x, oh: _mm(_expand(x, oh), M)


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


def backward_pass(seqs, lens, Abwd, end, begin: int):
    """K1: the rescaled backward recurrence with its stack spill."""
    return _backward(seqs, lens, _dense_step(Abwd), end, begin, spill=True)


def backward_scores(seqs, lens, Abwd, end, begin: int):
    """K4: ``backward_pass`` without the stack; the same logP_b, bit for
    bit (MODE_ARCH_COMP, test_architectures.c:182-184)."""
    return _backward(seqs, lens, _dense_step(Abwd), end, begin, spill=False)[2]


def forward_decode(seqs, lens, Afwd, end, Lmap, ent_state, tmat, begin: int,
                   bstack, blstack, logpb):
    """K2: forward recurrence, label and barcode-entry posteriors, and the
    fused optimal-accuracy label DP (barcode_hmm.c:4451)."""
    _enter(seqs)
    B, Lp = seqs.shape
    S = end.shape[0]
    H = tmat.shape[0]
    dev = seqs.device
    K = Afwd.shape[1] - S
    dense = _dense_step(Afwd)

    def step(v, oh):
        Y = dense(v, oh)
        return Y[:, :S], Y[:, S:]
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
        plab = _mm(vn * bw, Lm) * w[:, None]
        tpn = tp + ve * bw[:, ent] * w[:, None]
        vn2, lm = _rescale(vn)
        act = k < lens
        v = torch.where(act[:, None], vn2, v)
        fls = torch.where(act, fls + lm, fls)
        tp = torch.where(act[:, None], tpn, tp)
        mx, mv = label_dp(dp, tmat)
        dp = torch.where(act[:, None], plab + mx, dp)
        path[k] = torch.where(act[:, None], mv, jidx).to(path.dtype)
    f_log = torch.log(torch.clamp_min(_mm(v, end[:, None])[:, 0], 1e-38)) + fls
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
