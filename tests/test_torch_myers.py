"""The port's Myers lanes (``tagdust_tpu_torch/engine/myers.py``) against the
JAX package's device lanes and the host uint64 lanes.

Integers throughout, so every comparison is exact (tolerance 0):

* ``bpm_batch_plain`` == JAX ``bpm_batch_device`` == host ``_bpm_batch`` over
  text lengths 7, 64 and 150 and pattern lengths 1-63 with 15% spacer
  symbols, with ``m = 1``, ``m = 63`` and all-spacer lanes; ``lens == 0``
  lanes run as ``m = 1`` in the port, as in the JAX device lanes;
* ``reference_hits_device`` == the JAX package's ``_reference_hits`` (hit and
  ``best_id``), ties included: one read planted in two contaminants, and a
  palindromic read that hits both orientations;
* ``filters._reference_hits`` routes ``"torch"`` to the plain lanes and never
  downgrades to the host lanes when the device lanes fail;
* a card-only case holds the ``td_myers`` kernel to the plain version.
"""

import numpy as np
import pytest
import torch

from tagdust_tpu.engine.myers_tpu import bpm_batch_device
from tagdust_tpu import filters as jfilters
from tagdust_tpu_torch import filters as pfilters
from tagdust_tpu_torch.constants import REV_NUC_CODE, SPACER
from tagdust_tpu_torch.engine import myers

W = 63


def _patterns(seed: int, B: int = 97, zero_len: bool = False):
    """Seeded patterns of lengths 1-63 with 15% spacers; lanes 0-2 are
    ``m = 1``, ``m = 63`` and an all-spacer pattern (lane 3 ``lens == 0``
    with ``zero_len``)."""
    rng = np.random.default_rng(seed)
    pats = np.full((B, W), SPACER, dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for i in range(B):
        L = (1, 63)[i] if i < 2 else int(rng.integers(1, 64))
        lens[i] = L
        row = rng.integers(0, 5, L).astype(np.uint8)
        row[rng.random(L) < 0.15] = SPACER
        if i == 2:
            row[:] = SPACER
        pats[i, :L] = row
    if zero_len:
        lens[3] = 0
        pats[3] = SPACER
    return pats, lens


@pytest.mark.parametrize("tl", [7, 64, 150])
def test_plain_lanes_equal_jax_device_and_host_lanes(tl):
    pats, lens = _patterns(31)
    B4 = pfilters._pattern_masks(pats, lens)
    np.testing.assert_array_equal(B4, jfilters._pattern_masks(pats, lens))
    text = np.random.default_rng(tl).integers(0, 4, tl).astype(np.uint8)
    host = pfilters._bpm_batch(text, B4, lens)
    dev = bpm_batch_device(text, B4, lens)
    plain = myers.bpm_batch_plain(text, B4, lens, "cpu").numpy()
    np.testing.assert_array_equal(plain, host)
    np.testing.assert_array_equal(plain, dev)
    assert plain.dtype == np.int32 and plain[0] in (0, 1)


def test_empty_reads_run_as_one_symbol_and_stay_masked():
    pats, lens = _patterns(32, zero_len=True)
    B4 = pfilters._pattern_masks(pats, lens)
    text = np.random.default_rng(5).integers(0, 4, 64).astype(np.uint8)
    plain = myers.bpm_batch_plain(text, B4, lens, "cpu").numpy()
    np.testing.assert_array_equal(plain, bpm_batch_device(text, B4, lens))
    hit, _ = myers.reference_hits_device(B4, B4, lens, [text], 63, "cpu")
    assert not hit[3] and hit[np.arange(len(lens)) != 3].all()


def _revcomp(row: np.ndarray) -> np.ndarray:
    r = row[::-1]
    return np.where(r >= 5, SPACER, REV_NUC_CODE[np.minimum(r, 4)]).astype(np.uint8)


def _planted(seed: int):
    """(fwd, rev, lens, contaminants): random reads, pieces of the
    contaminants (some reverse-complemented, 0-2 substitutions), one piece
    shared by contaminants 2 and 3 (a tie across contaminants: the first
    keeps the id) and a reverse-palindromic read (a tie across
    orientations)."""
    rng = np.random.default_rng(seed)
    contam = [rng.integers(0, 4, n).astype(np.uint8) for n in (20, 157, 300, 280)]
    shared = rng.integers(0, 4, 40).astype(np.uint8)
    contam[2][100:140] = shared
    contam[3][30:70] = shared
    pal = rng.integers(0, 4, 15).astype(np.uint8)
    pal = np.concatenate([pal, _revcomp(pal)])
    contam[1][60:90] = pal
    reads = [rng.integers(0, 4, int(rng.integers(20, 64))).astype(np.uint8)
             for _ in range(60)]
    for j, c in enumerate(contam):
        for _ in range(6):
            n = min(int(rng.integers(20, 50)), c.shape[0])
            s = int(rng.integers(0, c.shape[0] - n + 1))
            piece = c[s : s + n].copy()
            for _ in range(int(rng.integers(0, 3))):
                piece[int(rng.integers(0, n))] = rng.integers(0, 4)
            reads.append(_revcomp(piece) if rng.random() < 0.5 else piece)
    reads += [shared.copy(), _revcomp(shared), pal.copy(),
              np.zeros(0, dtype=np.uint8)]
    B = len(reads)
    fwd = np.full((B, W), SPACER, dtype=np.uint8)
    rev = np.full((B, W), SPACER, dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for i, r in enumerate(reads):
        lens[i] = r.shape[0]
        fwd[i, : lens[i]] = r
        rev[i, : lens[i]] = _revcomp(r)
    return fwd, rev, lens, contam


@pytest.mark.parametrize("error_cut", [0, 2])
def test_reference_hits_equal_the_jax_package(error_cut):
    fwd, rev, lens, contam = _planted(11)
    want_hit, want_id = jfilters._reference_hits(fwd, rev, lens, contam,
                                                 error_cut, False)
    jax_hit, jax_id = jfilters._reference_hits(fwd, rev, lens, contam,
                                               error_cut, True)
    got_hit, got_id = myers.reference_hits_device(
        pfilters._pattern_masks(fwd, lens), pfilters._pattern_masks(rev, lens),
        lens, contam, error_cut, "cpu")
    real = lens > 0
    np.testing.assert_array_equal(got_hit, want_hit)
    np.testing.assert_array_equal(got_hit, jax_hit)
    np.testing.assert_array_equal(got_id[real], want_id[real])
    np.testing.assert_array_equal(got_id[real], jax_id[real])
    assert got_id.dtype == np.int64 and got_hit.dtype == bool
    # the shared piece keeps the first contaminant's id in both
    # orientations, the palindrome hits, the empty read does not
    assert list(got_id[-4:-1]) == [3, 3, 2] and got_hit[-4:-1].all()
    assert not got_hit[-1]
    assert got_hit.sum() >= 10 and not got_hit[:60].any()
    # in launches of one contaminant each the running minimum is the same
    old = myers.K_BYTES
    myers.K_BYTES = 8
    try:
        hit1, id1 = myers.reference_hits_device(
            pfilters._pattern_masks(fwd, lens), pfilters._pattern_masks(rev, lens),
            lens, contam, error_cut, "cpu")
    finally:
        myers.K_BYTES = old
    np.testing.assert_array_equal(hit1, got_hit)
    np.testing.assert_array_equal(id1, got_id)


@pytest.mark.parametrize("device", ["torch", "exact", None])
def test_filters_route_by_engine_kind(device, monkeypatch):
    fwd, rev, lens, contam = _planted(12)
    calls = []
    real = myers.reference_hits_device

    def spy(*a, **k):
        calls.append(a[-1])
        return real(*a, **k)

    monkeypatch.setattr(myers, "reference_hits_device", spy)
    want_hit, want_id = jfilters._reference_hits(fwd, rev, lens, contam, 2, False)
    hit, best_id = pfilters._reference_hits(fwd, rev, lens, contam, 2, device)
    np.testing.assert_array_equal(hit, want_hit)
    np.testing.assert_array_equal(best_id[lens > 0], want_id[lens > 0])
    assert calls == (["cpu"] if device == "torch" else [])


def test_failing_device_lanes_raise_and_never_downgrade(monkeypatch):
    fwd, rev, lens, contam = _planted(13)

    def boom(*a, **k):
        raise RuntimeError("CUDA kernel td_myers failed to launch (cudaError 1)")

    monkeypatch.setattr(myers, "reference_hits_device", boom)
    monkeypatch.setattr(pfilters, "_bpm_batch", lambda *a: pytest.fail("host lanes"))
    for device in ("cuda", "torch"):
        with pytest.raises(RuntimeError, match="td_myers"):
            pfilters._reference_hits(fwd, rev, lens, contam, 2, device)


def test_cuda_tensors_never_take_the_plain_lanes(monkeypatch):
    """``bpm_batch`` on a CUDA tensor launches the kernel or raises: the
    wrapper's device check is the tensor's, so a stub CUDA tensor reaches
    ``bpm_batch_cuda``, never ``bpm_batch_plain``."""

    class OnCard:
        is_cuda = True
        device = torch.device("cuda")

        def contiguous(self):
            return self

    monkeypatch.setattr(myers, "bpm_batch_plain", lambda *a, **k: pytest.fail("plain"))
    monkeypatch.setattr(myers, "text_tensors", lambda texts, dev: (None, None))
    monkeypatch.setattr(myers, "bpm_batch_cuda",
                        lambda *a: (_ for _ in ()).throw(RuntimeError("launch")))
    m = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="launch"):
        myers.bpm_batch([np.zeros(3, np.uint8)], OnCard(), m)


@pytest.mark.cuda
def test_cuda_kernel_equals_plain_lanes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pats, lens = _patterns(33, B=5000, zero_len=True)
    B4 = pfilters._pattern_masks(pats, lens)
    rev = np.stack([_revcomp(p[:n]).tolist() + [SPACER] * (W - n)
                    for p, n in zip(pats, lens)]).astype(np.uint8)
    B4r = pfilters._pattern_masks(rev, lens)
    rng = np.random.default_rng(9)
    texts = [rng.integers(0, 4, n).astype(np.uint8) for n in (1, 20, 157, 2049, 5070)]
    dev = torch.device("cuda")
    masks = myers.masks_tensor(np.stack([B4, B4r]), dev)
    m = torch.from_numpy(lens).to(dev)
    before = myers.LAUNCHES["myers"]
    k = myers.bpm_batch(texts, masks, m)
    torch.cuda.synchronize()
    assert myers.LAUNCHES["myers"] == before + 1
    for c, t in enumerate(texts):
        for o in range(2):
            plain = myers.bpm_batch_plain(t, masks[o], m)
            assert torch.equal(k[c, o], plain), (c, o)
    real = lens > 0
    host = pfilters._bpm_batch(texts[2], B4[real], lens[real])
    np.testing.assert_array_equal(k[2, 0].cpu().numpy()[real], host)
    hit, best_id = myers.reference_hits_device(B4, B4r, lens, texts, 10, dev)
    chit, cid = myers.reference_hits_device(B4, B4r, lens, texts, 10, "cpu")
    np.testing.assert_array_equal(hit, chit)
    np.testing.assert_array_equal(best_id, cid)
