"""``CudaEngine``: the batched device scorer of one compiled model.

The counterpart of ``tagdust_tpu/engine/tpu.py:TpuEngine``:

* ``run_batch``        — the scan engine: the plain versions of
  ``engine/scan.py`` end to end (the reference path of the tests);
* ``run_batch_fused``  — the fused kernels (``FusedScorer``) plus the
  scoring epilogue (r_log, bar_prob, Q), in sub-batches whose buffers stay
  inside ``STACK_BYTES`` (down to one read; a read that alone exceeds it is
  refused);
* ``dispatch_decided`` — the streaming decided mode (rows parsed by
  ``decided.collect_decided``):
  labels stay on the device, the host receives Lp/8+25 bytes per read;
  its upload, and that of ``run_batch_fused`` at an even length, is
  nibble-packed unless ``nibble_uploads`` says no;
* ``dispatch_packed``  — the streaming label-carrying mode (rows parsed by
  ``collect_packed``) for sub-range decodes (``-start/-end``) and
  fingerprints past 27nt, which the host extractor decides: one uint8 row
  per read, its labels, the four scores and both DUST variants;
* ``backward_scores``  — logP_b only, for architecture detection (K4).

The engine runs on ``device``: ``cuda`` launches the hand-written kernels,
``cpu`` runs the same pipeline through the plain versions.  The kernels
run the dense (non-zero) step, or the grouped (block-banded) one where
``grouped_step_mode`` is asked for it.  On the card the engine refuses,
when it is built, a lattice whose carries for one read do not fit a
block's shared memory (beyond about 28,000 states, where the host's dense
lattice compile already needs about 30 GB): nothing falls back to the
plain versions on CUDA tensors.
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..model import ModelBag
from ..strict import note
from . import decided as D
from . import scan
from .fused_kernel import FusedScorer, path_pitch
from .lattice import compile_lattice
from .tables import grouped_tables_from_lattice, tables_from_lattice


def _indexed(d: torch.device) -> torch.device:
    """``d`` with its index: ``cuda`` is the current card."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def grouped_step_mode(mb: ModelBag, lat):
    """The grouped tables of ``mb`` when TAGDUST_TPU_GROUPED=1 asks for the
    grouped (block-banded) step mode, else None: the dense (non-zero) step
    is the default for every kernel, since it ran K1, K2 and K4 1.9-4.2x
    faster than grouped on every library measured on the H100 (8 to 96
    barcodes, PERF.md gate table).  The counterpart of
    ``TpuEngine._grouped_decomposition`` (tpu.py:508-529).  A lattice
    without a grouped form (a chain wider than 128 states, or more than 128
    segments) takes the dense mode loudly when grouped was asked for."""
    if os.environ.get("TAGDUST_TPU_GROUPED") != "1":
        return None
    g = grouped_tables_from_lattice(mb, lat)
    if g is None:
        from ..strict import fallback

        fallback(
            "grouped-step-kernel",
            ValueError(f"no block-banded form of the {lat.S}-state lattice"),
            "a chain wider than 128 states or more than 128 segments; "
            "scoring on the dense (non-zero) step kernels",
        )
    return g


def nibble_uploads() -> bool:
    """Upload reads nibble-packed (2 bases a byte)?  On by default;
    TAGDUST_TPU_NIBBLE=0 uploads plain uint8 rows instead, the A/B switch
    of the JAX package (``tpu.py:nibble_uploads``): the gain depends on the
    host-to-device link's rate against the cost of packing.  Either way the
    kernels read the same codes."""
    return os.environ.get("TAGDUST_TPU_NIBBLE", "1") == "1"


# the largest fused launch since the last reset: its reads and the bytes of
# its per-read buffers (CudaEngine.launch_bytes)
LAUNCH_STATS = {"reads": 0, "bytes": 0}

# reads padded past this length print the long-reads note (the JAX package
# scores them on its scan engine, tagdust_tpu/engine/runner.py:265-273)
LONG_READ_NT = 4096


@dataclass
class BatchResult:
    f_score: np.ndarray  # [B] log P(x|M)
    r_score: np.ndarray  # [B] log P(x|R)
    bar_prob: np.ndarray  # [B] log barcode probability
    labels: Optional[np.ndarray]  # [B, Lp+1] label path, slot 0 = 0
    mapq: np.ndarray  # [B] Q
    dust: Optional[np.ndarray] = None  # [B, 2] DUST (extracted, raw)


class CudaEngine:
    """Batched scorer for one compiled model on one torch device."""

    # device-memory budget for the buffers of the launches in flight (the
    # stack, the path, the labels; launch_bytes): a tenth of an 80 GB H100
    STACK_BYTES = 8 << 30

    def __init__(self, mb: ModelBag, device="cuda"):
        self.mb = mb
        self.device = torch.device(device)
        self.lat = compile_lattice(mb)
        self.tables = tables_from_lattice(mb, self.lat)
        self.grouped = grouped_step_mode(mb, self.lat)
        self.scorer = FusedScorer(self.tables, self.grouped)
        if self.device.type == "cuda":
            # refuse a lattice the kernels cannot run before any read is
            # scored (RuntimeError naming the bytes and the card's limit)
            for kernel in ("bwd", "fwd"):
                self.scorer.reads_per_block(kernel)
        self.scorer.to(self.device)
        t = lambda x: torch.as_tensor(x).to(self.device)  # noqa: E731
        self._bg_log = torch.log(t(self.tables["bg"]))
        self._avg_len = t(self.tables["avg_len"])
        self._bar_segments = [int(h) for h, _ in self.tables["bar_segments"]]
        T = self._label_tables()
        self._dec_tables = {
            k: t(T[k]) for k in ("is_R", "is_B", "is_F", "null_b", "alt", "seg")
        }
        self._dec_tables["is_r_full"] = t(self._is_r_label())

    def stack_budget(self) -> int:
        """This process's share of ``STACK_BYTES`` on its card: the budget
        divided among the host's processes that use the card
        (``multihost.local_cards``; all of it without a process group).
        Every sizing of a launch or sub-batch reads it."""
        from ..parallel.multihost import local_cards

        return self.STACK_BYTES // local_cards()[1]

    def on(self, device) -> "CudaEngine":
        """This compiled model on ``device``, without a second
        ``compile_lattice``: the lattice and tables shared, the scorer's
        buffers and the epilogue's tables moved.  One engine per distinct
        device, kept by the engine it was placed from; ``self`` on its own
        device."""
        device = _indexed(torch.device(device))
        placed = self.__dict__.setdefault("_placed", {_indexed(self.device): self})
        if device not in placed:
            eng = copy.copy(self)
            eng.device = device
            eng.scorer = self.scorer.placed(device)
            eng._bg_log = self._bg_log.to(device)
            eng._avg_len = self._avg_len.to(device)
            eng._dec_tables = {k: v.to(device) for k, v in self._dec_tables.items()}
            placed[device] = eng
        return placed[device]

    # ---------------- host helpers (tpu.py) ----------------
    def default_batch_tile(self) -> int:
        """Batch granularity: batches and streaming windows are padded to a
        multiple of it.  Override: TAGDUST_TPU_BT (8-row granularity)."""
        bt = os.environ.get("TAGDUST_TPU_BT")
        return max(int(bt) // 8 * 8, 8) if bt else 256

    def launch_bytes(self, B: int, Lp: int, packed: bool = False) -> int:
        """Device bytes of the per-read buffers of one fused launch over B
        reads padded to Lp: K1's stack and log scales ((Lp+1) * (S+1) * 4;
        S states wide in both step modes), K2's path (Lp * H, its rows
        padded to ``path_pitch``), dpfin, tp, the scores, the labels (int32
        from K3 and their narrow copy) and the reads; with ``packed`` also
        the label-carrying row of ``dispatch_packed``."""
        S, K = self.lat.S, int(self.tables["K"])
        H = int(self.tables["tmat"].shape[0])
        per_read = ((Lp + 1) * (S + 1) * 4 + (Lp + 1) * (4 + self._lab_bytes())
                    + 4 * (H + K + 4) + Lp)
        if packed:
            per_read += self.packed_row_bytes(Lp)
        path = path_pitch(B) * Lp * H * scan.path_dtype(H).itemsize
        return B * per_read + path

    def reads_within(self, Lp: int, budget: int, packed: bool = False) -> int:
        """The most reads of Lp whose launch stays inside ``budget`` bytes
        (0 if one read does not)."""
        nbytes = lambda b: self.launch_bytes(b, Lp, packed)  # noqa: E731
        b = budget * 16 // nbytes(16)  # within 16 of the answer
        while nbytes(b + 1) <= budget:
            b += 1
        while b > 0 and nbytes(b) > budget:
            b -= 1
        return b

    def packed_row_bytes(self, Lp: int) -> int:
        """Bytes of one label-carrying row: the labels, f, r, bar, q and the
        two DUST scores."""
        return self._lab_bytes() * (Lp + 1) + 24

    def required_finger_len(self) -> int:
        from ..extract import required_finger_length

        return required_finger_length(self.mb.rs)

    def _label_tables(self) -> dict:
        """The shared per-label decode tables (extract.label_decode_tables)."""
        from ..extract import label_decode_tables

        return label_decode_tables(self.mb, self.mb.rs)

    def _lab_bytes(self) -> int:
        """Bytes per label: int8 whenever the label values 0..H fit."""
        n_labels = int(self.tables["Lmap"].shape[1])
        return 1 if n_labels + 1 <= 127 else 4

    def _is_r_label(self) -> np.ndarray:
        """[n_labels+2] bool: does label index li label an R-segment base?"""
        n_labels = int(self.tables["Lmap"].shape[1])
        out = np.zeros(n_labels + 2, dtype=bool)
        lab_tab = np.asarray(self.mb.label, dtype=np.int64)
        types = self.mb.rs.types if self.mb.rs is not None else []
        for li in range(min(n_labels + 2, lab_tab.shape[0])):
            seg = int(lab_tab[li]) & 0xFFFF
            if seg < len(types) and types[seg] == "R":
                out[li] = True
        return out

    @staticmethod
    def threshold_f32_ceil(thr: float) -> np.float32:
        """Smallest float32 >= thr: ``q_f32 >= thr32`` on the device decides
        exactly like the host's float64 ``thr <= float64(q_f32)``."""
        t32 = np.float32(thr)
        if float(t32) < float(thr):
            t32 = np.nextafter(t32, np.float32(np.inf), dtype=np.float32)
        return t32

    # ---------------- device pipeline ----------------
    def _upload(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _upload_seqs(self, seqs: np.ndarray) -> torch.Tensor:
        """[B, Lp] codes on the device as uint8: sent nibble-packed and
        unpacked there where ``nibble_uploads`` and an even Lp allow it,
        else as they are (tpu.py:986-1000)."""
        seqs = seqs.astype(np.uint8)
        Lp = seqs.shape[1]
        if Lp % 2 or not nibble_uploads():
            return self._upload(seqs)
        return D.unpack_nibbles(self._upload(D.pack_nibbles(seqs)), Lp)

    def _full(self, seqs: torch.Tensor, lens: torch.Tensor, packed: bool = False):
        """Fused kernels + scoring epilogue (tpu.py _get_pallas.full)."""
        B, Lp = seqs.shape
        if Lp > LONG_READ_NT:
            note(
                "long-reads",
                f"reads pad to {Lp}nt > {LONG_READ_NT}nt; scoring them on the "
                f"{'CUDA kernels' if seqs.is_cuda else 'plain versions'} in "
                f"sub-batches whose buffers stay inside {self.stack_budget()} bytes",
            )
        nbytes = self.launch_bytes(B, Lp, packed)
        if nbytes > LAUNCH_STATS["bytes"]:
            LAUNCH_STATS.update(reads=B, bytes=nbytes)
        f_log, _, labels, tp = self.scorer(seqs, lens)
        r_log = scan.random_log(seqs, lens, self._bg_log, self._avg_len)
        bar = scan.bar_log(tp, self._bar_segments)
        lab_dtype = torch.int8 if self._lab_bytes() == 1 else torch.int32
        return (f_log, r_log, bar, labels.to(lab_dtype),
                scan.q_from_scores(f_log, r_log, bar))

    def run_batch(self, seqs: np.ndarray, lens: np.ndarray) -> BatchResult:
        """The scan engine: the plain versions end to end."""
        s = self._upload(seqs.astype(np.uint8))
        ln = self._upload(lens.astype(np.int32))
        sc = self.scorer
        bstack, blstack, logpb = scan.backward_pass(s, ln, sc.Abwd, sc.end, sc.begin)
        path, dpfin, f_log, tp = scan.forward_decode(
            s, ln, sc.Afwd, sc.end, sc.Lmap, sc.ent_state, sc.tmat, sc.begin,
            bstack, blstack, logpb,
        )
        labels = scan.traceback(path, dpfin)
        r_log = scan.random_log(s, ln, self._bg_log, self._avg_len)
        bar = scan.bar_log(tp, self._bar_segments)
        q = scan.q_from_scores(f_log, r_log, bar)
        n = lambda x: x.cpu().numpy()  # noqa: E731
        return BatchResult(n(f_log), n(r_log), n(bar), n(labels), n(q))

    def _pad(self, seqs: np.ndarray, lens: np.ndarray, mult: int):
        """Pad to a multiple of ``mult`` with copies of read 0: zero rows can
        be impossible reads (P(x|M)=0 -> a deliberate NaN Q)."""
        pad = (-seqs.shape[0]) % mult
        if pad:
            seqs = np.concatenate(
                [seqs, np.broadcast_to(seqs[:1], (pad, seqs.shape[1]))]
            )
            lens = np.concatenate([lens, np.broadcast_to(lens[:1], (pad,))])
        return seqs, lens

    def run_batch_fused(self, seqs: np.ndarray, lens: np.ndarray,
                        want_labels: bool = True) -> BatchResult:
        """Fused-kernel path (tpu.py run_batch_pallas), in sub-batches
        whose buffers stay inside this process's share of STACK_BYTES
        (``stack_budget``): a multiple of the batch granularity where one
        fits, else as many reads as fit, down to one.  A read whose buffers
        alone exceed the budget is refused."""
        B, Lp = seqs.shape
        BT = self.default_batch_tile()
        budget = self.stack_budget()
        max_b = self.reads_within(Lp, budget)
        if max_b == 0:
            raise RuntimeError(
                f"a read padded to {Lp}nt needs {self.launch_bytes(1, Lp)} bytes "
                f"of device buffers, over the {budget}-byte budget "
                "(CudaEngine.STACK_BYTES, this process's share)"
            )
        if max_b >= BT:
            max_b = max_b // BT * BT
        seqs, lens = self._pad(seqs, lens, BT)
        parts = []
        for s in range(0, seqs.shape[0], max_b):
            out = self._full(
                self._upload_seqs(seqs[s : s + max_b]),
                self._upload(lens[s : s + max_b].astype(np.int32)),
            )
            if not want_labels:
                out = out[:3] + (None,) + out[4:]
            parts.append(tuple(None if x is None else x.cpu() for x in out))
        cat = lambda i: (  # noqa: E731
            None if parts[0][i] is None
            else torch.cat([p[i] for p in parts]).numpy()[:B]
        )
        return BatchResult(cat(0), cat(1), cat(2), cat(3), cat(4))

    def backward_scores(self, seqs: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """[B] backward-only log P(x|M) for architecture detection
        (tpu.py:393-474): one K4 launch, no stack.  Pads to the batch
        granularity with copies of read 0."""
        B = seqs.shape[0]
        seqs, lens = self._pad(seqs, lens, self.default_batch_tile())
        out = self.scorer.score(self._upload(seqs.astype(np.uint8)),
                                self._upload(lens.astype(np.int32)))
        return out.cpu().numpy()[:B]

    def dispatch_decided(self, seqs: np.ndarray, lens: np.ndarray, thr32,
                         minlen: int) -> torch.Tensor:
        """Enqueue one decided-mode window; returns its rows on the device
        without waiting (tpu.py dispatch_pallas_decided).  The upload is
        nibble-packed unless TAGDUST_TPU_NIBBLE=0."""
        s = self._upload_seqs(seqs)
        ln = self._upload(lens.astype(np.int32))
        _, _, _, labels, q = self._full(s, ln)
        return D.decided_rows(
            s, ln, labels, q, thr32, minlen, self._dec_tables,
            self.required_finger_len(),
        )

    def dispatch_packed(self, seqs: np.ndarray, lens: np.ndarray) -> torch.Tensor:
        """Enqueue one label-carrying window; returns its rows on the device
        without waiting (tpu.py dispatch_pallas / _get_pallas_packed): one
        uint8 row per read, ``labels (lab_bytes * (Lp + 1)) | f, r, bar, q,
        dust_extracted, dust_raw`` (6 f32)."""
        B = seqs.shape[0]
        s = self._upload(seqs.astype(np.uint8))
        ln = self._upload(lens.astype(np.int32))
        f, r, bar, labels, q = self._full(s, ln, packed=True)
        dust = D.dust_scores(s, labels, ln, self._dec_tables["is_r_full"])
        sc = torch.cat([torch.stack([f, r, bar, q], dim=1).float(), dust], dim=1)
        return torch.cat(
            [labels.contiguous().view(torch.uint8).reshape(B, -1),
             sc.contiguous().view(torch.uint8).reshape(B, 24)], dim=1)

    def collect_packed(self, rows, n: int, Lp: int) -> BatchResult:
        """Parse one fetched window of label-carrying rows back to host
        arrays (tpu.py collect_pallas)."""
        a = np.asarray(rows)[:n]
        lab_bytes = self._lab_bytes()
        lw = lab_bytes * (Lp + 1)
        labs = np.ascontiguousarray(a[:, :lw])
        labels = (labs.view(np.int8) if lab_bytes == 1
                  else labs.view(np.int32).reshape(n, Lp + 1))
        sc = np.ascontiguousarray(a[:, lw : lw + 24]).view(np.float32)
        return BatchResult(sc[:, 0], sc[:, 1], sc[:, 2], labels, sc[:, 3],
                           sc[:, 4:6])
