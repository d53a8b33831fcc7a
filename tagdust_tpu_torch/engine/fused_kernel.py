"""``FusedScorer``: the four DP kernels behind one module.

The counterpart of ``tagdust_tpu/engine/pallas_kernel.py:make_fused_scorer``
in both step modes: dense, or grouped (block-banded) when it is given the
tables of ``tables.grouped_tables``.  The tables are buffers, so
``.to(device)`` moves them.  For CUDA tensors each stage launches its
hand-written kernel (``csrc/fused_dp.cu``) and raises if the launch fails;
for CPU tensors it runs the plain version of ``engine/scan.py`` in the same
mode.  Nothing falls back from the card to the plain version or from one
mode to the other.

Each kernel reads its tables from one blob (``tables.staged_tables``):
K2's label-DP tables (``tables.label_tables``, with ``lab_ptr``,
``lab_idx``, ``ent_state``), which it stages in shared memory, and in the
dense mode the tables of its step matrix (``tables.sliced_tables`` of
``Ab`` for K1 and K4, of ``Af`` for K2: the heavy outputs, staged where
they fit, and the light slices, staged where they fit too).  The dense
kernels keep their carries' columns swizzled (``tables.swizzle``), so K2's
``lab_idx`` is swizzled in its dense blob.  The plain versions read the
dense matrices.

``LAUNCHES`` counts kernel launches per kernel and mode (and those of
``td_myers``, ``engine/myers.py``), so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from . import scan
from .tables import label_tables, sliced_tables, staged_tables, swizzle

LAUNCHES = {"bwd": 0, "fwd": 0, "tb": 0, "bwd_grouped": 0, "fwd_grouped": 0,
            "score": 0, "score_grouped": 0, "myers": 0}

# the plain versions' tables; the kernels read theirs from the blobs
_TABLES = ("Afwd", "Abwd", "end", "Lmap", "ent_state", "tmat")
_GROUPED = ("span", "tile_f", "tile_b", "span_of", "uexit", "wvec", "seg",
            "urows", "uent", "eent")


def _stream(dev: torch.device) -> int:
    """The current stream of ``dev``.  Every launch runs under
    ``torch.cuda.device(dev)``: the C entry points read the current device
    (``cudaGetDevice``) for its attributes and launch on it, so a shard on
    another card launches there and never on device 0 with pointers into
    its memory."""
    return torch.cuda.current_stream(dev).cuda_stream


def _buffer(module: nn.Module, name: str, x) -> None:
    module.register_buffer(name, torch.from_numpy(np.ascontiguousarray(x)))


def path_pitch(B: int) -> int:
    """Rows between K2's position slabs of the path: B rounded up to 16, so
    that K3's bulk copies of every [32, H] tile start 16-byte aligned."""
    return -(-B // 16) * 16


def _pitched(path: torch.Tensor):
    """(path, pitch) in K3's layout: [Lp, B, H] with contiguous rows,
    position slabs ``pitch`` rows apart (a multiple of 16) and a 16-byte
    aligned base.  K2's path has it; any other is copied into it."""
    Lp, B, H = path.shape
    s0, s1, s2 = path.stride()
    if (s2 == 1 and s1 == H and s0 % (16 * H) == 0 and s0 >= B * H
            and path.data_ptr() % 16 == 0):
        return path, s0 // H
    out = path.new_empty((Lp, path_pitch(B), H))
    out[:, :B] = path
    return out[:, :B], path_pitch(B)


class FusedScorer(nn.Module):
    """fn(seqs [B, Lp] uint8, lens [B] int32) ->
    (f_log [B], logP_b [B], labels [B, Lp+1] int32, tp [B, K])."""

    def __init__(self, tables: dict, grouped: dict = None):
        super().__init__()
        self.S = int(tables["S"])
        self.K = int(tables["K"])
        self.H = int(tables["tmat"].shape[0])
        self.Sr = int(tables["Ab"].shape[1])
        self.begin = int(tables["begin"])
        for name in _TABLES:
            _buffer(self, name, tables[name])
        self.grouped = grouped is not None
        self.nm = self.NU = 0
        if self.grouped:
            for name in _GROUPED:
                _buffer(self, "g_" + name, grouped[name])
            self.nm = int(grouped["uexit"].shape[0])
            self.NU = int(grouped["urows"].shape[0])
        label = dict(label_tables(tables["tmat"]),
                     **{k: tables[k] for k in ("lab_ptr", "lab_idx", "ent_state")})
        if not self.grouped:
            label["lab_idx"] = swizzle(label["lab_idx"])
        # word offsets of each blob's tables, passed to the kernels by address
        self.tabs = {}
        for k, step_matrix, lab in (("bwd", "Ab", None), ("fwd", "Af", label)):
            step = None if self.grouped else sliced_tables(tables[step_matrix], self.S)
            blob, self.tabs[k] = staged_tables(lab, step)
            _buffer(self, "blob_" + k, blob)
        self._rt = {}
        self._rt_base = {}
        self._stage = {}
        self._threads = {}

    def placed(self, device) -> "FusedScorer":
        """This scorer with its tables on ``device``: the buffers copied
        there, the host state (the blobs' word offsets, the launch geometry
        found for this card model) shared."""
        out = copy.copy(self)
        out._buffers = {k: v.to(device) for k, v in self._buffers.items()}
        return out

    def grouped_tables(self) -> dict:
        """The grouped tables as tensors (the plain versions' argument)."""
        if not self.grouped:
            return None
        return {name: getattr(self, "g_" + name) for name in _GROUPED}

    def _key(self, name: str) -> str:
        return name + "_grouped" if self.grouped else name

    # ---------------- checks and launch geometry ----------------
    def _check(self, **tensors) -> None:
        dev = self.end.device
        want = {"seqs": torch.uint8, "lens": torch.int32}
        for name, t in tensors.items():
            if t.device != dev:
                raise ValueError(f"{name} on {t.device}, tables on {dev}")
            if name in want and t.dtype != want[name]:
                raise TypeError(f"{name} must be {want[name]}, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")

    def _check_batch(self, seqs, lens) -> None:
        self._check(seqs=seqs, lens=lens)
        if lens.shape != (seqs.shape[0],):
            raise ValueError(
                f"lens shape {tuple(lens.shape)} != ({seqs.shape[0]},)"
            )

    def reads_per_block(self, kernel: str) -> int:
        """Reads per block of ``kernel`` ("bwd" for K1 and K4, "fwd"); also
        records which of its tables fit the shared memory the carries leave
        (``staged``), its threads per block, and its reads per block with no
        step table staged (``_rt_base``)."""
        if kernel not in self._rt:
            import ctypes

            from .build import lib

            fwd = kernel == "fwd"
            # staging level, one read's bytes, the card's limit, threads,
            # reads per block with no step table staged
            out = (ctypes.c_longlong * 5)()
            rt = lib().td_reads_per_block(
                int(fwd), int(self.grouped), self.S, self.Sr, self.K, self.H,
                self.nm if self.grouped else 0, self.tabs[kernel].ctypes.data,
                ctypes.addressof(out))
            if rt <= 0:
                name = "K2 (td_fwd)" if fwd else "K1 and K4 (td_bwd)"
                raise RuntimeError(
                    f"the lattice of {self.S} states does not fit the card: "
                    f"one read's carries in {name} need {out[1]} bytes of "
                    f"shared memory per block, over the card's limit of "
                    f"{out[2]} bytes; -engine torch scores it on the CPU"
                )
            self._rt[kernel] = rt
            self._stage[kernel] = int(out[0])
            self._threads[kernel] = int(out[3])
            self._rt_base[kernel] = int(out[4])
        return self._rt[kernel]

    def staged(self, kernel: str) -> int:
        """What ``kernel`` stages in shared memory: 0 nothing, 1 K2's
        label-DP tables, 2 and the dense step's heavy outputs, 3 and its
        light slices."""
        self.reads_per_block(kernel)
        return self._stage.get(kernel, 0)

    def blocks_per_sm(self, kernel: str, spill: bool = True) -> int:
        """Blocks of ``kernel`` ("bwd": K1, or K4 without ``spill``; "fwd")
        one SM holds as this scorer launches it (registers, threads and
        shared memory counted)."""
        from .build import lib

        nm, grouped, stage, rt = self._geometry(kernel)
        return lib().td_blocks_per_sm(
            int(kernel == "fwd"), int(spill), grouped, stage,
            scan.path_dtype(self.H).itemsize, self.S, self.Sr, self.K, self.H, nm,
            self.tabs[kernel].ctypes.data, rt)

    def _step_args(self, kernel: str) -> list:
        """Step matrix (the span tiles when grouped, else 0), the grouped
        step's table pointers (0 if dense), the blob and the address of its
        word offsets."""
        if self.grouped:
            tile = self.g_tile_f if kernel == "fwd" else self.g_tile_b
            args = [tile.data_ptr()] + [
                getattr(self, "g_" + n).data_ptr()
                for n in ("span", "span_of", "uexit", "wvec", "seg")
            ]
        else:
            args = [None] * 6
        blob = getattr(self, "blob_" + kernel)
        return args + [blob.data_ptr() if blob.numel() else None,
                       self.tabs[kernel].ctypes.data]

    def _geometry(self, kernel: str) -> list:
        """nm, grouped, staged, reads per block."""
        rt = self.reads_per_block(kernel)
        return [self.nm if self.grouped else 0, int(self.grouped),
                self._stage.get(kernel, 0), rt]

    # ---------------- K1 ----------------
    def backward(self, seqs: torch.Tensor, lens: torch.Tensor):
        """-> (bstack [Lp+1, B, S], blstack [Lp+1, B], logpb [B])."""
        if not seqs.is_cuda:
            return scan.backward_pass(seqs, lens, self.Abwd, self.end, self.begin,
                                      grouped=self.grouped_tables())
        from .build import check, lib

        self._check_batch(seqs, lens)
        B, Lp = seqs.shape
        dev = seqs.device
        bstack = torch.empty((Lp + 1, B, self.S), dtype=torch.float32, device=dev)
        blstack = torch.empty((Lp + 1, B), dtype=torch.float32, device=dev)
        logpb = torch.empty(B, dtype=torch.float32, device=dev)
        m, *g = self._step_args("bwd")
        with torch.cuda.device(dev):
            err = lib().td_bwd(
                seqs.data_ptr(), lens.data_ptr(), m, self.end.data_ptr(), *g,
                bstack.data_ptr(), blstack.data_ptr(), logpb.data_ptr(),
                B, Lp, self.S, self.Sr, self.begin, *self._geometry("bwd"),
                _stream(dev),
            )
        check(err, "td_bwd")
        LAUNCHES[self._key("bwd")] += 1
        return bstack, blstack, logpb

    # ---------------- K4 ----------------
    def score(self, seqs: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        """logP_b [B] of K1 without the stack (architecture detection)."""
        if not seqs.is_cuda:
            return scan.backward_scores(seqs, lens, self.Abwd, self.end, self.begin,
                                        grouped=self.grouped_tables())
        from .build import check, lib

        self._check_batch(seqs, lens)
        B, Lp = seqs.shape
        logpb = torch.empty(B, dtype=torch.float32, device=seqs.device)
        m, *g = self._step_args("bwd")
        with torch.cuda.device(seqs.device):
            err = lib().td_bwd_score(
                seqs.data_ptr(), lens.data_ptr(), m, self.end.data_ptr(), *g,
                logpb.data_ptr(), B, Lp, self.S, self.Sr, self.begin,
                *self._geometry("bwd"), _stream(seqs.device),
            )
        check(err, "td_bwd_score")
        LAUNCHES[self._key("score")] += 1
        return logpb

    # ---------------- K2 ----------------
    def forward_decode(self, seqs, lens, bstack, blstack, logpb):
        """-> (path [Lp, B, H], dpfin [B, H], f_log [B], tp [B, K]); on the
        card the path is a view whose position slabs are ``path_pitch(B)``
        rows apart."""
        if not seqs.is_cuda:
            return scan.forward_decode(
                seqs, lens, self.Afwd, self.end, self.Lmap, self.ent_state,
                self.tmat, self.begin, bstack, blstack, logpb,
                grouped=self.grouped_tables(),
            )
        from .build import check, lib

        self._check_batch(seqs, lens)
        self._check(bstack=bstack, blstack=blstack, logpb=logpb)
        B, Lp = seqs.shape
        if (tuple(bstack.shape) != (Lp + 1, B, self.S)
                or tuple(blstack.shape) != (Lp + 1, B)
                or tuple(logpb.shape) != (B,)):
            raise ValueError("stack shapes do not match the batch")
        for name, t in (("bstack", bstack), ("blstack", blstack), ("logpb", logpb)):
            if t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {t.dtype}")
        dev = seqs.device
        pdt = scan.path_dtype(self.H)
        pitch = path_pitch(B)
        path = torch.empty((Lp, pitch, self.H), dtype=pdt, device=dev)[:, :B]
        dpfin = torch.empty((B, self.H), dtype=torch.float32, device=dev)
        flog = torch.empty(B, dtype=torch.float32, device=dev)
        tp = torch.empty((B, self.K), dtype=torch.float32, device=dev)
        m, *g = self._step_args("fwd")
        entry = ([self.g_urows.data_ptr(), self.g_uent.data_ptr(),
                  self.g_eent.data_ptr()] if self.grouped else [None] * 3)
        with torch.cuda.device(dev):
            nm, grouped, staged, rt = self._geometry("fwd")
            err = lib().td_fwd(
                seqs.data_ptr(), lens.data_ptr(), m, self.end.data_ptr(), *g,
                *entry, bstack.data_ptr(), blstack.data_ptr(), logpb.data_ptr(),
                path.data_ptr(), dpfin.data_ptr(), flog.data_ptr(), tp.data_ptr(),
                B, pitch, Lp, self.S, self.Sr, self.K, self.H, self.begin, nm,
                self.NU, grouped, staged, path.element_size(), rt, _stream(dev),
            )
        check(err, "td_fwd")
        LAUNCHES[self._key("fwd")] += 1
        return path, dpfin, flog, tp

    # ---------------- K3 ----------------
    def traceback(self, path: torch.Tensor, dpfin: torch.Tensor):
        """-> labels [B, Lp+1] int32, slot 0 = 0."""
        if not path.is_cuda:
            return scan.traceback(path, dpfin)
        from .build import check, lib

        self._check(dpfin=dpfin)
        if path.device != dpfin.device:
            raise ValueError(f"path on {path.device}, dpfin on {dpfin.device}")
        Lp, B, H = path.shape
        if H != self.H or tuple(dpfin.shape) != (B, H):
            raise ValueError("path/dpfin shapes do not match the lattice")
        if (path.dtype not in (torch.int8, torch.int32)
                or dpfin.dtype != torch.float32):
            raise TypeError(f"path {path.dtype} / dpfin {dpfin.dtype}")
        labels = torch.empty((B, Lp + 1), dtype=torch.int32, device=path.device)
        path, pitch = _pitched(path)
        with torch.cuda.device(path.device):
            err = lib().td_tb(
                path.data_ptr(), dpfin.data_ptr(), labels.data_ptr(), B, pitch, Lp,
                H, path.element_size(), _stream(path.device),
            )
        check(err, "td_tb")
        LAUNCHES["tb"] += 1
        return labels

    def forward(self, seqs: torch.Tensor, lens: torch.Tensor):
        bstack, blstack, logpb = self.backward(seqs, lens)
        path, dpfin, f_log, tp = self.forward_decode(
            seqs, lens, bstack, blstack, logpb
        )
        del bstack, blstack
        return f_log, logpb, self.traceback(path, dpfin), tp
