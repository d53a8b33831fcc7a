"""The dense tables of a compiled model: the step matrices of the
backward (``Abwd``) and forward (``Afwd``) passes, the label map, the
entry states, the label transition matrix and the epilogue's tables.

Copied from the port's ``engine/tables.py`` (``tables_from_lattice``,
``tables_from_numpy``); its kernel layouts (sliced, staged, grouped and
E-step tables) are left out: the plain passes read the dense matrices.
"""

from __future__ import annotations

import numpy as np

from .lattice import Lattice, compile_lattice
from .model import ModelBag


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def tables_from_lattice(mb: ModelBag, lat: Lattice = None) -> dict:
    """The device tables of ``mb``; mirrors ``TpuEngine.__init__``."""
    lat = lat or compile_lattice(mb)
    S = lat.S
    K = lat.Aent.shape[2]
    ent_state = np.zeros(K, dtype=np.int32)
    k = 0
    si = 0
    for m in mb.models:
        for _ in range(m.num_hmms):
            if m.num_hmms > 1:
                ent_state[k] = si  # M(j,f,0)
                ent_state[k + 1] = si + 1  # I(j,f,0)
                k += 2
            si += 2 * m.num_cols
    Lmap = np.zeros((S, lat.num_labels + 1), dtype=np.float32)
    Lmap[np.arange(S), lat.state_label[:S]] = 1.0
    ent_sel = np.zeros((S, K), dtype=np.float32)
    ent_sel[ent_state, np.arange(K)] = 1.0
    # Afwd[(c,s), t] = (A | Aent)[c][s, t];  Abwd[(c,t), s] = A[c][s, t]
    Afwd = np.concatenate([lat.A, lat.Aent], axis=2).reshape(5 * S, S + K)
    Abwd = np.swapaxes(lat.A, 1, 2).reshape(5 * S, S)
    dev = {
        "Afwd": Afwd,
        "Abwd": Abwd,
        "end": lat.end,
        "Lmap": Lmap,
        "ent_state": ent_state,
        "ent_sel": ent_sel,
        "tmat": lat.tmatrix,
        "bg": lat.background,
        "avg_len": np.float32(lat.avg_len),
        "begin": lat.begin,
        "S": S,
        "K": K,
    }
    out = tables_from_numpy(dev)
    out["bar_segments"] = np.asarray(
        [(h, j) for (_, h, j) in lat.bar_segments], dtype=np.int64
    ).reshape(-1, 2)
    return out


def tables_from_numpy(dev: dict) -> dict:
    """Kernel and epilogue tables from the JAX engine's ``_dev`` arrays."""
    S = int(dev["S"])
    K = int(dev["K"])
    f32 = lambda x: np.ascontiguousarray(np.asarray(x, dtype=np.float32))  # noqa: E731
    Afwd = f32(dev["Afwd"])
    Abwd = f32(dev["Abwd"])
    Lmap = f32(dev["Lmap"])
    tmat = f32(dev["tmat"])
    H = tmat.shape[0]
    Sr = _round_up(S, 4)
    Af = np.zeros((5, Sr, S + K), dtype=np.float32)
    Af[:, :S, :] = Afwd.reshape(5, S, S + K)
    Ab = np.zeros((5, Sr, S), dtype=np.float32)
    Ab[:, :S, :] = Abwd.reshape(5, S, S)
    state_label = np.argmax(Lmap, axis=1).astype(np.int32)
    order = np.argsort(state_label, kind="stable")
    lab_idx = order[state_label[order] < H].astype(np.int32)
    lab_ptr = np.searchsorted(
        state_label[lab_idx], np.arange(H + 1)
    ).astype(np.int32)
    return {
        "Afwd": Afwd,
        "Abwd": Abwd,
        "Af": Af,
        "Ab": Ab,
        "end": f32(dev["end"]),
        "Lmap": Lmap,
        "state_label": state_label,
        "lab_ptr": lab_ptr,
        "lab_idx": lab_idx,
        "ent_state": np.asarray(dev["ent_state"], dtype=np.int32),
        "ent_sel": f32(dev["ent_sel"]),
        "tmat": tmat,
        "bg": f32(dev["bg"]),
        "avg_len": np.asarray(dev["avg_len"], dtype=np.float32),
        "begin": np.asarray(int(dev["begin"]), dtype=np.int64),
        "S": np.asarray(S, dtype=np.int64),
        "K": np.asarray(K, dtype=np.int64),
    }
