"""Reads on which the device engines and ``-engine exact`` decide apart.

The port's device pipeline (``-engine cuda``, and ``-engine torch``, its
plain versions) is held equal to the JAX package's scan engine, and both
differ from the exact engine, which mirrors TagDust2, on a few reads in
20,000: the barcode-entry mass of the lattice leaves out one family of
paths.  TagDust2 counts as the barcode's mass the posterior of its first
match state M0 (``MF[0,i] + MB[0,i] - b_score``, ``engine/exact.py:215-218``,
``barcode_hmm.c:4220-4268``), and its backward value ``MB[0,i]`` includes
the paths that leave M0 through the delete chain into a later match state
at the same position i (``engine/exact.py:141`` with the delete states of
``:150-155``, which take the emission of position i).  The lattice folds that
same-position delete chain into its step matrix (``engine/lattice.py:341-362``,
``Drow``), so its M0 state at position i holds only the paths that leave M0
for position i+1, and K2's entry posteriors ``tp`` (``ve * b[ent_state]``,
``engine/scan.py:250``) miss the rest.  A read whose barcode lost bases right
after its first one loses up to half its barcode mass on the device.

The same double count reaches the label posteriors (``dyn``, ``:218-250``):
the exact engine adds such a path's mass at M0 and again at M_g, both of
the barcode's label, at one position.  At ``-Q 20`` the threshold is 0.0
(with ``-Q`` given the reference leaves the per-file thresholds at 0.0,
``controller.py``), so no read flips on Q: the label DP decides, and on the
device it takes the null barcode where the exact engine takes the barcode.

These tests pin the port to the JAX scan engine and pin the fault, so that a
change of either semantics is a visible decision.  Run as a script, the file
lists the reads on which ``-engine torch`` and ``-engine exact`` decide
apart over the seeded 20,000 reads of the 8 x 6nt library and the flagship,
with Q on both engines, and the split of read 188's barcode mass:

    python tests/test_torch_exact_flips.py
"""

import os
import subprocess
import sys

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import chip_smoke as cs  # noqa: E402
from tagdust_tpu_torch.constants import DD, DM, MD  # noqa: E402
from tagdust_tpu_torch.engine import scan  # noqa: E402
from tagdust_tpu_torch.engine.cuda import CudaEngine  # noqa: E402
from tagdust_tpu_torch.engine.exact import ExactEngine  # noqa: E402
from tagdust_tpu_torch.flagship import generate_barcodes, load_barcodes  # noqa: E402

N_READS = 20000
READ = 188  # a TCTCGA read that lost the barcode's second and third bases
CODE = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 4}


def _env(**extra):
    from conftest import spawn_env

    return spawn_env(rtest=False, **extra)


def _run_port(args, prefix, engine):
    from tagdust_tpu_torch.cli.tagdust import main

    main([*args, "-o", prefix, "-engine", engine])


def test_port_equals_jax_scan_engine_on_the_8plex(tmp_path):
    """The 8 x 6nt library's 20,000 seeded reads at -Q 20: every read has
    the same outcome through the port's -engine torch and the JAX scan
    engine (JAX CLI, -engine tpu with TAGDUST_TPU_PALLAS=0)."""
    bcs = generate_barcodes(8, 6, 3)
    fq = str(tmp_path / "in.fq")
    cs.write_fastq(fq, N_READS, 0, bcs)
    args = ["-1", f"B:{','.join(bcs)}", "-2", "R:N", fq, "-Q", "20"]
    subprocess.run(
        [sys.executable, "-m", "tagdust_tpu.cli.tagdust", *args, "-o",
         str(tmp_path / "jax"), "-engine", "tpu"],
        check=True, capture_output=True, cwd=_REPO,
        env=_env(TAGDUST_TPU_PALLAS="0", TAGDUST_TPU_STRICT="1", TAGDUST_TPU_MESH="0"),
    )
    _run_port(args, str(tmp_path / "port"), "torch")
    jax_out = cs.outcomes(str(tmp_path / "jax"), bcs, N_READS)
    port_out = cs.outcomes(str(tmp_path / "port"), bcs, N_READS)
    assert (port_out >= -1).all() and (jax_out >= -1).all()
    assert int((port_out != jax_out).sum()) == 0


def read_188():
    """(model, [1, L+1] codes with the terminator, L) of read 188 of the
    seeded 8-plex input, scored against ``chip_smoke.library_model``."""
    bcs = generate_barcodes(8, 6, 3)
    rng_reads = _seeded_reads(bcs)
    seq = rng_reads[READ]
    L = len(seq)
    x = np.zeros((1, L + 1), np.uint8)
    x[0, :L] = [CODE[c] for c in seq]
    return cs.library_model(bcs), x, L


def _seeded_reads(bcs) -> list:
    """The first reads ``chip_smoke.write_fastq`` writes for seed 0 (its
    draws depend on the count, so it writes all of them)."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        fq = os.path.join(d, "in.fq")
        cs.write_fastq(fq, N_READS, 0, bcs)
        with open(fq) as fh:
            lines = fh.read().split("\n")
    return [lines[4 * i + 1] for i in range(READ + 1)]


def barcode_mass_split(mb, x, L) -> dict:
    """Read 188's scores on both engines and, per barcode HMM f, the exact
    engine's M0 posterior at position 1, its part through the same-position
    delete chain M0 -> D -> M_g, and the device's entry posterior tp."""
    ex = ExactEngine(mb, use_native=False)
    b_score, Mb, _, _ = ex.backward(x, L)
    res = ex.run_batch(x, L)
    eng = CudaEngine(mb, "cpu")
    sc = eng.scorer
    s = torch.from_numpy(x[:, :L].copy())
    ln = torch.tensor([L], dtype=torch.int32)
    bst, blst, lpb = scan.backward_pass(s, ln, sc.Abwd, sc.end, sc.begin)
    _, _, flog, tp = scan.forward_decode(s, ln, sc.Afwd, sc.end, sc.Lmap, sc.ent_state,
                                         sc.tmat, sc.begin, bst, blst, lpb)
    m0 = mb.models[0]
    c = int(x[0, 0])
    b0 = np.float64(b_score[0])
    split = []
    for f in range(m0.num_hmms):
        tr, me = m0.trans[f], m0.m_emit[f]
        # the barcode segment is first: M0 at position 1 only, from BEGIN
        mf0 = np.float64(m0.silent_to_M[f, 0] + me[0][c])
        post = np.exp(mf0 + Mb[0][f][0, 1, 0] - b0)
        chain = sum(
            np.exp(mf0 + tr[0, MD] + sum(tr[h, DD] for h in range(1, g - 1))
                   + tr[g - 1, DM] + me[g][c] + Mb[0][f][g, 1, 0] - b0)
            for g in range(2, m0.num_cols)
        )
        # ent_state holds M0 then I0 of each barcode HMM
        split.append((float(post), float(chain), float(tp[0, 2 * f])))
    return {
        "f_exact": float(res.f_score[0]), "f_device": float(flog[0]),
        "bar_exact": float(res.bar_prob[0]),
        "bar_device": float(scan.bar_log(tp, eng._bar_segments)[0]),
        "split": split,
    }


def test_read_188_scores_apart_in_the_barcode_term():
    """Read 188: the total score agrees with the exact engine, the barcode
    log-probability does not (the recorded fault)."""
    r = barcode_mass_split(*read_188())
    assert abs(r["f_device"] - r["f_exact"]) <= 1e-3
    assert abs(r["bar_device"] - r["bar_exact"]) > 0.1


def test_read_188_gap_is_the_same_position_delete_chain():
    """The exact engine's M0 posterior of every barcode HMM is the device's
    tp plus the mass of the paths M0 -> D -> M_g at the same position; for
    TCTCGA that part is about half."""
    r = barcode_mass_split(*read_188())
    for post, chain, tp in r["split"]:
        np.testing.assert_allclose(post - chain, tp, rtol=1e-3, atol=1e-9)
    post, chain, tp = r["split"][7]
    assert 0.4 < chain / post < 0.6


def label_posteriors(mb, x, L, n: int = 4):
    """([n, H] exact label posteriors ``dyn`` at positions 1..n, [n, H] the
    device's label posteriors ``plab`` of the plain K2 step) of one read."""
    import tagdust_tpu_torch.engine.exact as E

    ex = ExactEngine(mb, use_native=False)
    b_score, Mb, Ib, _ = ex.backward(x, L)
    grabbed = {}
    to_prob = E.sp2p_arr

    def grab(a):  # decode turns dyn [L+1, H, B] into probabilities once
        if a.ndim == 3:
            grabbed["dyn"] = a[:, :, 0].astype(np.float64)
        return to_prob(a)

    E.sp2p_arr = grab
    try:
        ex.decode(x, L, Mb, Ib, b_score)
    finally:
        E.sp2p_arr = to_prob
    sc = CudaEngine(mb, "cpu").scorer
    s = torch.from_numpy(x[:, :L].copy())
    ln = torch.tensor([L], dtype=torch.int32)
    bst, blst, lpb = scan.backward_pass(s, ln, sc.Abwd, sc.end, sc.begin)
    S, H = sc.end.shape[0], sc.tmat.shape[0]
    oh = scan._onehot(s)
    v = torch.zeros((1, S))
    v[0, sc.begin] = 1.0
    fls = torch.zeros(1)
    plab = []
    for k in range(n):  # the label posteriors of scan.forward_decode
        vn = (scan._expand(v, oh[:, k]) @ sc.Afwd)[:, :S]
        w = torch.exp(torch.clamp_max(fls + blst[k + 1] - lpb, 60.0))
        plab.append((((vn * bst[k + 1]) @ sc.Lmap[:, :H]) * w[:, None])[0].double())
        v, lm = scan._rescale(vn)
        fls = fls + lm
    return np.exp(grabbed["dyn"][1 : n + 1]), torch.stack(plab).numpy()


def test_read_188_label_posteriors_flip_the_label_path():
    """The same double count in the label posteriors decides the outcome
    (at -Q 20 the threshold is 0.0, so only the label path decides): at
    positions 1-2 the exact engine puts TCTCGA's label (7) above the null
    barcode's (8), the device below it, so its label DP takes the null
    barcode and leaves the read unassigned."""
    exact, device = label_posteriors(*read_188(), n=2)
    assert (exact[:, 7] > exact[:, 8]).all() and (device[:, 7] < device[:, 8]).all()
    np.testing.assert_allclose(device[:, 8], exact[:, 8], rtol=1e-3)


def _read_q(path: str) -> dict:
    """{read index: Q} from the ``;RQ:`` field of a FASTQ file's headers."""
    out = {}
    with open(path, "rb") as fh:
        for k, line in enumerate(fh):
            if k % 4 == 0:
                name, _, q = line[1:].strip().partition(b";RQ:")
                out[int(name[1:].split(b";")[0])] = float(q)
    return out


def flips(name: str, bcs, tmp: str):
    """[(read, outcome torch, Q torch, outcome exact, Q exact)] over the
    seeded reads at -Q 20 (outcome: barcode index, -1 unassigned)."""
    fq = os.path.join(tmp, f"{name}.fq")
    cs.write_fastq(fq, N_READS, 0, bcs)
    res = {}
    for eng in ("torch", "exact"):
        prefix = os.path.join(tmp, f"{name}_{eng}")
        _run_port(["-1", f"B:{','.join(bcs)}", "-2", "R:N", fq, "-Q", "20"], prefix, eng)
        q = {}
        for f in [f"{prefix}_BC_{b}.fq" for b in bcs] + [f"{prefix}_un.fq"]:
            q.update(_read_q(f))
        res[eng] = (cs.outcomes(prefix, bcs, N_READS), q)
    (ot, qt), (oe, qe) = res["torch"], res["exact"]
    return [(int(i), int(ot[i]), qt[int(i)], int(oe[i]), qe[int(i)])
            for i in np.nonzero(ot != oe)[0]]


if __name__ == "__main__":
    import tempfile

    r = barcode_mass_split(*read_188())
    print(f"read {READ}: f_score exact {r['f_exact']:.4f} device {r['f_device']:.4f}; "
          f"barcode log-probability exact {r['bar_exact']:.4f} device {r['bar_device']:.4f}")
    print("per barcode HMM: exact M0 posterior, its same-position delete-chain part, "
          "the rest, device tp")
    for f, (post, chain, tp) in enumerate(r["split"]):
        print(f"  {f}: {post:.6g} {chain:.6g} {post - chain:.6g} {tp:.6g}")
    exact, device = label_posteriors(*read_188())
    for k in range(exact.shape[0]):
        print(f"position {k + 1}: label posterior of TCTCGA (7) exact {exact[k, 7]:.4f} "
              f"device {device[k, 7]:.4f}; of the null barcode (8) exact "
              f"{exact[k, 8]:.4f} device {device[k, 8]:.4f}")
    with tempfile.TemporaryDirectory() as tmp:
        for name, bcs in (("8-plex", generate_barcodes(8, 6, 3)),
                          ("flagship", load_barcodes())):
            rows = flips(name, bcs, tmp)
            print(f"{name}: {len(rows)} of {N_READS} reads differ between -engine torch "
                  "and -engine exact at -Q 20, whose threshold is 0.0 (read, outcome "
                  "and Q on torch, on exact):")
            for row in rows:
                print("  r%d: torch %d Q %.2f, exact %d Q %.2f" % row)
