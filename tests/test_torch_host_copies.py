"""The port's copies of the host modules against the JAX package's.

``tagdust_tpu_torch`` imports nothing of ``tagdust_tpu``: it keeps its own
copies of the architecture DSL, model build, lattice compiler, calibration
and the exact engine.  On the CPU, for the 8 x 6nt library, the flagship,
the 96 x 8nt plate and the plate + a 140nt spacer, each package builds its
model from its own modules, and the two must agree exactly: the compiled
lattice, the device tables built from it, the calibrated threshold on a
seeded read set, and the exact engine's scores.
"""

import functools

import numpy as np
import pytest

import tagdust_tpu.arch as jarch
import tagdust_tpu.calibrate as jcal
import tagdust_tpu.config as jconfig
import tagdust_tpu.engine.exact as jexact
import tagdust_tpu.engine.lattice as jlattice
import tagdust_tpu.engine.runner as jrunner
import tagdust_tpu.logsum as jlogsum
import tagdust_tpu.model as jmodel
import tagdust_tpu.stats as jstats
import tagdust_tpu_torch.arch as parch
import tagdust_tpu_torch.calibrate as pcal
import tagdust_tpu_torch.config as pconfig
import tagdust_tpu_torch.engine.exact as pexact
import tagdust_tpu_torch.engine.lattice as plattice
import tagdust_tpu_torch.engine.runner as prunner
import tagdust_tpu_torch.logsum as plogsum
import tagdust_tpu_torch.model as pmodel
import tagdust_tpu_torch.stats as pstats
from tagdust_tpu_torch.engine.tables import tables_from_lattice
from tagdust_tpu_torch.flagship import (
    PLATE_PATH,
    generate_barcodes,
    load_barcodes,
    spacer,
)

PLATE = load_barcodes(PLATE_PATH)
LIBS = {
    "8x6nt": [f"B:{','.join(generate_barcodes(8, 6, 3))}", "R:N"],
    "flagship": [f"B:{','.join(load_barcodes())}", "R:N"],
    "plate": [f"B:{','.join(PLATE)}", "R:N"],
    "plate+spacer": [f"B:{','.join(PLATE)}", f"S:{spacer()}", "R:N"],
}
PKG = {
    "jax": (jarch, jmodel, jstats, jlogsum, jlattice, jexact, jcal, jconfig, jrunner),
    "port": (parch, pmodel, pstats, plogsum, plattice, pexact, pcal, pconfig, prunner),
}


def _ssi(pkg):
    _, _, stats, logsum, *_ = PKG[pkg]
    ssi = stats.SequenceStats()
    ssi.average_length = 50
    ssi.max_seq_len = 64
    ssi.background = [float(logsum.p2sp(p)) for p in (0.27, 0.24, 0.26, 0.22, 0.01)]
    ssi.mean_5_len = ssi.stdev_5_len = -1.0
    ssi.mean_3_len = ssi.stdev_3_len = -1.0
    return ssi


@functools.lru_cache(maxsize=None)
def _built(pkg, name):
    """(read structure, model, lattice) of one library, from one package."""
    arch, model, _, _, lattice, *_ = PKG[pkg]
    rs = arch.build_read_structure(LIBS[name])
    mb = model.init_model_bag(rs, _ssi(pkg), 0.05, 0.1)
    return rs, mb, lattice.compile_lattice(mb)


def _fields(obj):
    return {k: v for k, v in vars(obj).items() if not k.startswith("_")}


@pytest.mark.parametrize("name", list(LIBS))
def test_compiled_lattices_are_equal(name):
    _, jmb, jlat = _built("jax", name)
    _, pmb, plat = _built("port", name)
    assert jmb.digest() == pmb.digest()
    jf, pf = _fields(jlat), _fields(plat)
    assert jf.keys() == pf.keys()
    for k in jf:
        a, b = jf[k], pf[k]
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), k
        else:
            assert a == b, k


@pytest.mark.parametrize("name", list(LIBS))
def test_device_tables_are_equal(name):
    """``tables_from_lattice`` of the port's model and lattice against the
    same function of the JAX package's model and lattice."""
    _, jmb, jlat = _built("jax", name)
    _, pmb, plat = _built("port", name)
    a, b = tables_from_lattice(jmb, jlat), tables_from_lattice(pmb, plat)
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("name", list(LIBS))
def test_exact_engine_scores_are_equal(name):
    """The exact engine of each package on the same seeded reads: f, r and
    barcode scores and label paths equal, and the backward-only scores."""
    _, jmb, _ = _built("jax", name)
    _, pmb, _ = _built("port", name)
    rng = np.random.default_rng(3)
    L = 56
    seqs = np.zeros((24, L + 1), dtype=np.uint8)
    seqs[:, :L] = rng.integers(0, 4, (24, L))
    ja, pa = jexact.ExactEngine(jmb), pexact.ExactEngine(pmb)
    jr, pr = ja.run_batch(seqs, L), pa.run_batch(seqs, L)
    for k in ("f_score", "r_score", "bar_prob", "labels"):
        np.testing.assert_array_equal(getattr(jr, k), getattr(pr, k), err_msg=k)
    np.testing.assert_array_equal(ja.backward_only(seqs, L), pa.backward_only(seqs, L))


@pytest.mark.parametrize("name", ["8x6nt", "flagship", "plate", "plate+spacer"])
def test_calibrated_thresholds_are_equal(name):
    """``estimate_q_threshold`` of each package, seeded (``-rtest -seed 7``:
    4,000 emitted reads), each calibrating on its own exact engine's
    ``run_get_prob``: the same threshold."""
    out = {}
    for pkg in ("jax", "port"):
        *_, cal, config, runner = PKG[pkg]
        rs, _, _ = _built(pkg, name)
        param = config.parse_args(["-rtest", "-seed", "7"])
        out[pkg] = cal.estimate_q_threshold(
            param, rs, _ssi(pkg),
            lambda mb, seqs, r=runner: r.run_get_prob(mb, seqs, engine_kind="exact"))
    assert out["jax"] == out["port"]
