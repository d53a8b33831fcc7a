"""The E-step kernel's host side (``tagdust_tpu_torch/engine/estep.py``,
``tables.estep_tables`` / ``estep_slices``, ``parallel/mesh.py``) on the
CPU, at the size of the 8-barcode library (8 x 6nt + R:N, S = 111), a few
hundred seeded reads, Lp <= 64:

* the kernel's entry table is ``count_tables``' entries regrouped by
  destination: its ``flat`` permutation gives ``count_tables``' CT exactly;
* the table split over a cluster's blocks (``estep_slices``) holds each
  entry once with its index, each source's (rank, offset) names its state,
  and the blocks' shared bytes are balanced within one state's; each halo
  row (a state of another block that a block's entries read) has one push
  from its owner; a walk of
  the sliced table as a cluster of ``td_estep`` walks it (each block's
  items of its states, the row maximum over the blocks' maxima, f64 sums
  per cluster summed in cluster order) gives the plain version's CT and E
  at C = 1, 2 and 4 (rtol 1e-5 / atol 1e-6: f64 sums against the plain
  version's f32 ones);
* ``geometry`` takes one block of 32 reads for the flagship, a cluster of
  4 or 8 for the 96 x 8nt plate at the H100's 232,448 bytes a block, and
  raises where nothing fits;
* ``estep_bytes`` counts each route's own buffers (the kernel's partials a
  row per cluster), and the kernel's route fits more reads in a budget;
* ``_expected_lattice_counts`` on CPU tensors runs the plain version, which
  still equals the JAX trainer (rtol 1e-5 / atol 1e-6, as
  ``tests/test_torch_train.py``);
* CUDA tensors with the kernel library unloadable raise, and never reach
  the plain version;
* a card-only case holds ``td_estep`` to its plain version (rtol 1e-4 /
  atol 1e-6) and two launches to each other, bit for bit, on the 8-barcode
  library (one block) and the plate (a cluster).
"""

import functools

import numpy as np
import pytest
import torch

from tagdust_tpu_torch.engine import build, estep, fused_kernel, tables
from tagdust_tpu_torch.engine.cuda import CudaEngine
from tagdust_tpu_torch.engine.lattice import compile_lattice
from tagdust_tpu_torch.parallel import mesh

from test_torch_scan import model

RTOL, ATOL = 1e-5, 1e-6
B, LP = 300, 64


H100_OPTIN = 232_448  # cudaDevAttrMaxSharedMemoryPerBlockOptin


@functools.lru_cache(maxsize=None)
def _library():
    import chip_smoke as cs

    return model(["B:" + ",".join(cs.barcode_sets()["8"]), "R:N"], 52, 64)


@functools.lru_cache(maxsize=None)
def _entry_table(name):
    """(estep_tables, S) of the 8-barcode library, the flagship or the plate."""
    import chip_smoke as cs

    mb = _library() if name == "8" else cs.library_model(cs.barcode_sets()[name])
    lat = compile_lattice(mb)
    return tables.estep_tables(np.asarray(lat.A, np.float32)), int(lat.S)


def _slices(name, C, R=32):
    et, S = _entry_table(name)
    return tables.estep_slices(et, S, estep.split(et, S, C, R), R | 1)


def _reads(seed=7, b=B, lp=LP):
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, 4, (b, lp)).astype(np.uint8)
    seqs[rng.random((b, lp)) < 0.02] = 4  # N
    seqs[rng.random((b, lp)) < 0.005] = 9  # a code above 4: a zero step
    lens = rng.integers(20, lp + 1, b).astype(np.int32)
    lens[:3] = 0  # the zero-length pads of DistributedTrainer.run
    return seqs, lens


@pytest.fixture(scope="module")
def engine():
    return CudaEngine(_library(), "cpu")


def test_entry_table_permutation_gives_count_tables_ct(engine):
    tab = mesh.count_tables(engine.lat, "cpu")
    et = {k: v.numpy() for k, v in tab["estep"].items()}
    nnz = tab["off"][-1]
    assert np.array_equal(np.sort(et["flat"]), np.arange(nnz))
    # any mass in the kernel's entry order, written to its flat index
    mass = np.random.default_rng(1).random(nnz).astype(np.float32)
    flat = np.zeros(nnz, np.float32)
    flat[et["flat"]] = mass
    CT = mesh._dense(tab, torch.from_numpy(flat)).numpy()
    want = np.zeros_like(CT)
    A = np.asarray(engine.lat.A, np.float32)
    for c in range(5):
        items = range(et["dst_ptr"][c], et["dst_ptr"][c + 1])
        assert np.all(np.diff(et["dst"][items.start : items.stop]) > 0)
        for i in items:
            t, ents = et["dst"][i], slice(et["ent_ptr"][i], et["ent_ptr"][i + 1])
            assert np.all(np.diff(et["src"][ents]) > 0)
            np.testing.assert_array_equal(et["val"][ents], A[c, et["src"][ents], t])
            want[c, et["src"][ents], t] = mass[ents]
    np.testing.assert_array_equal(CT, want)
    assert np.count_nonzero(want) == np.count_nonzero(A)


def _block_entries(sl, j, lo, hi):
    """Entries of block j's items lo:hi (counted from its first item)."""
    io, eo = sl["item_off"][j], sl["ent_off"][j]
    ient = sl["ient"][io + j:]
    return np.arange(eo + ient[lo], eo + ient[hi])


def _rows(sl, P=33):
    """[nnz] each sliced entry's source row in its block's carry (the row
    whose ``carry_offset`` is its key)."""
    rows = np.arange(int(sl["t0"][-1]) + int(np.diff(sl["halo_off"]).max()) + 1)
    of = {int(o): r for r, o in enumerate(tables.carry_offset(rows, P))}
    return np.array([of[int(k)] for k in sl["ekey"]], dtype=np.int64)


def _sources(sl, P=33):
    """[nnz] each sliced entry's source state: its block's own row, or the
    state of its halo row."""
    row = _rows(sl, P)
    out = np.zeros(row.size, np.int64)
    for j in range(sl["t0"].size - 1):
        e = slice(sl["ent_off"][j], sl["ent_off"][j + 1])
        states = np.concatenate([np.arange(sl["t0"][j], sl["t0"][j + 1]),
                                 sl["halo"][sl["halo_off"][j]:sl["halo_off"][j + 1]]])
        out[e] = states[row[e]]
    return out


def _destinations(sl):
    """[nnz] each sliced entry's destination state, from its item."""
    C = sl["t0"].size - 1
    out = np.zeros(sl["eidx"].size, np.int64)
    for j in range(C):
        io = sl["item_off"][j]
        for i in range(sl["item_off"][j + 1] - io):
            out[_block_entries(sl, j, i, i + 1)] = sl["t0"][j] + sl["idst"][io + i]
    return out


def _cluster_walk(tab, sl, R, Q, seqs, lens, bstack, blstack, logpb):
    """The counts as a cluster of ``td_estep`` walks the sliced table, in
    float64: read tiles of R to clusters round robin; per position each
    block j's items of the bases that have reads, into its states' next
    carry and its entries' sums; the row maximum over the blocks' maxima;
    each cluster's sums to their index, summed in cluster order, the mass
    to its flat index and E from the entries."""
    et = {k: v.numpy() for k, v in tab["estep"].items()}
    bstack, blstack, logpb = (x.double().numpy() for x in (bstack, blstack, logpb))
    S, nnz, C = tab["S"], tab["off"][-1], sl["t0"].size - 1
    src, dst = _sources(sl), _destinations(sl)
    part = np.zeros((Q, nnz))
    for tile in range(-(-seqs.shape[0] // R)):
        rows = np.arange(tile * R, min(seqs.shape[0], tile * R + R))
        sums = np.zeros(nnz)  # this tile's cluster: each entry's sum in its block
        v = np.zeros((rows.size, S))
        v[:, tab["begin"]] = 1.0
        ls = np.zeros(rows.size)
        for k in range(int(lens[rows].max(initial=0))):
            act = k < lens[rows]
            code = np.minimum(seqs[rows, k], 5)
            w = np.exp(np.minimum(ls + blstack[k + 1][rows] - logpb[rows], 60.0)) * act
            b = bstack[k + 1][rows]
            vn = np.zeros_like(v)
            for j in range(C):
                for c in range(5):
                    r = np.nonzero(act & (code == c))[0]
                    if not r.size:
                        continue
                    e = _block_entries(sl, j, sl["ibase"][j, c], sl["ibase"][j, c + 1])
                    flow = v[r][:, src[e]] * sl["eval"][e]  # [reads, entries]
                    np.add.at(vn, (r[:, None], dst[e][None, :]), flow)
                    sums[e] += w[r] @ (flow * b[r][:, dst[e]])
            pmax = np.stack([vn[:, a:z].max(axis=1)
                             for a, z in zip(sl["t0"][:-1], sl["t0"][1:])])
            m = pmax.max(axis=0)
            m = np.where(m > 0, m, 1.0)
            step = act & (code < 5)
            v = np.where(act[:, None], np.where(step[:, None], vn / m[:, None], 0.0), v)
            ls = np.where(step, ls + np.log(m), ls)
        part[tile % Q, sl["eidx"]] += sums
    total = part.sum(axis=0)
    mass = np.zeros(nnz)
    mass[et["flat"]] = total
    E = np.zeros((5, S))
    base_of = np.repeat(np.arange(5), np.diff(et["dst_ptr"]))
    np.add.at(E, (base_of, et["dst"]), np.add.reduceat(total, et["ent_ptr"][:-1]))
    return mass, E


@pytest.mark.parametrize("C", [1, 2, 4])
def test_table_walk_gives_the_plain_counts(engine, C):
    seqs, lens = _reads()
    s, ln = torch.from_numpy(seqs), torch.from_numpy(lens)
    tab = mesh.count_tables(engine.lat, "cpu")
    stack = engine.scorer.backward(s, ln)
    ct, e = mesh.Kahan(tab["off"][-1], "cpu"), mesh.Kahan((5, tab["S"]), "cpu")
    estep.forward_counts_plain(tab, s, ln, *stack, ct, e)
    mass, E = _cluster_walk(tab, _slices("8", C), 32, 3, seqs, lens, *stack)
    np.testing.assert_allclose(mass, ct.sum.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(E, e.sum.numpy(), rtol=RTOL, atol=ATOL)
    # each base of a possible read carries mass 1; a read with a code above
    # 4 is impossible (its backward values are 0 through the zero step), and
    # its mass 0 although the clamp at 60 lets w reach e^60
    possible = ~((seqs > 4) & (np.arange(LP) < lens[:, None])).any(axis=1)
    assert 0 < possible.sum() < B
    n = float(lens[possible].sum())
    np.testing.assert_allclose([mass.sum(), E.sum()], [n, n], rtol=1e-4)


@pytest.mark.parametrize("name,C", [("8", 1), ("8", 2), ("8", 4), ("flagship", 8),
                                    ("plate", 4), ("plate", 8)])
def test_slices_hold_each_entry_once(name, C):
    """Each entry once, with its index in the entry table (so its flat index
    and value), under an item of its destination; per block and base one
    item a state, by entry count descending, the heavy ones first."""
    et, S = _entry_table(name)
    sl = _slices(name, C)
    nnz = et["src"].size
    assert np.array_equal(np.sort(sl["eidx"]), np.arange(nnz))
    assert np.array_equal(sl["eval"], et["val"][sl["eidx"]])
    dst_of = np.repeat(et["dst"], np.diff(et["ent_ptr"]))
    assert np.array_equal(_destinations(sl), dst_of[sl["eidx"]])
    base_of = np.repeat(np.repeat(np.arange(5), np.diff(et["dst_ptr"])),
                        np.diff(et["ent_ptr"]))
    for j in range(C):
        width = sl["t0"][j + 1] - sl["t0"][j]
        assert np.array_equal(sl["ibase"][j], np.arange(6) * width)
        for c in range(5):
            lo, hi = sl["ibase"][j, c], sl["ibase"][j, c + 1]
            items = sl["idst"][sl["item_off"][j] + lo:sl["item_off"][j] + hi]
            assert np.array_equal(np.sort(items), np.arange(width))
            n = np.diff(sl["ient"][sl["item_off"][j] + j + lo:][:hi - lo + 1])
            assert np.all(np.diff(n) <= 0)
            assert sl["nheavy"][j, c] == (n > tables.HEAVY_ENTRIES).sum()
            e = _block_entries(sl, j, lo, hi)
            assert np.all(base_of[sl["eidx"][e]] == c)
            # ascending source within each item: et's order kept
            starts = sl["ient"][sl["item_off"][j] + j + lo:][:hi - lo + 1]
            for a, z in zip(starts[:-1], starts[1:]):
                assert np.all(np.diff(sl["eidx"][sl["ent_off"][j] + a:sl["ent_off"][j] + z]) == 1)


@pytest.mark.parametrize("name,C", [("8", 2), ("8", 4), ("flagship", 8), ("plate", 4),
                                    ("plate", 8)])
def test_remote_sources_name_their_state(name, C):
    """Each entry's source row decodes to its source state; a block's halo
    rows are the states of other blocks that its entries read, ascending,
    and each has one push from the block that owns the state: its row of
    the state, and the halo row's offset in the reader.  At the plate most
    sources lie in the entry's own block."""
    et, S = _entry_table(name)
    sl = _slices(name, C)
    P = 33
    assert np.array_equal(_sources(sl), et["src"][sl["eidx"]])
    rank = np.repeat(np.arange(C), np.diff(sl["t0"]))
    owner = np.repeat(np.arange(C), np.diff(sl["ent_off"]))
    pushes = {}
    for j in range(C):
        for ps in sl["push"][sl["push_off"][j]:sl["push_off"][j + 1]]:
            q, off = int(ps[1]) >> 24, int(ps[1]) & 0xFFFFFF
            assert (q, off) not in pushes and q != j
            pushes[q, off] = (j, int(ps[0]))
    halo_rows = 0
    for q in range(C):
        halo = sl["halo"][sl["halo_off"][q]:sl["halo_off"][q + 1]]
        assert np.all(np.diff(halo) > 0) and np.all(rank[halo] != q)
        wd = sl["t0"][q + 1] - sl["t0"][q]
        for h, st in enumerate(halo):
            j, row = pushes[q, int(tables.carry_offset(wd + h, P))]
            assert j == rank[st] and row == tables.carry_offset(st - sl["t0"][j], P)
        halo_rows += halo.size
    assert len(pushes) == halo_rows > 0
    local = float((rank[_sources(sl)] == owner).mean())
    assert 0 < local < 1
    if name == "plate":
        assert local > 0.85


@pytest.mark.parametrize("name,C", [("8", 2), ("8", 4), ("flagship", 8), ("plate", 4),
                                    ("plate", 8)])
def test_slices_are_balanced(name, C):
    """Each block's shared bytes, its halo rows included, lie within the
    largest state's bytes of the blocks' mean (``slice_bounds``' margin over
    the weights ``split`` gives); at the plate the entries per block too,
    within 6% of nnz / C (the last block holds the five 98-entry items)."""
    et, S = _entry_table(name)
    sb = tables.estep_state_bytes(et, S, 33)
    sl = _slices(name, C)
    per = tables.estep_block_bytes(et, S, sl["t0"], 33)
    assert np.all(np.abs(per - per.mean()) <= sb.max())
    if name == "plate":
        ne = np.diff(sl["ent_off"])
        assert np.all(np.abs(ne - ne.sum() / C) <= 0.06 * ne.sum() / C)


def test_geometry_per_lattice():
    """At the H100's 232,448 bytes a block: the flagship in one block of 32
    reads, the plate in a cluster of 4 or 8 blocks of 32 reads; each block's
    carries, table and static part inside the card; nothing fits 16 KB."""
    et, S = _entry_table("flagship")
    g = estep.geometry(et, S, H100_OPTIN)
    assert (g["C"], g["R"], g["P"]) == (1, 32, 33)
    assert list(g["t0"]) == [0, S]
    et, S = _entry_table("plate")
    g = estep.geometry(et, S, H100_OPTIN)
    assert g["C"] in (4, 8) and g["R"] == 32
    assert estep.STATIC_SMEM + g["smem"] <= H100_OPTIN
    assert g["smem"] % 16 == 0
    # the largest block's carries (rows and halo rows of P floats, a padding
    # word after each 32), pushes, items and entries, as the kernel lays
    # them out
    sl = tables.estep_slices(et, S, g["t0"], g["P"])
    width, ne = np.diff(g["t0"]), np.diff(sl["ent_off"])
    nh, npush = np.diff(sl["halo_off"]), np.diff(sl["push_off"])
    words = (tables.carry_offset(width + nh - 1, g["P"])
             + tables.carry_offset(width - 1, g["P"]) + 2 * g["P"])
    need = 8 * ((words + 1) // 2) + 14 * ne + 8 * npush + 4 * 5 * width + 2
    assert np.array_equal(need, tables.estep_block_bytes(et, S, g["t0"], g["P"]))
    assert need.max() <= g["smem"] < need.max() + 16
    with pytest.raises(RuntimeError, match="does not fit td_estep"):
        estep.geometry(et, S, 16 << 10)


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_estep_bytes_count_each_routes_buffers(engine, route, monkeypatch):
    S, Lp = engine.lat.S, LP
    nnz = [int(np.count_nonzero(engine.lat.A[c])) for c in range(5)]
    both = (Lp + 1) * (S + 1) * 4 + 4 + Lp + 4
    if route == "plain":
        per = both + 16 * Lp + 4 * (2 * S + 4) + 4 * (3 * max(nnz) + 4 * S)
        fixed = 0
        eng = engine
    else:
        eng = CudaEngine(_library(), "cpu")
        eng.device = torch.device("cuda", 0)
        seen = []
        monkeypatch.setattr(estep, "optin_bytes", lambda d: H100_OPTIN)
        monkeypatch.setattr(estep, "launch_clusters",
                            lambda g, d: seen.append((g["C"], g["R"])) or 131)
        per = both
        fixed = 8 * 131 * sum(nnz) + 4 * sum(nnz) + 4 * 5 * S
    assert mesh.estep_bytes(eng, 0, Lp) == fixed
    assert mesh.estep_bytes(eng, 1000, Lp) == 1000 * per + fixed
    budget = eng.stack_budget()
    assert mesh.estep_reads(eng, Lp) == (budget - fixed) // per
    assert mesh.estep_bytes(eng, mesh.estep_reads(eng, Lp), Lp) <= budget
    assert mesh.estep_bytes(eng, mesh.estep_reads(eng, Lp) + 1, Lp) > budget
    if route == "kernel":  # no per-read temporaries: more reads a sub-batch
        assert mesh.estep_reads(eng, Lp) > mesh.estep_reads(engine, Lp)
        assert seen == [(1, 32)]  # the geometry once, kept on the engine


def _jax_counts(mb, seqs, lens):
    import jax

    from tagdust_tpu.engine.tpu import TpuEngine
    from tagdust_tpu.parallel.mesh import DistributedTrainer as JaxTrainer
    from tagdust_tpu.parallel.mesh import make_mesh

    return JaxTrainer(TpuEngine(mb), make_mesh(jax.devices()[:1])).run(seqs, lens)


@pytest.mark.parametrize("seed", [7, 8])
def test_cpu_tensors_run_the_plain_version_equal_to_jax(engine, seed, monkeypatch):
    seqs, lens = _reads(seed, b=96)
    seqs = np.minimum(seqs, 4)  # the JAX one-hot takes codes 0-4
    calls = []
    plain = estep.forward_counts_plain
    monkeypatch.setattr(estep, "forward_counts_plain",
                        lambda *a: calls.append(a[1].shape[0]) or plain(*a))
    monkeypatch.setattr(estep, "forward_counts_cuda",
                        lambda *a: pytest.fail("the kernel on CPU tensors"))
    CT, E, n = mesh._expected_lattice_counts(
        engine, torch.from_numpy(seqs), torch.from_numpy(lens))
    assert calls == [96]
    CTj, Ej, nj = _jax_counts(engine.mb, seqs, lens)
    assert int(n) == nj == int(lens.sum())
    np.testing.assert_allclose(CT.numpy(), CTj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(E.numpy(), Ej, rtol=RTOL, atol=ATOL)


def test_cuda_tensors_raise_without_the_kernel(engine, monkeypatch):
    """No fallback: on CUDA tensors (stubs here) whose kernel library cannot
    load, the E-step raises and never runs the plain version."""

    class OnCard:
        is_cuda = True
        device = torch.device("cuda", 0)
        shape = (4, LP)

        def contiguous(self):
            return self

    def unloadable():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(build, "lib", unloadable)
    monkeypatch.setattr(estep, "forward_counts_plain",
                        lambda *a: pytest.fail("the plain version on CUDA tensors"))
    tab = mesh.count_tables(engine.lat, "cpu")
    ct, e = mesh.Kahan(tab["off"][-1], "cpu"), mesh.Kahan((5, tab["S"]), "cpu")
    before = fused_kernel.LAUNCHES["estep"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        estep.forward_counts(tab, *(OnCard() for _ in range(5)), ct, e)
    assert fused_kernel.LAUNCHES["estep"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["8", "plate"])
def test_td_estep_equals_its_plain_version(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke as cs

    mb = _library() if name == "8" else cs.library_model(cs.barcode_sets()[name])
    eng = CudaEngine(mb, "cuda")
    seqs, lens = _reads(b=2048)
    s, ln = torch.from_numpy(seqs).cuda(), torch.from_numpy(lens).cuda()
    tab = mesh.count_tables(eng.lat, s.device)
    stack = eng.scorer.backward(s, ln)
    g = estep.launch_plan(tab, s.device)
    assert (g["C"], g["R"]) == ((1, 32) if name == "8" else (g["C"], 32))
    assert g["C"] in ((1,) if name == "8" else (4, 8)) and g["clusters"] >= 1
    before = fused_kernel.LAUNCHES["estep"]
    got = [estep.forward_counts_cuda(tab, s, ln, *stack) for _ in range(2)]
    torch.cuda.synchronize()
    assert fused_kernel.LAUNCHES["estep"] == before + 2
    for a, b in zip(*got):
        assert torch.equal(a, b)
    ct, e = mesh.Kahan(tab["off"][-1], s.device), mesh.Kahan((5, tab["S"]), s.device)
    estep.forward_counts_plain(tab, s, ln, *stack, ct, e)
    np.testing.assert_allclose(got[0][0].cpu().numpy(), ct.sum.cpu().numpy(),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[0][1].cpu().numpy(), e.sum.cpu().numpy(),
                               rtol=1e-4, atol=1e-6)
