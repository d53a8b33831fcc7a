"""Each process's cards and its share of a card's budget
(``tagdust_tpu_torch/parallel/multihost.py``: ``card_layout``,
``local_rank_and_world``, ``local_cards``; ``mesh.local_devices``;
``CudaEngine.stack_budget``), on the CPU with the card count, the process
group and torchrun's ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` patched:

* ``card_layout`` for (cards, local processes) = (8, 8), (8, 2), (2, 3),
  (1, 2): disjoint lists whose union is every card where the cards are at
  least the processes, round robin sharing where they are fewer;
* every site that sizes a launch or a sub-batch (the one-shot batches, the
  mesh scorer and its sub-batches, the streaming windows, the E-step's
  sub-batches) reads the same share;
* without a group every card and the whole budget, as before;
* a ``-coordinator`` group finds its host's processes from the host names,
  gathered once per group by ``init_multihost`` and nowhere else, and
  ``init_multihost`` makes the first card current; a group it has not seen
  raises at every sizing site rather than gather there.
"""

import numpy as np
import pytest
import torch

from tagdust_tpu_torch.engine import runner
from tagdust_tpu_torch.engine.cuda import CudaEngine
from tagdust_tpu_torch.parallel import mesh, multihost
from tagdust_tpu_torch.parallel.mesh import ShardedScorer

from test_torch_label_stream import batch_inputs, model
from test_torch_mesh import _Param

SPECS = ["B:ACGTAC,TGCATG,CCAAGG", "R:N"]


@pytest.mark.parametrize("n_cards,procs", [(8, 8), (8, 2), (2, 3), (1, 2)])
def test_card_layout(n_cards, procs):
    layouts = [multihost.card_layout(r, procs, n_cards) for r in range(procs)]
    cards = [c for cs, _ in layouts for c in cs]
    assert sorted(set(cards)) == list(range(n_cards))
    if n_cards >= procs:
        assert sorted(cards) == list(range(n_cards))  # disjoint
        assert all(share == 1 for _, share in layouts)
        for r, (cs, _) in enumerate(layouts):
            assert cs == list(range(r, n_cards, procs))
    else:
        for r, (cs, share) in enumerate(layouts):
            assert cs == [r % n_cards]
            assert share == sum(q % n_cards == r % n_cards for q in range(procs))


def _cards(monkeypatch, n_cards):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: n_cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)


def _group(monkeypatch, rank, world, local=None):
    """A process group of ``world`` with this process at ``rank``, and
    torchrun's LOCAL_* (``local`` = (local rank, local world)) or none."""
    monkeypatch.setattr(multihost, "rank_and_world", lambda: (rank, world))
    monkeypatch.setattr(multihost, "_LOCAL", {})
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    if local is not None:
        monkeypatch.setenv("LOCAL_RANK", str(local[0]))
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local[1]))


def test_no_group_gives_every_card_and_the_whole_budget(monkeypatch):
    _cards(monkeypatch, 4)
    monkeypatch.setenv("LOCAL_RANK", "1")  # set, but no group: ignored
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert mesh.local_devices() == [torch.device("cuda", i) for i in range(4)]
    assert multihost.local_cards()[1] == 1
    eng = CudaEngine(model(SPECS), "cpu")
    assert eng.stack_budget() == eng.STACK_BYTES


@pytest.mark.parametrize("n_cards,local,cards,share", [
    (8, (3, 8), [3], 1), (8, (1, 2), [1, 3, 5, 7], 1), (2, (2, 3), [0], 2),
    (1, (1, 2), [0], 2), (0, (1, 2), [], 2)])
def test_group_layout_from_torchrun(monkeypatch, n_cards, local, cards, share):
    _cards(monkeypatch, n_cards)
    _group(monkeypatch, local[0] + 4, 16, local)
    assert mesh.local_devices() == [torch.device("cuda", i) for i in cards]
    assert multihost.local_cards()[1] == share


def test_host_names_find_the_local_processes(monkeypatch):
    """A ``-coordinator`` group sets no LOCAL_*: ``init_multihost`` gathers
    the host names once, makes the first card current, and every later
    read of the layout uses the cache."""
    _cards(monkeypatch, 8)
    _group(monkeypatch, 2, 4)
    gathers, current = [], []

    def gather(out, name):
        gathers.append(name)
        out[:] = ["a", "b", "a", "a"]

    monkeypatch.setattr(multihost.dist, "all_gather_object", gather)
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(multihost.dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(multihost.dist, "get_rank", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    assert multihost.init_multihost("127.0.0.1:1", 4, 2) == (2, 4)
    assert current == [1] and len(gathers) == 1
    assert multihost.local_rank_and_world() == (1, 3)
    assert mesh.local_devices() == [torch.device("cuda", i) for i in (1, 4, 7)]
    assert multihost.local_cards()[1] == 1
    assert multihost.init_multihost() == (2, 4)  # idempotent: no second gather
    assert len(gathers) == 1


def test_a_group_without_its_layout_raises_and_gathers_nothing(monkeypatch):
    """Reading the layout is no collective: in a group of several processes
    that ``init_multihost`` has not seen and torchrun has not described,
    every sizing site raises instead of gathering out of step."""
    _cards(monkeypatch, 2)
    _group(monkeypatch, 1, 2)
    gathers = []
    monkeypatch.setattr(multihost.dist, "all_gather_object",
                        lambda out, name: gathers.append(name))
    eng = CudaEngine(model(SPECS), "cpu")
    for read in (multihost.local_rank_and_world, multihost.local_cards,
                 mesh.local_devices, eng.stack_budget):
        with pytest.raises(RuntimeError, match="init_multihost"):
            read()
    assert gathers == []


@pytest.fixture
def shared(monkeypatch):
    """Four local processes on a host of two cards: each card is shared by
    two, so each process sizes by half of STACK_BYTES."""
    _cards(monkeypatch, 2)
    _group(monkeypatch, 1, 4, (1, 4))
    monkeypatch.setenv("TAGDUST_TPU_BT", "8")
    monkeypatch.setenv("TAGDUST_TPU_PIPELINE_DEPTH", "1")
    eng = CudaEngine(model(SPECS), "cpu")
    monkeypatch.setattr(eng, "STACK_BYTES", 2 * eng.launch_bytes(64, 64))
    budgets = []
    real = CudaEngine.reads_within

    def spy(self, Lp, budget, packed=False):
        budgets.append(budget)
        return real(self, Lp, budget, packed)

    monkeypatch.setattr(CudaEngine, "reads_within", spy)
    return eng, budgets


def _one_shot(eng):
    eng.run_batch_fused(*batch_inputs(16))
    return 1


def _mesh_scorer(eng):
    return 2 if runner._mesh_scorer(eng, 64, 64) is not None else 0


def _mesh_sub_batches(eng):
    runner._run_sharded(ShardedScorer(eng, ["cpu", "cpu"]), *batch_inputs(32), True)
    return 2


def _streaming(eng):
    from tagdust_tpu_torch.io.batch import ReadBatch
    from tagdust_tpu_torch.io.fastq import Read

    rng = np.random.default_rng(2)
    batch = ReadBatch.from_reads([
        Read(seq=rng.integers(0, 4, int(rng.integers(40, 60))).astype(np.uint8))
        for _ in range(200)])
    runner.run_get_label_batch(eng.mb, eng.mb.rs, batch, _Param(), 10.0)
    return 2  # the windows go through the two local shards


@pytest.mark.parametrize("site,shards", [
    (_one_shot, 1), (_mesh_scorer, 2), (_mesh_sub_batches, 2), (_streaming, 2)],
    ids=["one-shot", "mesh-scorer", "mesh-sub-batches", "streaming"])
def test_every_launch_site_reads_the_share(shared, monkeypatch, site, shards):
    eng, budgets = shared
    monkeypatch.setattr(runner, "local_devices", lambda: [torch.device("cpu")] * 2)
    monkeypatch.setattr(runner, "get_engine", lambda mb, kind: eng)
    assert eng.stack_budget() == eng.STACK_BYTES // 2
    assert site(eng) == shards
    assert budgets and set(budgets) == {eng.STACK_BYTES // 2 // shards}


def test_estep_sub_batches_read_the_share(shared):
    eng, _ = shared
    eng.STACK_BYTES = 2 * mesh.estep_bytes(eng, 3, 64) + 1  # 3 reads a share
    assert mesh.estep_reads(eng, 64) == 3
    calls = []
    backward = eng.scorer.backward
    eng.scorer.backward = lambda s, ln: calls.append(s.shape[0]) or backward(s, ln)
    seqs, lens = batch_inputs(8)
    mesh._expected_lattice_counts(eng, torch.from_numpy(seqs), torch.from_numpy(lens))
    assert calls == [3, 3, 2]
