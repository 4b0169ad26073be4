"""A whole run of the harness at a small size on the CPU (the program's
plain screens), past the look for a card: a sound program is correct; the
control and the faults a cell can have are not.

The control is the program itself at one guide diff fewer than the traffic
asks (the tempting cut: a smaller DP band), held to the traffic's limits.
The faults, planted underneath the window's searches: a search that returns
its state unchanged (the last request's table), half of the batch left out
(the rows of the second contig dropped), and an answer altered where it is
produced (one row's score).  A group of guides in one request adds its own:
one guide's rows left out, two guides' ids swapped, and a row of a guide
outside the group.  One card holds the whole cell, so there is no exchange
between chips to leave out."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.harness import genome, procs, session, spec
from perfbench.harness.traffic import make_traffic
from perfbench.reference.align import Limits, Scores, windows_holding

ROOT = Path(__file__).resolve().parents[2]


def small_cell(traffic: str) -> spec.Cell:
    """The cell at a size the CPU holds: 4 guides, or 8 in groups of 4."""
    cfg = json.loads((ROOT / "perfbench/configs/grch38.json").read_text())
    cfg["contigs"] = [["chr1", 300_000], ["chr2", 200_000], ["chrM", 16_569]]
    cfg["searcher"]["threads"] = 2
    tr = json.loads((ROOT / f"perfbench/traffic/{traffic}.json").read_text())
    tr["guides"] = 2 * tr["guides_per_request"] if "guides_per_request" in tr else 4
    tr["margin"] = 2000
    return spec.Cell("small", 1, cfg, tr, {"wall_gbases_per_s": "Gbases/s"}, False)


@pytest.fixture(scope="module", autouse=True)
def stop_the_pool():
    yield
    procs.stop_processes()


@pytest.fixture(autouse=True)
def genome_dir(tmp_path_factory, monkeypatch):
    monkeypatch.setattr(session, "GENOME_DIR", tmp_path_factory.getbasetemp() / "genome")


def run(cell, seed=2**31 + 7, **kw):
    return session.run(cell, seed, 0.5, False, "cpu", time.perf_counter(), **kw)


def ids_of(kw) -> list:
    """The guide ids of a ``search`` call: its ``guide_specs`` or its
    ``guide_id``."""
    if kw.get("guide_specs") is not None:
        return [gid for gid, _g, _aux in kw["guide_specs"]]
    return [kw["guide_id"]]


@pytest.fixture
def searches(monkeypatch):
    """Replaces ``ResidentSearcher.search`` of the timed requests by
    ``fault(search, kwargs)``, for ``guide``/``guide_id`` and ``guide_specs``
    calls alike; set-up's searches run as they are.  Returns the keywords of
    every timed call."""
    from calitas_tpu_torch.serve import ResidentSearcher

    real = ResidentSearcher.search
    calls = []

    def install(fault):
        def search(self, **kw):
            if all(gid.lstrip("_").startswith("warmup") for gid in ids_of(kw)):
                return real(self, **kw)
            calls.append(kw)
            return fault(lambda **k: real(self, **k), kw)

        monkeypatch.setattr(ResidentSearcher, "search", search)
        return calls
    return install


@pytest.mark.parametrize("traffic", ["d3_spcas9", "d3_cas12a", "d3_four_spcas9"])
def test_a_sound_run_is_correct(traffic):
    result = run(small_cell(traffic))
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["metrics"]["wall_gbases_per_s"]["value"] > 0
    assert list(result)[-1] == "checks"


def test_an_untraced_run_traces_its_window_where_a_metric_reads_the_trace(monkeypatch):
    starts = []
    import torch

    class Profile(torch.profiler.profile):
        def start(self):
            starts.append(True)
            super().start()

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    cell = small_cell("d3_spcas9")
    traced = spec.Cell(cell.name, 1, cell.config, cell.traffic,
                       {"device_ms_per_gbase": "ms/Gbase", "setup_s": "s"}, True)
    result = run(traced)
    assert starts == [True] and result["correct"]
    assert "breakdown" not in result and "busy_s" not in result["device"]
    run(cell)
    assert starts == [True]


@pytest.mark.parametrize("traffic", ["d3_spcas9", "d3_four_spcas9"])
def test_the_control_is_not_correct(traffic):
    cell = small_cell(traffic)
    control = dict(cell.traffic["search"], max_guide_diffs=2)
    result = run(cell, search=control)
    assert not result["correct"]
    assert result["checks"]["planted_missed"]["value"] > 0


class _Stale:
    """Returns the last request's table: a search that leaves its state
    unchanged."""

    def __init__(self):
        self.last = None

    def __call__(self, search, kw):
        table = search(**kw)
        out = self.last
        if out is None:
            out = table
            for gid in ids_of(kw):
                out = out.replace(gid, "g_prev")
        self.last = table
        return out


def _half(search, kw):
    return "".join(line for line in search(**kw).splitlines(keepends=True)
                   if "\tchr2\t" not in line)


def _altered(search, kw):
    lines = search(**kw).split("\n")
    f = lines[1].split("\t")
    f[15] = str(int(f[15]) + 1)  # the score column
    lines[1] = "\t".join(f)
    return "\n".join(lines)


def _relabel(table: str, new_id) -> str:
    """The table with each row's ``guide_id`` replaced by ``new_id(id)``, and
    the row left out where that is None."""
    lines = [ln for ln in table.split("\n") if ln]
    col = lines[0].split("\t").index("guide_id")
    out = lines[:1]
    for line in lines[1:]:
        f = line.split("\t")
        f[col] = new_id(f[col])
        if f[col] is not None:
            out.append("\t".join(f))
    return "\n".join(out) + "\n"


def _one_guide_dropped(search, kw):
    first = ids_of(kw)[0]
    return _relabel(search(**kw), lambda gid: None if gid == first else gid)


def _ids_swapped(search, kw):
    a, b = ids_of(kw)[:2]
    return _relabel(search(**kw), lambda gid: {a: b, b: a}.get(gid, gid))


def _foreign_row(search, kw):
    table = search(**kw)
    first = table.split("\n")[1]
    return table + _relabel(table.split("\n")[0] + "\n" + first, lambda _gid: "g_outside"
                            ).split("\n", 1)[1]


@pytest.mark.parametrize("traffic,fault", [
    ("d3_spcas9", _Stale()), ("d3_spcas9", _half), ("d3_spcas9", _altered),
    ("d3_four_spcas9", _Stale()), ("d3_four_spcas9", _one_guide_dropped),
    ("d3_four_spcas9", _ids_swapped), ("d3_four_spcas9", _foreign_row),
], ids=["state_unchanged", "half_the_batch", "answer_altered", "group_state_unchanged",
        "group_one_guide_dropped", "group_ids_swapped", "group_foreign_row"])
def test_a_fault_is_not_correct(searches, traffic, fault):
    calls = searches(fault)
    result = run(small_cell(traffic), seed=99)
    assert calls and not result["correct"], result["checks"]


@pytest.mark.parametrize("traffic,group", [("d3_spcas9", 1), ("d3_four_spcas9", 4)])
def test_a_request_sends_its_group_the_way_its_size_asks(searches, traffic, group):
    calls = searches(lambda search, kw: search(**kw))
    cell = small_cell(traffic)
    assert run(cell)["correct"]
    for kw in calls:
        if group == 1:
            assert "guide_specs" not in kw and kw["guide"] and kw["guide_id"]
        else:
            assert "guide" not in kw and "guide_id" not in kw
            assert len(kw["guide_specs"]) == group
    ids = [gid for kw in calls for gid in ids_of(kw)]
    assert ids == [f"g{i % cell.traffic['guides']:04d}" for i in range(len(ids))]


def test_the_generator_is_the_same_on_host_and_device_and_moves_with_the_seed(tmp_path):
    a = genome.host_codes(2**32 - 1000, 5000)
    b = genome.device_codes(2**32 - 1000, 5000, "cpu").numpy()
    assert np.array_equal(a, b)
    c1 = genome.layout([("chr1", 10_000)], seed=1)[0]
    c2 = genome.layout([("chr1", 10_000)], seed=2)[0]
    assert genome.bases(c1, 0, 100) != genome.bases(c2, 0, 100)
    g = genome.Genome(genome.layout([("chr1", 1234), ("chr2", 567)], seed=3), "x", tmp_path)
    assert g.ensure("cpu") and not g.ensure("cpu")
    g.plant({"chr2": [(10, b"ACGTN")]})
    assert g.fetch("chr1", -2, 5) == "##" + genome.bases(g.contigs[0], 0, 5).decode()
    assert g.fetch("chr2", 10, 15) == "ACGTN" and g.fetch("chr2", 565, 569) == g.fetch(
        "chr2", 565, 567) + "##"
    assert g.fetch("chr3", 0, 1) is None
    text = g.path.read_text().split("\n")
    assert text[0] == ">chr1" and len(text[1]) == genome.LINE


def test_a_run_writes_back_the_sites_of_the_last_one(tmp_path):
    contigs = genome.layout([("chr1", 5000), ("chr2", 3000)], seed="x")
    g = genome.Genome(contigs, "x", tmp_path)
    g.ensure("cpu")
    clean = g.path.read_bytes()
    g.plant({"chr1": [(95, b"TTTTTTTTTTTT")], "chr2": [(7, b"GG")]})
    assert g.fetch("chr1", 95, 107) == "T" * 12 and g.path.read_bytes() != clean
    h = genome.Genome(contigs, "x", tmp_path)  # the next run
    assert not h.ensure("cpu")
    h.plant({"chr2": [(2990, b"AAAAAAAAAA")]})
    assert h.fetch("chr1", 95, 107) == genome.bases(contigs[0], 95, 12).decode()
    assert h.fetch("chr2", 2990, 3000) == "A" * 10
    h.plant({})
    assert g.path.read_bytes() == clean


def test_traffic_is_fixed_by_the_seed():
    contigs = genome.layout([("chr1", 200_000), ("chr2", 100_000)], seed=5)
    tr = json.loads((ROOT / "perfbench/traffic/d3_cas12a.json").read_text())
    tr["guides"], tr["margin"] = 3, 1000
    s = Scores.from_net_costs(-120, -260, -122, -121)
    a, b = make_traffic(contigs, tr, 5, s, 1000), make_traffic(contigs, tr, 5, s, 1000)
    assert [g.string for g in a.guides] == [g.string for g in b.guides]
    assert a.writes == b.writes
    assert all(len(g.plants) == 1 + len(tr["plants"]) + len(tr["edge_plants"]) for g in a.guides)
    assert all(g.string.startswith("tttv") and len(g.protospacer) == 23 for g in a.guides)
    c = make_traffic(contigs, tr, 6, s, 1000)
    assert [g.string for g in a.guides] != [g.string for g in c.guides]


def test_a_group_traffic_warms_up_one_group_and_refuses_a_list_of_other_length():
    contigs = genome.layout([("chr1", 200_000), ("chr2", 100_000)], seed=5)
    tr = json.loads((ROOT / "perfbench/traffic/d3_four_spcas9.json").read_text())
    tr["guides"], tr["margin"] = 8, 1000
    s = Scores.from_net_costs(-120, -260, -122, -121)
    traffic = make_traffic(contigs, tr, 5, s, 1000)
    assert [g.id for g in traffic.warmup] == ["warmup0", "warmup1", "warmup2", "warmup3"]
    assert [[g.id for g in group] for group in traffic.groups] == [
        [f"g{i:04d}" for i in range(4)], [f"g{i:04d}" for i in range(4, 8)]]
    one = dict(tr, guides=3)
    del one["guides_per_request"]
    assert [g.id for g in make_traffic(contigs, one, 5, s, 1000).warmup] == ["warmup"]
    for bad in (dict(tr, guides=6), dict(tr, guides_per_request=0)):
        with pytest.raises(ValueError, match="guides_per_request"):
            make_traffic(contigs, bad, 5, s, 1000)


def test_without_a_cuda_driver_no_flag_is_set(monkeypatch):
    from perfbench.harness import device

    def missing(name):
        raise OSError(name)

    monkeypatch.setattr(device.ctypes, "CDLL", missing)
    assert device.block_on_sync() == 0


def test_edge_plants_lie_in_one_window_only():
    contigs = genome.layout([("chr1", 400_000), ("chr2", 300_000)], seed=8)
    tr = json.loads((ROOT / "perfbench/traffic/d3_spcas9.json").read_text())
    tr["guides"], tr["margin"] = 6, 1000
    traffic = make_traffic(contigs, tr, 8, Scores.from_net_costs(-120, -260, -122, -121), 1000)
    lim = Limits(3, 1, 3, 7, 10, 1000)
    lengths = {c.name: c.length for c in contigs}
    n_edge = len(tr["edge_plants"])
    for g in traffic.guides:
        for contig, _strand, p0, p1, _score in g.plants[-n_edge:]:
            [(ws, n)] = [(s, len(b)) for s, b in traffic.writes[contig] if s <= p0 and p1 <= s + len(b)]
            assert len(windows_holding(ws, ws + n, lengths[contig], 1000, lim.step(g.string))) == 1
        assert len(g.slices) == 2


@pytest.mark.cuda
def test_a_small_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result = session.run(small_cell("d3_spcas9"), 17, 1.0, True, "cuda", time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0
