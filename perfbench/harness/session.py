"""One run of a cell: the set-up's fixed steps, the measured window of
``ResidentSearcher.search`` calls, the trace, the metrics and the check.

Set-up is five timed steps, printed one line each:

1. ``traffic``: the traffic's guides, planted sites and searched slices are
   drawn from the seed;
2. ``genome``: the configuration's genome is generated on the device and
   written as FASTA, ``.fai`` and ``.dict`` under ``perfbench/.genome/``, in
   a cell's first run in a checkout; later runs find it there
   (``genome_cached``) (:mod:`perfbench.harness.genome`);
3. ``plant``: the last run's planted sites are written back to the genome's
   bases and this run's are written in;
4. ``stage``: ``ResidentSearcher`` is built, which stages every contig from
   the FASTA on the device;
5. ``warmup``: ``ResidentSearcher.warmup()`` (the kernels' build, the finish
   pool's spawn), then one search of a group of the cell's own traffic that
   the window does not send.

``setup_s`` runs from the process's start to the first timed request.  A
``torch.profiler`` trace of the window is taken with ``--trace 1``, and
without it where an end-to-end metric is read from the trace.  The
window is a closed loop with one client: the list's next group of
``guides_per_request`` guides (one guide, or a ``guide_specs`` group) is
searched as soon as the last search returns, until ``seconds`` have passed;
the window ends when the last search returns.  A search that raises, or that
counts a degradation in ``utils.DEGRADED``, has failed.
"""

from __future__ import annotations

import gc
import logging
import re
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Optional

from perfbench.harness import genome as genome_mod
from perfbench.harness import spec, work
from perfbench.harness.trace import TraceSummary, events_of, summarize
from perfbench.harness.traffic import make_traffic
from perfbench.reference.align import Limits, Scores
from perfbench.reference.check import check_request, split_by_guide

#: top-level modules that may not be loaded in a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "calitas_tpu")

_SCREEN = re.compile(r"Screen .+: (\d+) of (\d+) windows are candidates")
_PHASES = (("Reference windows processed.", "reference_done"),
           ("Sorting and Outputting.", "finalize_start"), ("Done:", "done"))
#: the program's logger whose records mark a request's phases
PROGRAM_LOGGER = "calitas_tpu_torch.SearchReference"


class Marks(logging.Handler):
    """Keeps the times of the program's phase records and its screen counts;
    while a trace is taken, also marks each phase record in it."""

    def __init__(self):
        super().__init__(level=logging.INFO)
        self.records: list = []
        self.tracing = False

    def emit(self, record: logging.LogRecord) -> None:
        msg = record.getMessage()
        if _SCREEN.match(msg):
            kind = "screen"
        else:
            kind = next((k for prefix, k in _PHASES if msg.startswith(prefix)), None)
            if kind is None:
                return
        self.records.append((time.perf_counter(), kind, msg))
        if self.tracing and kind != "screen":
            import torch

            with torch.profiler.record_function(f"perfbench:{kind}"):
                pass


@dataclass
class Request:
    guide_ids: tuple  # the guides of the search
    t0: float
    t1: float
    gbases: float  # genome bases x guides of the search, in 1e9
    least_s: float  # the search's least time on the card (harness/work.py)
    error: Optional[str]
    table: Optional[str]
    marks: list = field(default_factory=list)

    @property
    def wall(self) -> float:
        return self.t1 - self.t0

    def mark(self, kind: str) -> Optional[float]:
        return next((t for t, k, _m in self.marks if k == kind), None)

    def screened(self) -> tuple:
        """(candidate windows, windows) over the search's screen records."""
        cand = total = 0
        for _t, k, msg in self.marks:
            if k == "screen":
                n, m = _SCREEN.match(msg).groups()
                cand, total = cand + int(n), total + int(m)
        return cand, total


@dataclass
class Window:
    """What the metric readers read (``perfbench/metrics/<name>.py``)."""

    requests: list
    seconds: float  # the first request's start to the last one's end
    setup_s: float
    launches: dict  # kernel launches in the window, by kernel
    trace: Optional[TraceSummary]

    @property
    def done(self) -> list:
        return [r for r in self.requests if r.error is None]


def limits(traffic: dict, search: dict, window: int) -> Limits:
    return Limits(
        max_guide_diffs=search["max_guide_diffs"],
        max_pam_mismatches=search["max_pam_mismatches"],
        max_gaps_between_guide_and_pam=search["max_gaps_between_guide_and_pam"],
        max_total_diffs=search["max_guide_diffs"] + search["max_pam_mismatches"]
        + search["max_gaps_between_guide_and_pam"],
        max_overlap=traffic["max_overlap"], window=window,
    )


def search_group(searcher, group: list, search: dict) -> str:
    """The table of one request for the guides ``group``: one guide as
    ``guide``/``guide_id``, more as one ``guide_specs`` group."""
    if len(group) == 1:
        g = group[0]
        return searcher.search(guide=g.string, guide_id=g.id, output=None, **search)
    return searcher.search(guide_specs=[(g.id, g.string, ()) for g in group], output=None,
                           **search)


def request_work(cfg: dict, lim: Limits, group: list) -> tuple:
    """``(gbases, least_s)`` of a search for ``group``: genome bases x the
    group's guides, in 1e9, and the least time on the card
    (:func:`perfbench.harness.work.least_seconds`).  A traffic's guides have
    one shape, so the first guide's is the group's."""
    lengths = [n for _name, n in cfg["contigs"] if n >= 2]
    window = cfg["searcher"]["window_size"]
    g = group[0]
    return (len(group) * sum(lengths) / 1e9,
            work.least_seconds(lengths, lim.step(g.string), window, len(g.protospacer),
                               guides=len(group)))


def _sync(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def say(line: str) -> None:
    print(line, flush=True)
    print(line, file=sys.stderr, flush=True)


#: the configurations' genomes, made by a cell's first run in a checkout
GENOME_DIR = spec.HERE / ".genome"


class Setup:
    """The set-up's steps for one seed; :meth:`close` frees what they made."""

    def __init__(self, cell: spec.Cell, seed: int, device: str):
        from calitas_tpu_torch.serve import ResidentSearcher

        cfg = cell.config
        self.scores = Scores.from_net_costs(**{k: cfg["searcher"][k] for k in (
            "guide_mismatch_net_cost", "pam_mismatch_net_cost", "genome_gap_net_cost",
            "guide_gap_net_cost")})
        self.searcher = None
        t = time.perf_counter()
        # the bases are the configuration's own; the seed draws the traffic
        contigs = genome_mod.layout([tuple(c) for c in cfg["contigs"]], cfg["assembly"])
        self.traffic = make_traffic(contigs, cell.traffic, seed, self.scores,
                                    cfg["searcher"]["window_size"])
        self.genome = genome_mod.Genome(contigs, cfg["assembly"], GENOME_DIR)
        t = self._step("traffic", t)
        try:
            made = self.genome.ensure(device)
            _sync(device)
            t = self._step("genome" if made else "genome_cached", t)
            self.genome.plant(self.traffic.writes)
            t = self._step("plant", t)
            self.searcher = ResidentSearcher(self.genome.path, engine="gpu", device=device,
                                             **cfg["searcher"])
            _sync(device)
            t = self._step("stage", t)
            self.searcher.warmup()
            search_group(self.searcher, self.traffic.warmup, cell.traffic["search"])
            _sync(device)
            self._step("warmup", t)
        except BaseException:
            self.close()
            raise

    def _step(self, name: str, t: float) -> float:
        now = time.perf_counter()
        say(f"# setup {name} {now - t:.4f} s")
        return now

    def close(self) -> None:
        self.searcher = None
        gc.collect()
        self.genome.close()


def measure(setup: Setup, cell: spec.Cell, seconds: float, search: dict, marks: Marks,
            profiler=None) -> list:
    """The window: searches back to back until ``seconds`` have passed."""
    import torch

    from calitas_tpu_torch import utils

    lim = limits(cell.traffic, search, cell.config["searcher"]["window_size"])
    groups = setup.traffic.groups
    work_of = [request_work(cell.config, lim, group) for group in groups]
    requests = []
    deadline = time.perf_counter() + seconds
    while not requests or time.perf_counter() < deadline:
        k = len(requests) % len(groups)
        group = groups[k]
        marks.records = []
        degraded = sum(utils.DEGRADED.values())
        table = error = None
        span = (torch.profiler.record_function("perfbench:request") if profiler is not None
                else nullcontext())
        t0 = time.perf_counter()
        with span:
            try:
                table = search_group(setup.searcher, group, search)
            except Exception as ex:  # noqa: BLE001 - a failed request is counted, not fatal
                error = repr(ex)
        t1 = time.perf_counter()
        if error is None and sum(utils.DEGRADED.values()) != degraded:
            error = f"degraded: {dict(utils.DEGRADED)}"
        requests.append(Request(tuple(g.id for g in group), t0, t1, *work_of[k], error, table,
                                marks.records))
    return requests


def check(setup: Setup, cell: spec.Cell, requests: list) -> dict:
    """The numbers compared, each ``{"value", "limit"}``, with notes."""
    lim = limits(cell.traffic, cell.traffic["search"], cell.config["searcher"]["window_size"])
    guides = {g.id: g for g in setup.traffic.guides}
    totals = {"rows_wrong": 0, "planted_missed": 0, "searched_missed": 0, "table_faults": 0}
    rows = planted = searched = 0
    notes = [f"{','.join(r.guide_ids)}: {r.error}" for r in requests
             if r.error is not None][:5]
    for r in requests:
        if r.error is not None:
            continue
        tables, foreign, more = split_by_guide(r.table, r.guide_ids)
        totals["table_faults"] += foreign
        notes += more[: max(0, 10 - len(notes))]
        for gid, table in tables.items():
            g = guides[gid]
            out = check_request(table, g.id, g.string, g.plants, setup.genome.fetch,
                                setup.genome.lengths, setup.genome.order, setup.scores, lim,
                                g.slices)
            for k in totals:
                totals[k] += out[k]
            rows, planted = rows + out["rows"], planted + out["planted"]
            searched += out["searched"]
            notes += out["notes"][: max(0, 10 - len(notes))]
    failed = sum(r.error is not None for r in requests)
    checks = {"failed_requests": failed, **totals}
    return {"checks": {k: {"value": v, "limit": 0} for k, v in checks.items()},
            "rows": rows, "planted": planted, "searched": searched, "notes": notes}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, search: Optional[dict] = None) -> dict:
    """One run of ``cell``; returns the result line's object.  ``search``
    replaces the traffic's limits passed to the program (the control), while
    the check holds the tables to the traffic's own."""
    import torch

    from calitas_tpu_torch.ops import dp_cuda

    search = dict(cell.traffic["search"] if search is None else search)
    marks = Marks()
    program_log = logging.getLogger(PROGRAM_LOGGER)
    program_log.setLevel(logging.INFO)
    program_log.addHandler(marks)
    program_log.propagate = False  # its warnings (strand balance) stay out of stderr
    say(f"# setup start {time.perf_counter() - t_start:.4f} s (interpreter and imports)")
    setup = Setup(cell, seed, device)
    try:
        setup_s = time.perf_counter() - t_start
        say(f"# setup total {setup_s:.4f} s")
        profiler = None
        if cell.traced:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.startswith("cuda"):
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=acts)
            profiler.start()
            marks.tracing = True
        launches = dict(dp_cuda.launches)
        requests = measure(setup, cell, seconds, search, marks, profiler)
        launches = {k: dp_cuda.launches[k] - launches[k] for k in launches}
        summary = None
        if profiler is not None:
            profiler.stop()
            marks.tracing = False
            summary = summarize(events_of(profiler))
            del profiler
        seconds_run = requests[-1].t1 - requests[0].t0
        peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") else 0
        setup.searcher = None  # the program's state is freed before the check
        gc.collect()
        if device.startswith("cuda"):
            torch.cuda.empty_cache()
        win = Window(requests, seconds_run, setup_s, launches, summary)
        metrics = {}
        for name, unit in cell.metrics.items():
            value = spec.metric_reader(name)(win)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
        t = time.perf_counter()
        checked = check(setup, cell, requests)
        check_s = time.perf_counter() - t
    finally:
        setup.close()
        program_log.removeHandler(marks)
    for note in checked["notes"]:
        print(f"# fault {note}", file=sys.stderr)
    failed = checked["checks"]["failed_requests"]["value"]
    correct = all(c["value"] <= c["limit"] for c in checked["checks"].values())
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": torch.cuda.get_device_name(0) if device.startswith("cuda") else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(requests), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"], dev["window_s"] = summary.busy_s, summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    walls = sorted(r.wall for r in requests)
    say(f"# window {seconds_run:.4f} s, {len(requests)} requests (walls: first "
        f"{requests[0].wall:.4f}, median {walls[len(walls) // 2]:.4f}, max {walls[-1]:.4f} s); "
        f"{checked['rows']} rows, {checked['planted']} planted sites and "
        f"{checked['searched']} sites the reference found checked in "
        f"{check_s:.2f} s")
    result["checks"] = checked["checks"]
    return result
