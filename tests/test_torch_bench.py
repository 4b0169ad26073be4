"""The port's bench (``calitas_tpu_torch/bench.py``) against the root
``bench.py`` of the JAX package on the CPU, with tolerance zero: the
device genome generator bit for bit against ``bench.device_genome_masks``
(one chunk, and several with the pad inside a chunk), the host stream
against ``bench.host_genome_codes``, and a 2 Mb run's raw and kept counts
and table body against the JAX bench's pipeline (its ``screened_search``
with ``prestaged`` from its generator) on the same FASTA and hit fields.
The JAX CPU screen applies no PAM gate, so tables are compared, never
flags.  Also: the one JSON line, the mesh split's table and screen, and
no fallback without a card.  jax is imported only inside the tests that
use it, so on the card ``python -m pytest tests/test_torch_bench.py -m
cuda`` collects without it."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from calitas_tpu_torch import bench
from calitas_tpu_torch.align.engine import SequentialAligner
from calitas_tpu_torch.core.guide import Guide
from calitas_tpu_torch.ops.genome_screen import (
    GenomeScreen,
    ShardedGenomeScreen,
    staged_length,
)
from calitas_tpu_torch.parallel.mesh import make_mesh

ROOT = Path(__file__).resolve().parents[1]
G = 2_000_000


@pytest.fixture(scope="module")
def jax_bench():
    """The JAX package's root ``bench.py``."""
    sys.path.insert(0, str(ROOT))
    import bench as jax_bench_module

    return jax_bench_module


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """The 2 Mb bench contig on disk: ``(fasta path, bases)``."""
    return bench.make_genome(str(tmp_path_factory.mktemp("bench")), G)


@pytest.fixture(scope="module")
def port_run(genome):
    """One port run of the bench on the 2 Mb contig, plain screen."""
    return bench.search_bench(genome[0], G, device="cpu")


@pytest.mark.parametrize("padded_len,g", [(1 << 12, 3_000), (1 << 23, 5_000_000)])
def test_device_genome_masks_match_the_jax_bench(jax_bench, padded_len, g):
    got = bench.device_genome_masks(padded_len, g, "cpu")
    want = np.asarray(jax_bench.device_genome_masks(padded_len, g))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape == (padded_len,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[g:].any()


@pytest.mark.parametrize("start", [0, 123_456_789, 2**30 - 5_000])
def test_genome_codes_match_the_jax_bench(jax_bench, start):
    want = jax_bench.host_genome_codes(start, 10_000)
    got = bench.genome_codes(start, 10_000)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # the device generator's int64 recipe, at the same positions
    np.testing.assert_array_equal(
        bench.genome_mask_block(start, 10_000, "cpu").numpy(),
        np.left_shift(1, want).astype(np.uint8),
    )


def test_the_fasta_stages_to_the_generated_masks(genome):
    fasta, bases = genome
    from calitas_tpu_torch.io.fasta import IndexedFasta

    got = IndexedFasta(fasta).get_bases("chr1")
    np.testing.assert_array_equal(got, bases)
    staged = GenomeScreen(SequentialAligner().scorer, "cpu", window=bench.WINDOW).stage(got)
    assert torch.equal(staged, bench.device_genome_masks(staged_length(G, bench.WINDOW), G, "cpu"))


#: the root bench.py's workload, as its ``main`` sets it
JAX_ALIGN_KWARGS = dict(max_guide_diffs=5, max_pam_diffs=1, max_gaps_between_guide_and_pam=3,
                        max_total_diffs=9, max_overlap=10)
JAX_WINDOW = 1000
JAX_HIT_SPEC = dict(aligner_id="CALITAS:SearchReference", arguments="bench", vcf_id=None,
                    timestamp="Mon Jan 01 00:00:00 UTC 2026")


def test_two_mb_run_matches_the_jax_bench_pipeline(jax_bench, genome, port_run):
    from calitas_tpu.align.engine import SequentialAligner as JaxAligner
    from calitas_tpu.core.guide import Guide as JaxGuide
    from calitas_tpu.io.fasta import DictEntry, IndexedFasta, SequenceDictionary
    from calitas_tpu.ops.genome_screen import GenomeScreen as JaxGenomeScreen
    from calitas_tpu.parallel.screen_runner import GuideTask, screened_search
    from calitas_tpu.search.hits import dedup_sort_serialize

    fasta = genome[0]
    guide = jax_bench.GUIDE
    step = JAX_WINDOW - (len(guide) + 5 + 3 - 1)
    assert (bench.GUIDE, bench.WINDOW, bench.STEP) == (guide, JAX_WINDOW, step)
    assert bench.ALIGN_KWARGS == JAX_ALIGN_KWARGS
    aligner = JaxAligner()
    tasks = [GuideTask(guide_id="bench", guide=JaxGuide.parse(guide), guide_length=len(guide),
                       step_size=step)]
    hits = []
    for _t, _c, _s, rows in screened_search(
        IndexedFasta(fasta), None, tasks, aligner, window_size=JAX_WINDOW,
        threads=1, swallow_errors=True, hit_spec=dict(JAX_HIT_SPEC, ref_path=fasta),
        screen=JaxGenomeScreen(aligner.scorer, window=JAX_WINDOW),
        prestaged={"chr1": jax_bench.device_genome_masks(1 << (G + JAX_WINDOW - 1).bit_length(),
                                                         G)},
        **JAX_ALIGN_KWARGS,
    ):
        hits.extend(rows)
    body, n_kept, _n_fwd = dedup_sort_serialize(
        hits, JAX_ALIGN_KWARGS["max_overlap"],
        SequenceDictionary([DictEntry(name="chr1", length=G, assembly="bench")]))
    assert port_run["raw_hits"] == len(hits) > 0
    assert port_run["kept"] == n_kept > 0
    assert port_run["table_bytes"] == len(body)
    assert port_run["body"] == body
    assert port_run["launches"] == 0  # the plain screen on the CPU
    assert port_run["segments"] == 1


def test_mesh_run_gives_the_one_device_table(genome, port_run):
    got = bench.search_bench(genome[0], G, mesh=make_mesh(devices=["cpu"] * 3))
    assert got["devices"] == ["cpu"] * 3
    assert (got["raw_hits"], got["kept"], got["body"]) == (
        port_run["raw_hits"], port_run["kept"], port_run["body"])


@pytest.mark.parametrize("spans", [2, 4])
def test_screen_only_spans_equal_one_span(spans):
    g = 300_000
    guide = Guide.parse(bench.GUIDE)
    aligner = SequentialAligner()
    ms = aligner.min_guide_score(guide, bench.ALIGN_KWARGS["max_guide_diffs"])
    masks = bench.device_genome_masks(staged_length(g, bench.WINDOW), g, "cpu")
    one = GenomeScreen(aligner.scorer, "cpu", window=bench.WINDOW)
    split = ShardedGenomeScreen(aligner.scorer, ("cpu",) * spans, window=bench.WINDOW)
    _s, flags, ranges = bench.screen_only(one, masks, g, guide, ms)
    _s, flags_k, ranges_k = bench.screen_only(split, masks, g, guide, ms)
    assert flags.shape == (2, len(one.window_starts(g, bench.STEP)))
    np.testing.assert_array_equal(flags_k, flags)
    np.testing.assert_array_equal(ranges_k, ranges)


def test_main_prints_one_metric_line(capsys):
    assert bench.main(["0.3", "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == bench.METRIC and line["unit"] == "bases/s"
    assert line["value"] > 0 and line["vs_baseline"] > 0
    for field in ("e2e_best=", "dedup=", "screen=", "stage_once=", "stage_fasta=", "raw_hits=",
                  "kept=", "table_bytes=", "launches=", "peak_device_bytes="):
        assert field in err, field
    assert "# card: cpu" in err


def test_no_card_raises_without_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_genome(*_a, **_kw):
        raise AssertionError("the genome was written before the device was resolved")

    monkeypatch.setattr(bench, "make_genome", no_genome)
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main(["2"])
    with pytest.raises(RuntimeError, match="is_available"):
        bench.search_bench("unused.fa", G)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_card_generator_equals_the_cpu_one(cuda):
    padded_len, g = 1 << 23, 5_000_000
    got = bench.device_genome_masks(padded_len, g, cuda)
    assert got.device == cuda
    assert torch.equal(got.cpu(), bench.device_genome_masks(padded_len, g, "cpu"))
