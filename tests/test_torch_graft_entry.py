"""The port's entry points (``calitas_tpu_torch/graft_entry.py``) and mesh
batch screen (``calitas_tpu_torch/parallel/mesh.py::screen_on_mesh``)
against the JAX package's ``__graft_entry__.py`` and
``calitas_tpu/parallel/mesh.py`` on the CPU: the example batch byte for
byte, ``entry()``'s forward step exactly, ``screen_on_mesh`` on meshes of
1, 2, 3 and 8 ``cpu`` entries against the JAX function on as many of the
8 CPU devices tests/conftest.py forces, and ``dryrun_multichip``'s
whole-tool table against the JAX host engine's.  The JAX
``dryrun_multichip`` itself runs in tests/test_graft_entry.py.  The card
test is marked ``cuda`` and skips without a card; jax is imported only
by the tests that use it, so on the card ``python -m pytest
tests/test_torch_graft_entry.py -m cuda`` collects without it."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from calitas_tpu_torch import graft_entry
from calitas_tpu_torch.core.scoring import derive_scorer, scorer_from_reference
from calitas_tpu_torch.core.sequence import encode_query, encode_target
from calitas_tpu_torch.ops import dp_cuda, dp_screen
from calitas_tpu_torch.ops.genome_screen import mesh_spans
from calitas_tpu_torch.parallel.mesh import make_mesh, screen_on_mesh, sharded_screen_fn

ROOT = Path(__file__).resolve().parents[1]
SCORER = derive_scorer()
INT32_MIN = -(2**31)
Q = 12
PLANTED = "ACGTACGTACGT"


@pytest.fixture(scope="module")
def jax_graft():
    """The JAX package's entry points, imported here so that the card
    test below collects where jax is not installed."""
    sys.path.insert(0, str(ROOT))
    import __graft_entry__

    return __graft_entry__


@pytest.fixture(scope="module")
def jax_scorer():
    from calitas_tpu.core.scoring import derive_scorer as jax_derive_scorer

    scorer = jax_derive_scorer()
    assert scorer_from_reference(dataclasses.asdict(scorer)) == SCORER
    return scorer


@pytest.mark.parametrize("B,T,Q_", [(64, 256, 20), (37, 64, 12), (1, 5, 1)])
def test_example_batch_is_the_reference_batch(jax_graft, B, T, Q_):
    for got, want in zip(graft_entry._example_batch(B, T, Q_),
                         jax_graft._example_batch(B, T, Q_)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


def test_entry_matches_the_jax_forward_step(jax_graft):
    fn, args = graft_entry.entry(device="cpu")
    jfn, jargs = jax_graft.entry()
    for a, ja in zip(args, jargs):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    got = fn(*args)
    want = np.asarray(jfn(*jargs))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _mesh_batch():
    """37 rows (a multiple of none of the mesh sizes but 1) of 64 bases,
    a perfect site planted in row 3 and one with a mismatch in row 20,
    ragged lengths (row 30 of length 0)."""
    qmask, tmasks, lengths = graft_entry._example_batch(B=37, T=64, Q=Q)
    tmasks[3, 10 : 10 + Q] = encode_target(PLANTED)
    tmasks[20, 40 : 40 + Q] = encode_target("ACGTACTTACGT")
    lengths = lengths.copy()
    lengths[7::5] = 33
    lengths[30] = 0
    return encode_query(PLANTED), tmasks, lengths


MIN_SCORES = {
    "perfect": SCORER.match_score * Q,
    "mid": SCORER.match_score * Q // 2,
    "int32_min": INT32_MIN,
}


@pytest.fixture(scope="module")
def jax_cpu_devices():
    import jax

    devices = jax.devices("cpu")
    if len(devices) < 8:
        pytest.skip("needs 8 devices (set xla_force_host_platform_device_count)")
    return devices


@pytest.mark.parametrize("which", list(MIN_SCORES))
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_screen_on_mesh_matches_jax(jax_cpu_devices, jax_scorer, n, which):
    from calitas_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from calitas_tpu.parallel.mesh import screen_on_mesh as jax_screen_on_mesh

    qmask, tmasks, lengths = _mesh_batch()
    B = tmasks.shape[0]
    min_score = MIN_SCORES[which]
    best, total = screen_on_mesh(make_mesh(devices=["cpu"] * n), SCORER, qmask, tmasks,
                                 lengths, min_score)
    jbest, jtotal = jax_screen_on_mesh(jax_make_mesh(n, devices=jax_cpu_devices), jax_scorer,
                                       qmask, tmasks, lengths, min_score)
    assert best.dtype == np.int32 and best.shape == (B,)
    np.testing.assert_array_equal(best, np.asarray(jbest))
    assert best[3] == SCORER.match_score * Q
    assert total == int((best >= min_score).sum())
    if which == "int32_min":
        # The reference's psum also counts its padding rows (length 0,
        # NEG_INF); the port counts the given rows only (ROADMAP Queue 3).
        assert total == B and jtotal == B + (-B) % n
    else:
        assert total == jtotal
        assert 0 < total < B


def test_sharded_screen_fn_screens_each_span_and_counts_live_rows():
    """One screen per span of ``mesh_spans``, on its own entry; ``rows``
    leaves the rows past it out of the total, not out of ``best``."""
    qmask, tmasks, lengths = _mesh_batch()
    B = tmasks.shape[0]
    fn = sharded_screen_fn(make_mesh(devices=["cpu"] * 3), SCORER)
    calls = dp_screen.reference_calls["cpu"]
    best, total = fn(qmask, tmasks, lengths, INT32_MIN)
    assert dp_screen.reference_calls["cpu"] - calls == len(mesh_spans(3, 0, B)) == 3
    assert best.shape == (B,) and total == B
    assert fn(qmask, tmasks, lengths, INT32_MIN, rows=20)[1] == 20
    empty, none = fn(qmask, tmasks[:0], lengths[:0], INT32_MIN)
    assert empty.shape == (0,) and none == 0
    want = dp_screen._screen_scores(*(torch.from_numpy(a) for a in (qmask, tmasks, lengths)),
                                    match=SCORER.match_score, mismatch=SCORER.mismatch_score,
                                    qgap=SCORER.query_gap_score, tgap=SCORER.target_gap_score)
    np.testing.assert_array_equal(best, want.numpy())


@pytest.fixture(scope="module")
def jax_host_table(tmp_path_factory):
    """Check (c)'s inputs through the JAX package's host engine."""
    from calitas_tpu.tools import search_reference as jax_sr

    td = tmp_path_factory.mktemp("host_table")
    ref, vcf = graft_entry.table_check_inputs(td)
    out = td / "host.txt"
    jax_sr.run(guide=graft_entry.TABLE_GUIDE, guide_id="g", ref=ref, variants=vcf,
               output=str(out), engine="host", threads=1)
    return graft_entry.blanked_table(out)


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_multichip_on_cpu_matches_the_jax_host_engine(jax_host_table, n, capsys):
    summary = graft_entry.dryrun_multichip(n, devices=["cpu"] * n)
    assert summary["table"] == jax_host_table
    assert summary["rows"] == len(jax_host_table) >= 50
    assert summary["flags"] >= 1 and summary["global_hits"] == 1
    assert f"dryrun_multichip OK: mesh={n} devices" in capsys.readouterr().out


def test_entry_and_dryrun_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="is_available"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(ValueError, match="needs 3 devices"):
        graft_entry.dryrun_multichip(3, devices=["cpu"] * 2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_screen_on_mesh_spans_on_one_card_match_the_plain_version(cuda):
    qmask, tmasks, lengths = _mesh_batch()
    mesh = make_mesh(devices=[cuda] * 3)
    want = dp_screen._screen_scores(
        *(torch.from_numpy(a).to(cuda) for a in (qmask, tmasks, lengths)),
        match=SCORER.match_score, mismatch=SCORER.mismatch_score,
        qgap=SCORER.query_gap_score, tgap=SCORER.target_gap_score).cpu().numpy()
    for min_score in MIN_SCORES.values():
        dp_cuda.reset_launches()
        best, total = screen_on_mesh(mesh, SCORER, qmask, tmasks, lengths, min_score)
        assert dp_cuda.launches["screen_rows"] == len(mesh_spans(3, 0, 39))
        np.testing.assert_array_equal(best, want)
        assert total == int((want >= min_score).sum())
