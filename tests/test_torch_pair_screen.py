"""The port's pair screen (``calitas_tpu_torch.ops.pair_screen``) against
the exact oracle and the JAX ``PairScreen``, and the port's
PairwiseAlignSequences / AlignToReference on the gpu engine (the plain
screen, ``device="cpu"``) against their host engine: the mirror of
``tests/test_pair_screen.py``.  Every comparison is exact."""

import numpy as np
import pytest

from calitas_tpu.align.oracle import dp_matrix
from calitas_tpu.core.guide import Guide
from calitas_tpu.core.scoring import derive_scorer
from calitas_tpu.core.sequence import encode_query, encode_target, revcomp
from calitas_tpu.ops.pair_screen import PairScreen as JaxPairScreen
from calitas_tpu_torch.ops import dp_screen
from calitas_tpu_torch.ops.pair_screen import PairScreen, pass_bounds_for
from tests.test_engine_differential import table_without_timestamp

RNG = np.random.default_rng(77)
BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)


def random_seq(n, with_n=False):
    pool = BASES if with_n else BASES[:4]
    return RNG.choice(pool, size=n).tobytes().decode()


@pytest.fixture(scope="module")
def scorer():
    return derive_scorer()


class TestPairKernel:
    def test_chain_maxima_match_oracle(self, scorer):
        screen = PairScreen(scorer, "cpu")
        queries, targets = [], []
        for Q, T in [(18, 50), (18, 70), (20, 64), (20, 200), (23, 90)]:
            queries.append(random_seq(Q))
            targets.append(random_seq(T, with_n=True))
        queries.append("CTTGCCCCACAGGGCAGTAA")
        targets.append(random_seq(30) + "CTTGCCCCACAGGGCAGTAA" + random_seq(30))
        a, b = screen.chain_maxima(queries, targets)
        for i, (q, t) in enumerate(zip(queries, targets)):
            S = dp_matrix(encode_query(q), encode_target(t), scorer)
            assert a[i] == S[len(q), 1:].max(), (i, "chain A")
            S2 = dp_matrix(encode_query(revcomp(q)), encode_target(t), scorer)
            assert b[i] == S2[len(q), 1:].max(), (i, "chain B")
        assert a[-1] == scorer.match_score * 20

    def test_chain_b_equals_revcomp_target(self, scorer):
        q, t = random_seq(20), random_seq(80)
        _, b = PairScreen(scorer, "cpu").chain_maxima([q], [t])
        S = dp_matrix(encode_query(q), encode_target(revcomp(t)), scorer)
        assert b[0] == S[20, 1:].max()

    def test_unscreenable_pairs_marked(self, scorer):
        a, b = PairScreen(scorer, "cpu").chain_maxima(
            ["", "ACGT", "ACGT"], ["ACGTACGT", "T" * (PairScreen.MAX_SLOT + 1), ""]
        )
        assert (a == PairScreen.NO_SCREEN).all() and (b == PairScreen.NO_SCREEN).all()

    def test_pass_bounds_mapping(self):
        g3 = Guide.parse("CTTGCCCCACAGGGCAGTAAnrg")
        assert pass_bounds_for(g3, 10, 20) == {"fwd": 10, "rev": 20}
        g5 = Guide.parse("tttvCTTGCCCCACAGGGCAGTAA")
        assert pass_bounds_for(g5, 10, 20) == {"rev": 10, "fwd": 20}


def _mixed_batch(seed, n=160):
    """Rows of config 3's guide and a 24-base 5'-PAM guide (their DP
    queries), a 50-base query past the kernel's limit, and ambiguity
    codes; targets of 0..300 bases with planted sites, plus empty targets
    and targets over MAX_SLOT."""
    rng = np.random.default_rng(seed)
    g3 = Guide.parse("CTTGCCCCACAGGGCAGTAAnrg")
    g5 = Guide.parse("tttv" + "".join(rng.choice(list("ACGT"), 24)))
    qpool = [g3.guide_fw, g5.guide_rc, "".join(rng.choice(list("ACGTRYN"), 50)),
             "ACGTNNRY"]
    queries, targets, mss = [], [], []
    for i in range(n):
        q = qpool[i % len(qpool)]
        T = int(rng.integers(0, 300))
        t = list("".join(rng.choice(list("ACGTN"), T)))
        if T > len(q) + 10 and i % 3 == 0:
            site = list(q.replace("N", "A").replace("R", "G").replace("Y", "C"))
            for _ in range(int(rng.integers(0, 5))):
                site[int(rng.integers(0, len(site)))] = "ACGT"[int(rng.integers(0, 4))]
            s = "".join(site)
            if i % 2:
                s = revcomp(s)
            p = int(rng.integers(0, T - len(s)))
            t[p : p + len(s)] = list(s)
        queries.append(q)
        targets.append("".join(t))
        mss.append(int(rng.integers(-200, 60 * len(q))))
    queries += ["", g3.guide_fw, g5.guide_rc]
    targets += ["ACGTACGT", "", "A" * (PairScreen.MAX_SLOT + 3)]
    mss += [0, 0, 0]
    return queries, targets, mss


@pytest.mark.parametrize("seed", [1, 2])
def test_pair_screen_equals_jax_on_mixed_batches(scorer, seed):
    queries, targets, mss = _mixed_batch(seed)
    want = JaxPairScreen(scorer).chain_maxima_ranges(queries, targets, mss)
    got = PairScreen(scorer, "cpu", batch_rows=37).chain_maxima_ranges(
        queries, targets, mss
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        PairScreen(scorer, "cpu").chain_maxima(queries, targets),
        JaxPairScreen(scorer).chain_maxima(queries, targets),
    )


def test_every_chunk_launches_before_any_resolves(scorer, monkeypatch):
    """Chunks (buckets cut at batch_rows) all launch before the first
    readback resolves, each as one call of the plain screen on the CPU."""
    from calitas_tpu_torch.ops import dp_cuda

    queries, targets, _ = _mixed_batch(3, n=60)
    events = []
    real = dp_cuda.readback

    def spy(out, finish):
        events.append("launch")
        resolve = real(out, finish)
        return lambda: (events.append("resolve"), resolve())[1]

    monkeypatch.setattr(dp_cuda, "readback", spy)
    calls = dp_screen.reference_calls["cpu"]
    launches = dict(dp_cuda.launches)
    screen = PairScreen(scorer, "cpu", batch_rows=4)
    buckets, _ = screen.buckets(queries, targets)
    screen.chain_maxima(queries, targets)
    n_chunks = sum(-(-len(v) // 4) for v in buckets.values())
    assert events == ["launch"] * n_chunks + ["resolve"] * n_chunks
    assert dp_screen.reference_calls["cpu"] - calls == n_chunks
    assert dp_cuda.launches == launches


class TestPairRanges:
    def test_ranges_bound_qualifying_columns(self, scorer):
        screen = PairScreen(scorer, "cpu")
        queries, targets, min_scores = [], [], []
        planted = "CTTGCCCCACAGGGCAGTAA"
        for T in (50, 90, 200, 300):
            queries.append(planted)
            targets.append(random_seq(T // 3) + planted + random_seq(T - T // 3))
            min_scores.append(scorer.match_score * len(planted) - 2 * 122)
        queries.append(planted)
        targets.append(random_seq(60))
        min_scores.append(scorer.match_score * len(planted))
        queries.append(planted)
        targets.append(random_seq(PairScreen.MAX_SLOT + 1))
        min_scores.append(0)
        _a, _b, ranges = screen.chain_maxima_ranges(queries, targets, min_scores)
        assert ranges is not None and ranges.shape == (len(queries), 4)
        assert tuple(ranges[-1]) == (-1, -1, -1, -1)
        for i in range(len(queries) - 1):
            for c, q in enumerate((queries[i], revcomp(queries[i]))):
                S = dp_matrix(encode_query(q), encode_target(targets[i]), scorer)
                qual = np.nonzero(S[len(q), 1:] >= min_scores[i])[0] + 1
                lo, hi = int(ranges[i, 2 * c]), int(ranges[i, 2 * c + 1])
                if len(qual):
                    assert lo == qual.min() and hi == qual.max(), (i, c)
                else:
                    assert lo > hi, (i, c)
                if i < 4 and c == 0:
                    assert len(qual), f"pair {i}: planted hit missed"

    def test_maxima_unchanged_by_ranges(self, scorer):
        screen = PairScreen(scorer, "cpu")
        queries = [random_seq(20) for _ in range(5)]
        targets = [random_seq(70, with_n=True) for _ in range(5)]
        a0, b0 = screen.chain_maxima(queries, targets)
        a1, b1, _ = screen.chain_maxima_ranges(queries, targets, [0] * 5)
        np.testing.assert_array_equal(a0, a1)
        np.testing.assert_array_equal(b0, b1)


def _random_guide_query(rng, five_prime=False):
    proto = "".join(rng.choice(list("ACGT"), int(rng.integers(18, 23))))
    return ("tttv" + proto) if five_prime else (proto + "nrg")


class TestPairwiseDeviceParity:
    def test_gpu_engine_byte_identical(self, tmp_path):
        """engine=gpu (the pair screen before the same finish) writes the
        exact bytes of the host run, competitive-rev pairs included."""
        from calitas_tpu_torch.tools import pairwise

        rng = np.random.default_rng(5)
        lines = []
        for i in range(40):
            five = i % 3 == 0
            q = _random_guide_query(rng, five)
            proto = q[4:] if five else q[:-3]
            t = random_seq(12) + proto + random_seq(12)
            if i % 4 == 1:
                t = random_seq(10) + revcomp(proto) + random_seq(10)
            if i % 5 == 2:  # both strands competitive: embed both
                t = proto + random_seq(6) + revcomp(proto)
            lines.append(f"{q} {t}")
        inp = tmp_path / "pairs.txt"
        inp.write_text("\n".join(lines) + "\n")
        host, dev = tmp_path / "host.txt", tmp_path / "dev.txt"
        pairwise.run(input=inp, output=host, threads=2, engine="host")
        calls = dp_screen.reference_calls["cpu"]
        pairwise.run(input=inp, output=dev, threads=2, engine="gpu", device="cpu")
        assert dp_screen.reference_calls["cpu"] > calls
        assert dev.read_bytes() == host.read_bytes()
        assert len(host.read_text().splitlines()) == 41


class TestA2RDeviceParity:
    @pytest.fixture()
    def ref(self, tmp_path):
        from calitas_tpu.io.fasta import ReferenceSetBuilder

        rng = np.random.default_rng(9)
        b = ReferenceSetBuilder(assembly="a2r")
        seq = list("".join(rng.choice(list("ACGT"), 20_000)))
        self.sites = []
        for k in range(12):
            pos = 1000 + k * 1500
            proto = "".join(rng.choice(list("ACGT"), 20))
            site = list(proto)
            for _ in range(int(rng.integers(0, 3))):
                i = int(rng.integers(0, 20))
                site[i] = rng.choice([c for c in "ACGT" if c != site[i]])
            s = "".join(site) + "TGG"
            if k % 2:
                s = revcomp(s)
            seq[pos : pos + len(s)] = list(s)
            self.sites.append((proto + "nrg", pos + 1))
        b.add("chr1").add("".join(seq))
        return b.to_file(tmp_path / "ref.fa")

    def _input(self, tmp_path, shifts=(0,)):
        rows = ["id\tquery\tchrom\tposition"]
        for i, (q, pos) in enumerate(self.sites):
            rows.append(f"s{i}\t{q}\tchr1\t{pos + shifts[i % len(shifts)]}")
        p = tmp_path / "loci.txt"
        p.write_text("\n".join(rows) + "\n")
        return p

    def _both(self, tmp_path, **kw):
        from calitas_tpu_torch.tools import align_to_reference

        host, dev = tmp_path / "host.txt", tmp_path / "dev.txt"
        align_to_reference.run(output=host, engine="host", **kw)
        calls = dp_screen.reference_calls["cpu"]
        align_to_reference.run(output=dev, engine="gpu", device="cpu", **kw)
        assert dp_screen.reference_calls["cpu"] > calls
        return table_without_timestamp(host), table_without_timestamp(dev)

    def test_best_mode_byte_identical(self, tmp_path, ref):
        host, dev = self._both(
            tmp_path, input=self._input(tmp_path), ref=ref, threads=2
        )
        assert dev == host and len(host) == 12  # one best row per locus

    def test_all_hits_mode_byte_identical(self, tmp_path, ref):
        # half the positions shifted so their windows hold no qualifying
        # hit (the screen must skip exactly those)
        host, dev = self._both(
            tmp_path, input=self._input(tmp_path, shifts=(100, 400)), ref=ref,
            threads=2, window_size=500, max_guide_diffs=3,
            max_pam_mismatches=1, max_overlap=5,
        )
        assert dev == host and len(host) > 1


class TestA2RSlicedFinish:
    """All-hits A2R carries the screen's end-column ranges into the sliced
    native finish; the table must equal the host engine's, indel-mutated
    sites included."""

    @pytest.mark.parametrize("seed", [11, 12])
    def test_all_hits_sliced_identical(self, tmp_path, seed):
        from calitas_tpu.io.fasta import ReferenceSetBuilder
        from calitas_tpu_torch.tools import align_to_reference

        rng = np.random.default_rng(seed)
        proto = "".join(rng.choice(list("ACGT"), 20))
        guide = proto + "nrg"
        genome = list("".join(rng.choice(list("ACGT"), 40_000)))
        loci = []
        for k in range(12):
            pos = 1500 + k * 3000
            site = list(proto)
            r = rng.random()
            if r < 0.4:  # substitutions
                for _ in range(int(rng.integers(0, 4))):
                    j = int(rng.integers(0, len(site)))
                    site[j] = rng.choice([c for c in "ACGT" if c != site[j]])
            elif r < 0.7:  # deletion (guide bulge)
                del site[int(rng.integers(2, len(site) - 2))]
            else:  # insertion (genome bulge)
                site.insert(int(rng.integers(2, len(site) - 2)),
                            str(rng.choice(list("ACGT"))))
            seq = "".join(site) + str(rng.choice(["TGG", "AAG", "CGG"]))
            if rng.random() < 0.5:
                seq = revcomp(seq)
            genome[pos : pos + len(seq)] = list(seq)
            loci.append(pos + 10)
        b = ReferenceSetBuilder(assembly=f"a2rslice{seed}")
        b.add("chr1").add("".join(genome))
        ref = b.to_file(tmp_path / "ref.fa")
        inp = tmp_path / "in.txt"
        with open(inp, "w") as fh:
            fh.write("id\tquery\tchrom\tposition\n")
            for k, pos in enumerate(loci):
                fh.write(f"t{k}\t{guide}\tchr1\t{pos}\n")
        kw = dict(input=inp, ref=ref, max_guide_diffs=4, max_pam_mismatches=1,
                  max_overlap=10, threads=2)
        out_h, out_g = tmp_path / "host.txt", tmp_path / "gpu.txt"
        align_to_reference.run(output=out_h, engine="host", **kw)
        align_to_reference.run(output=out_g, engine="gpu", device="cpu", **kw)
        rows_h = table_without_timestamp(out_h)
        assert table_without_timestamp(out_g) == rows_h
        assert len(rows_h) >= 6, "fixture should produce plenty of hits"
