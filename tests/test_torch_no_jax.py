"""The port stands alone: in a fresh interpreter that can import neither
jax nor the JAX package, import the port and its CLI and run small searches
(gpu engine on the CPU): one guide, then a guide file of two same-length
guides with a VCF, which runs the fused multi-guide screen and the
variant pass; then PairwiseAlignSequences and AlignToReference (best and
all-hits modes), once with the native finish and once without it, so the
host workers' per-item fallback runs and must still give the host
engine's table.  No jax module and no module of the JAX package may ever
be loaded."""

import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent(
    r"""
    import sys
    sys.modules["jax"] = None  # any `import jax` now raises ImportError
    sys.modules["calitas_tpu"] = None  # and so does the JAX package
    import numpy as np
    import calitas_tpu_torch
    from calitas_tpu_torch import cli
    from calitas_tpu_torch.io.fasta import ReferenceSetBuilder

    tmp = sys.argv[1]
    rng = np.random.default_rng(0)
    seq = list("".join(rng.choice(list("ACGT"), 20_000)))
    seq[5000:5023] = list("CTTGCCCCACAGGGCAGTAATGG")
    b = ReferenceSetBuilder(assembly="nojax")
    b.add("chr1").add("".join(seq))
    ref = b.to_file(tmp + "/ref.fa")
    rc = cli.main(["SearchReference", "-i", "CTTGCCCCACAGGGCAGTAAnrg",
                   "-I", "g", "-r", str(ref), "-o", tmp + "/out.txt",
                   "-t", "1", "--engine", "gpu", "--device", "cpu"])
    assert rc == 0, rc
    rows = open(tmp + "/out.txt").read().splitlines()
    assert len(rows) >= 2, rows

    with open(tmp + "/guides.tsv", "w") as fh:
        fh.write("guide_id\tguide\ng1\tCTTGCCCCACAGGGCAGTAAnrg\n"
                 "g2\tGACGCATAAAGATGAGACGCnrg\n")
    with open(tmp + "/v.vcf", "w") as fh:
        fh.write("##fileformat=VCFv4.2\n"
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
                 f"chr1\t5006\trs1\t{seq[5005]}\tG\t50\tPASS\tAF=0.1\n"
                 f"chr1\t9000\trs2\t{seq[8999]}\tTA\t50\tPASS\tAF=0.2\n")
    rc = cli.main(["SearchReference", "--guide-file", tmp + "/guides.tsv",
                   "-r", str(ref), "-v", tmp + "/v.vcf", "-o", tmp + "/v.txt",
                   "-t", "1", "--engine", "gpu", "--device", "cpu"])
    assert rc == 0, rc
    vrows = open(tmp + "/v.txt").read().splitlines()
    assert any("v.vcf:" in r for r in vrows), vrows
    assert "calitas_tpu_torch.search.variants" in sys.modules

    # The list tools.  Their tables on the gpu engine must equal the host
    # engine's, with the native finish and with the per-item fallback.
    pairs = tmp + "/pairs.txt"
    with open(pairs, "w") as fh:
        for k in range(12):
            t = "".join(seq[4990 + 7 * k : 5040 + 7 * k])
            q = "CTTGCCCCACAGGGCAGTAAnrg" if k % 2 else "tttvCTTGCCCCACAGGGCAGTAA"
            fh.write(q + " " + t + "\n")
    loci = tmp + "/loci.tsv"
    with open(loci, "w") as fh:
        fh.write("id\tquery\tchrom\tposition\n")
        for k in range(10):
            fh.write(f"l{k}\tCTTGCCCCACAGGGCAGTAAnrg\tchr1\t{4990 + 40 * k}\n")
    runs = {
        "pw": ["PairwiseAlignSequences", "-i", pairs],
        "best": ["AlignToReference", "-i", loci, "-r", str(ref)],
        "all": ["AlignToReference", "-i", loci, "-r", str(ref), "-w", "60",
                "-d", "4", "-p", "1", "-O", "5"],
    }

    def table(name, tag, *engine):
        out = f"{tmp}/{name}_{tag}.txt"
        assert cli.main([*runs[name], "-o", out, "-t", "1", *engine]) == 0
        rows = open(out).read().splitlines()
        hdr = rows[0].split("\t")
        ts = hdr.index("time_stamp") if "time_stamp" in hdr else None
        return [[f for i, f in enumerate(r.split("\t")) if i != ts] for r in rows]

    from calitas_tpu_torch import native
    from calitas_tpu_torch.align.engine import SequentialAligner

    host = {n: table(n, "host", "--engine", "host") for n in runs}
    assert all(len(t) > 1 for t in host.values()), host
    for n in runs:
        assert table(n, "gpu", "--engine", "gpu", "--device", "cpu") == host[n], n
    per_item = []
    for name in ("align_best", "align_to_ref_best", "align_to_ref"):
        real = getattr(SequentialAligner, name)

        def counted(self, *a, _real=real, **kw):
            per_item.append(kw.get("pass_dp_bounds"))
            return _real(self, *a, **kw)

        setattr(SequentialAligner, name, counted)
    native._lib, native._tried = None, True  # the native finish is gone
    assert not native.available()
    for n in runs:
        assert table(n, "fallback", "--engine", "gpu", "--device", "cpu") == host[n], n
    assert len(per_item) >= 12 + 10 + 10 and not any(per_item), per_item
    loaded = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "jaxlib")))
    assert loaded == ["jax"] and sys.modules["jax"] is None, loaded
    jax_package = sorted(m for m in sys.modules
                         if m == "calitas_tpu" or m.startswith("calitas_tpu."))
    assert jax_package == ["calitas_tpu"] and sys.modules["calitas_tpu"] is None
    assert "calitas_tpu_torch.ops.pair_screen" in sys.modules
    print("OK", len(rows) - 1, len(vrows) - 1)
    """
)


def test_port_imports_and_runs_without_jax(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("OK")
