"""The port runs where jax is not installed: in a fresh interpreter that
cannot import jax, import the port and its CLI and run small searches
(gpu engine on the CPU): one guide, then a guide file of two same-length
guides with a VCF, which runs the fused multi-guide screen and the
variant pass.  No jax module may ever be loaded."""

import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent(
    r"""
    import sys
    sys.modules["jax"] = None  # any `import jax` now raises ImportError
    import numpy as np
    import calitas_tpu_torch
    from calitas_tpu_torch import cli
    from calitas_tpu.io.fasta import ReferenceSetBuilder

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
    loaded = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "jaxlib")))
    assert loaded == ["jax"] and sys.modules["jax"] is None, loaded
    assert not any(m.startswith("calitas_tpu.ops") for m in sys.modules)
    assert "calitas_tpu.parallel.screen_runner" not in sys.modules
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
