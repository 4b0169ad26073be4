"""The port's finish pool fans out: a PairwiseAlignSequences run with two
worker processes and enough pairs to use them (``-t 2``, 320 pairs) on
the gpu engine (plain screen on the CPU) gives the JAX package's
host-engine table, the pool never breaks, and the program counts each chunk
as pooled.  The workers return
alignments holding a ``LazyCigar``; before it pickled, the pool broke on
its first chunk and finished in-process.  The run is a script of its
own: the pool's spawned workers re-import the main module."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from calitas_tpu.core.sequence import revcomp

ROOT = Path(__file__).resolve().parent.parent
GUIDES = ("CTTGCCCCACAGGGCAGTAAnrg", "tttvGATCCGTAGCTAGGCATTACGGTA")

SCRIPT = r'''
import json
import logging
import sys

from calitas_tpu_torch import cli, spans
from calitas_tpu_torch.parallel import host_pool


class Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.seen = []

    def emit(self, record):
        self.seen.append(record.getMessage())


if __name__ == "__main__":
    warnings = Warnings()
    logging.getLogger("calitas_tpu_torch").addHandler(warnings)
    rc = cli.main(["PairwiseAlignSequences", "-i", sys.argv[1], "-o", sys.argv[2],
                   "-t", "2", "--engine", "gpu", "--device", "cpu"])
    pool = host_pool._SHARED_POOL
    print(json.dumps({"rc": rc, "pool": pool is not None,
                      "workers": host_pool._SHARED_POOL_SIZE,
                      "warnings": warnings.seen, "counts": spans.counts()}))
    if pool is not None:
        pool.shutdown(wait=True)
'''


def _pairs(path: Path, n: int = 320) -> None:
    rng = np.random.default_rng(4)
    with open(path, "w") as fh:
        for k in range(n):
            guide = GUIDES[k % 2]
            t = "".join(rng.choice(list("ACGT"), int(rng.integers(60, 160))))
            if k % 3:
                site = guide[:-3] + "TGG" if k % 2 == 0 else "TTTA" + guide[4:]
                site = list(site)
                for _ in range(int(rng.integers(0, 4))):
                    site[int(rng.integers(0, len(site)))] = str(rng.choice(list("ACGT")))
                s = "".join(site)
                s = revcomp(s) if rng.random() < 0.5 else s
                p = int(rng.integers(0, len(t) - len(s)))
                t = t[:p] + s + t[p + len(s):]
            fh.write(f"{guide}\t{t}\n")


def test_pooled_pairwise_finish_does_not_break(tmp_path):
    from calitas_tpu.tools import pairwise

    pairs = tmp_path / "pairs.txt"
    _pairs(pairs)
    script = tmp_path / "pooled_pairwise.py"
    script.write_text(SCRIPT)
    proc = subprocess.run(
        [sys.executable, str(script), str(pairs), str(tmp_path / "port.txt")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["rc"] == 0
    assert report["pool"] and report["workers"] == 2, report
    assert not any("Worker pool broken" in w for w in report["warnings"]), report
    # every finish chunk ran in the pool, and was counted there
    assert report["counts"].get("finish_chunks_pooled", 0) >= 4, report
    assert "finish_chunks_inline" not in report["counts"], report
    pairwise.run(input=pairs, output=tmp_path / "jax.txt", threads=1, engine="host")
    want = (tmp_path / "jax.txt").read_bytes()
    assert (tmp_path / "port.txt").read_bytes() == want
    assert len(want.splitlines()) == 321
