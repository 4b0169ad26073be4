"""Two host-half faults the port repairs in its own copy: the decompressed
sidecar cache evicts sidecars of the older single-hash naming beside the
FASTA (never in a shared fallback directory, never the current file), and
``BlockFeed.close()`` returns within its timeout and says so when the
producer is blocked inside its stream."""

import gzip
import logging
import shutil
import threading
import time

from calitas_tpu_torch.io.fasta import IndexedFasta, ReferenceSetBuilder
from calitas_tpu_torch.parallel.host_pool import BlockFeed


def test_old_format_sidecar_is_evicted(tmp_path, monkeypatch):
    src = tmp_path / "src"
    shared = tmp_path / "shared"
    src.mkdir()
    shared.mkdir()
    monkeypatch.setenv("CALITAS_TPU_CACHE_DIR", str(shared))
    b = ReferenceSetBuilder(assembly="ev")
    b.add("chr1").add("ACGT" * 200)
    fa = b.to_file(src / "ev.fa")
    gz = src / "ev.fa.gz"
    with gzip.open(gz, "wb") as fh:
        fh.write(fa.read_bytes())
    shutil.copy(str(fa) + ".fai", str(gz) + ".fai")
    legacy = ".ev.fa.gz.calitas_cache_" + "0123456789abcdef" * 2 + ".fa"
    (src / legacy).write_bytes(b"stale")
    (shared / legacy).write_bytes(b"another directory's")
    other = src / ".ev.fa.gz.calitas_cache_notes.fa"  # not a sidecar name
    other.write_bytes(b"kept")

    assert IndexedFasta(gz).get_subsequence("chr1", 1, 8) == b"ACGTACGT"
    left = sorted(p.name for p in src.glob(".ev.fa.gz.calitas_cache_*.fa"))
    assert legacy not in left
    assert other.name in left
    current = [n for n in left if n != other.name]
    assert len(current) == 1 and (src / current[0]).read_bytes() == fa.read_bytes()
    assert (shared / legacy).read_bytes() == b"another directory's"


def test_block_feed_close_returns_when_the_producer_is_blocked(caplog):
    entered, release = threading.Event(), threading.Event()

    def stream():
        yield 1
        entered.set()
        release.wait(30)  # a dispatch that does not return
        yield 2

    feed = BlockFeed(stream(), block_size=4)
    assert entered.wait(10)
    with caplog.at_level(logging.WARNING, logger="calitas_tpu_torch.parallel.host_pool"):
        t0 = time.monotonic()
        feed.close(timeout=0.2)
        took = time.monotonic() - t0
    try:
        assert took < 5
        warnings = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
        assert any("calitas-blocks" in m and "still running" in m for m in warnings)
    finally:
        release.set()
        feed._thread.join(10)
    assert not feed._thread.is_alive()
