"""Version string in the reference's format.

The reference stamps ``aligner_version`` from the jar manifest, which the
build sets to ``yyyyMMdd-<git-sha>[-dirty]`` (build.sbt:30-36) with an
``unknown-yyyy-MM-dd`` fallback (EditasMetric.scala:13).  We derive the
same shape from git at import time, falling back to the package version.
"""

from __future__ import annotations

import os
import subprocess
import time
from functools import lru_cache

from calitas_tpu_torch import __version__


@lru_cache(maxsize=1)
def aligner_version() -> str:
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=repo, capture_output=True, text=True, timeout=5,
        )
        if sha.returncode == 0:
            dirty = subprocess.run(
                ["git", "status", "--porcelain"],
                cwd=repo, capture_output=True, text=True, timeout=5,
            )
            suffix = "-dirty" if dirty.returncode == 0 and dirty.stdout.strip() else ""
            date = time.strftime("%Y%m%d", time.gmtime())
            return f"{date}-{sha.stdout.strip()}{suffix}"
    except Exception:
        pass
    return f"{__version__}-{time.strftime('%Y-%m-%d', time.gmtime())}"
