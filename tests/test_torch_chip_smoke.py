"""``chip_smoke.py`` leaves no process behind: after a spawned finish pool
(the port's ``host_pool``, as the list tools and the variant pass start
it) and a stray child, ``stop_processes`` ends them and the resource
tracker, and once the script exits nothing of its session is left.
Runs on the CPU, in a subprocess of its own session."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent(f"""
    import subprocess, sys
    sys.path.insert(0, {str(ROOT)!r})
    import chip_smoke
    from calitas_tpu_torch.parallel import host_pool

    pool = host_pool._shared_pool(2)
    assert list(pool.map(abs, range(-4, 4))) == [4, 3, 2, 1, 0, 1, 2, 3]
    subprocess.Popen(["sleep", "60"])
    assert len(chip_smoke.own_processes()) >= 2  # a worker or the tracker, and sleep
    chip_smoke.stop_processes(host_pool)
    assert chip_smoke.own_processes() == []
    assert host_pool._SHARED_POOL is None
    print("stopped")
""")


def session_members(sid: int) -> list:
    out = []
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                fields = (d / "stat").read_text().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(fields[3]) == sid:
                out.append((int(d.name), fields[0]))
    return out


def test_stop_processes_leaves_nothing_running():
    proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, start_new_session=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    assert proc.returncode == 0, err
    assert "stopped" in out
    assert "after stopping the resource tracker and any other descendant: []" in out
    # The session's leader was the script: nothing of it may outlive it.
    assert session_members(proc.pid) == []
