"""Times the ceiling probe of other builds of ``csrc/probes.cu`` beside
this checkout's, in turns on one card, for comparing two designs of the
kernel.

    python -m calitas_tpu_torch.ops.probe_ab OTHER.cu [OTHER.cu ...] [--out PATH]

Each ``OTHER.cu`` is a complete probes source with the same C entry
point (``calitas_ceiling_probe``), for example an earlier commit's
``calitas_tpu_torch/csrc/probes.cu`` unpacked into a git-ignored
directory.  Every source is built with :data:`dp_cuda.NVCC_FLAGS`, one
``nvcc`` each, all started together, into a temporary directory (ptxas's
report goes into the result).  At T 1024, Q 20 and N 32,768
(``benchmarks/screen_ab.py``'s shape) and N = SMs x 2048 (every SM
full), on the column values ``ops/probes.py::roofline`` uses, every
build must equal :func:`probes.ceiling_probe_reference` bit for bit
(one that does not is reported and not timed, and the exit code is 1);
then each trial times every build with CUDA events around ``reps``
launches after a warm-up, the builds in order in even trials and in
reverse order in odd ones (A, B, B, A), and a build's time is the least
of its trials.  Prints one line per build and shape with the card's
name and power limit, and the whole result as JSON on the last line
(also written to ``--out``).  Needs a CUDA device; launches through this
module are not counted in ``dp_cuda.launches``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from calitas_tpu_torch.ops import dp_cuda, probes


def _build(sources: list, out_dir: Path) -> list:
    """``[(library path, ptxas report)]``: one nvcc per source, all
    started together."""
    procs = []
    for k, src in enumerate(sources):
        lib = out_dir / f"ab{k}.so"
        cmd = [dp_cuda._nvcc(), *dp_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(src)]
        procs.append((lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
    built = []
    for (lib, proc), src in zip(procs, sources):
        _out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {src}:\n{err}")
        built.append((lib, err))
    return built


def _ceiling_fn(path):
    lib = ctypes.CDLL(str(path))
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = lib.calitas_ceiling_probe
    fn.argtypes = [vp, i32, ll, i32, i32, vp, vp]
    fn.restype = i32
    return fn


def ptxas_of(report: str, Q: int = 20) -> dict:
    """Registers and spill bytes of ``ceiling_kernel<Q>`` in a ptxas
    ``-v`` report."""
    m = re.search(rf"ceiling_kernelILi{Q}E.*?\n.*?\n.*?Used (\d+) registers", report)
    s = re.search(rf"ceiling_kernelILi{Q}E.*?\n.*?(\d+) bytes spill stores, "
                  rf"(\d+) bytes spill loads", report)
    return {"registers": int(m.group(1)) if m else None,
            "spill_bytes": int(s.group(1)) + int(s.group(2)) if s else None}


def compare(sources: list, device=None, *, T: int = 1024, Q: int = 20, reps: int = 20,
            trials: int = 4, seed: int = 0) -> dict:
    """The ceiling probe of each build of ``sources`` and of this
    checkout's ``csrc/probes.cu`` (key ``"this"``) at N 32,768 and N =
    SMs x 2048: ``{"shapes": {N: {key: {"ms": least, "trials": [...],
    "bound_ms": ..., "share_of_bound": ...}}}, "ptxas": {key: ...}}``.
    The bound counts :func:`probes.probe_work` at the bounds' int32 rate
    (the larger of the white-paper rate and the peak probe's, measured
    here at N = SMs x 2048).  A build that differs from the plain version
    is not timed; its entry is ``{"equal": False}``."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError(f"probe_ab needs a CUDA device, got {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    keys = [str(s) for s in sources] + ["this"]
    this = dp_cuda.build_all(["probes"])["probes"]
    with tempfile.TemporaryDirectory() as tmp:
        built = _build([Path(s) for s in sources], Path(tmp))
        fns = [_ceiling_fn(lib) for lib, _ in built] + [_ceiling_fn(this)]
        reports = [err for _, err in built] + [this.with_name(this.name + ".log").read_text()]
        result = {"ptxas": {k: ptxas_of(r, Q) for k, r in zip(keys, reports)}, "shapes": {}}
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            fill = sms * 2048
            tcols = torch.randint(1, 16, (T, fill), generator=gen, device=device,
                                  dtype=torch.int32) | (3 << 4)
            peak_ms = probes.cuda_time_ms(lambda: probes.peak_probe(tcols, Q), reps)
            del tcols
            rate = max(probes.peak_int32_ops_per_s(device),
                       1e3 * probes.probe_work("peak_probe", T, fill, Q)[0] / peak_ms)
            result["bound_ops_per_s"] = rate
            for N in (32_768, fill):
                tcols = torch.randint(1, 16, (T, N), generator=gen, device=device,
                                      dtype=torch.int32) | (3 << 4)
                want = probes.ceiling_probe_reference(tcols, Q)
                out = torch.empty(N, dtype=torch.int32, device=device)

                def launch(fn):
                    err = fn(tcols.data_ptr(), T, N, Q, 0, out.data_ptr(), stream)
                    if err:
                        raise RuntimeError(f"ceiling probe launch failed: error {err}")

                equal = {}
                for key, fn in zip(keys, fns):
                    out.zero_()
                    launch(fn)
                    torch.cuda.synchronize()
                    equal[key] = torch.equal(out, want)
                times = {key: [] for key in keys if equal[key]}
                for trial in range(trials):
                    order = [(key, fn) for key, fn in zip(keys, fns) if equal[key]]
                    for key, fn in (order if trial % 2 == 0 else order[::-1]):
                        times[key].append(probes.cuda_time_ms(lambda fn=fn: launch(fn), reps))
                b_ms, b_by = probes.bound_ms(*probes.probe_work("ceiling_probe", T, N, Q), rate)
                result["shapes"][N] = {key: {
                    "ms": min(ts), "trials": ts, "bound_ms": b_ms, "bound_by": b_by,
                    "share_of_bound": b_ms / min(ts),
                } for key, ts in times.items()}
                result["shapes"][N].update(
                    {key: {"equal": False} for key, same in equal.items() if not same})
                del tcols, want, out
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+", help="other probes.cu sources")
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_ab: a CUDA device is required", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    result = compare(args.sources)
    result["card"] = card
    differs = [(N, key) for N, rows in result["shapes"].items()
               for key, r in rows.items() if not r.get("equal", True)]
    for N, key in differs:
        print(f"[probe_ab] {card} | T 1024, Q 20, N {N}: {key} differs from the plain version")
    for N, rows in result["shapes"].items():
        for key, r in rows.items():
            if (N, key) in differs:
                continue
            print(f"[probe_ab] {card} | T 1024, Q 20, N {N}: {key} {r['ms']:.4f} ms "
                  f"(trials {', '.join(f'{t:.4f}' for t in r['trials'])}), bound "
                  f"{r['bound_ms']:.4f} ms by {r['bound_by']}, "
                  f"{100 * r['share_of_bound']:.2f} % of the bound; ptxas {result['ptxas'][key]}")
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 1 if differs else 0


if __name__ == "__main__":
    sys.exit(main())
