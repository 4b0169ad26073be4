"""The roofline probes: their plain PyTorch versions equal the Pallas
probes of ``benchmarks/screen_ab.py`` (``_ceiling_kernel``,
``_peak_kernel``, run in interpret mode with ``_probe_call``'s block
specs) exactly, in int32, and the CUDA kernels equal the plain versions
on the card (marked ``cuda``; they skip where torch sees no CUDA device:
``python -m pytest tests/test_torch_probes.py -m cuda`` on the GPU
machine).  jax is imported inside the CPU tests only: the GPU machine has
none."""

import importlib.util
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

from calitas_tpu_torch.ops import dp_cuda, probe_ab, probes

ROOT = Path(__file__).resolve().parent.parent
CASES = [  # (T, Q, bias, blocks of 8 x 128 lanes)
    (16, 5, 0, 2), (7, 1, -3, 1), (12, 9, 11, 2), (5, 20, -1, 1),
]


def _screen_ab():
    spec = importlib.util.spec_from_file_location(
        "screen_ab_for_test", ROOT / "benchmarks" / "screen_ab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas_probe(sa, kernel, bias: int, tcols: np.ndarray, T: int, Q: int) -> np.ndarray:
    """``_probe_call`` with ``interpret=True``: tcols [T, nb*8, 128]."""
    import jax
    import jax.numpy as jnp

    pl, pltpu = sa.pl, sa.pltpu
    n_blocks = tcols.shape[1] // sa.SUBLANES
    out = pl.pallas_call(
        partial(kernel, T=T, Q=Q),
        grid=(n_blocks,),
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.SMEM),
            pl.BlockSpec((T, sa.SUBLANES, sa.LANES), lambda i: (0, i, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((sa.SUBLANES, sa.LANES), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n_blocks * sa.SUBLANES, sa.LANES), jnp.int32),
        interpret=True,
    )(jnp.asarray([bias], jnp.int32), jnp.asarray(tcols))
    return np.asarray(out)


def _tcols(seed: int, T: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(-100, 100, size=(T, n), dtype=np.int32)


@pytest.mark.parametrize("T,Q,bias,nb", CASES)
@pytest.mark.parametrize("name", ["ceiling_probe", "peak_probe"])
def test_plain_probe_equals_pallas_probe(name, T, Q, bias, nb):
    sa = _screen_ab()
    kernel = sa._ceiling_kernel if name == "ceiling_probe" else sa._peak_kernel
    lanes = nb * sa.SUBLANES * sa.LANES
    tcols = _tcols(T * 100 + Q, T, lanes)
    want = _pallas_probe(sa, kernel, bias, tcols.reshape(T, nb * sa.SUBLANES, sa.LANES), T, Q)
    plain = getattr(probes, name + "_reference")
    got = plain(torch.from_numpy(tcols), Q, bias)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    # The wrapper takes the plain version for a CPU tensor and counts no launch.
    launches = dict(dp_cuda.launches)
    assert torch.equal(getattr(probes, name)(torch.from_numpy(tcols), Q, bias), got)
    assert dp_cuda.launches == launches
    assert probes.PEAK_C == sa.PEAK_C


@pytest.mark.parametrize("name", ["ceiling_probe", "peak_probe"])
def test_probe_wrapper_rejects_bad_input(name):
    fn = getattr(probes, name)
    with pytest.raises(ValueError):
        fn(torch.zeros((4, 8), dtype=torch.int64), 3)
    with pytest.raises(ValueError):
        fn(torch.zeros(8, dtype=torch.int32), 3)
    with pytest.raises(ValueError):
        fn(torch.zeros((8, 4), dtype=torch.int32).t(), 3)
    with pytest.raises(ValueError):
        fn(torch.zeros((4, 8), dtype=torch.int32), 0)


def test_work_and_bounds():
    assert probes.probe_work("ceiling_probe", 1024, 32_768, 20) == (
        2 * 20 * 1024 * 32_768, 4 * 1024 * 32_768 + 4 + 4 * 32_768)
    assert probes.probe_work("peak_probe", 2, 3, 4)[0] == 2 * 4 * 2 * 3 * probes.PEAK_C
    # config3's grid: 41,238 windows, 2 chains, Q 20, the 40 Mb span read once
    ops, nbytes = probes.grid_work(40_000_000, 0, 973, 41_238, 1000, 20)
    assert ops == 2 * 2 * 20 * 41_238 * 1000
    assert nbytes == 40_000_000 + 2 * 20 * 4 + 4 + 2 * 41_238 * 4 * 3
    ops, _ = probes.grid_work(10_000, 0, 973, 20, 1000, 20, guides=4, emit_ranges=False)
    assert ops == 2 * 4 * 2 * 20 * 20 * 1000
    ops, nbytes = probes.rows_work([3, 0, 5], 20, 2, True, True)
    assert ops == 2 * 8 * 20 * 2
    assert nbytes == 8 + 12 + 2 * 3 * 20 + 12 + 2 * 3 * 4 * 3
    assert probes.bound_ms(1e12, 1, 1e13) == (100.0, "operations")
    assert probes.bound_ms(1, 3.35e12, 1e13) == (1000.0, "bytes")


def _kernel_ring() -> tuple[int, int]:
    """``(kAhead, kRound)`` of ``csrc/probes.cu``: the ceiling kernel's
    ring depth and steps per round."""
    import re

    src = (ROOT / "calitas_tpu_torch" / "csrc" / "probes.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
                 for name in ("kAhead", "kRound"))


def _wavefront_model(tcols: np.ndarray, Q: int, bias: int, ahead: int, unroll: int,
                     head: str) -> np.ndarray:
    """The CUDA ceiling kernel's step order, in numpy, over all lanes at
    once: one value per row, s[0..Q]; at step k row i works on column
    k - i, the rows update in descending order (s[i] = max(s[i] + 1,
    s[i-1]) for i = Q..1), then s[0] takes column k; ``best`` takes row Q
    at steps Q..T+Q-1.  Column values come from a ring of ``ahead``
    entries, each refilled ``ahead`` columns on, in rounds of ``unroll``
    steps whose bounds are the kernel's three loops; a round the kernel
    runs unguarded must need no guard.

    ``head="ramp"`` is the kernel: row i starts at -i and moves in every
    step, the rows past column T - 1 too.  ``head="guard"`` starts every
    row at 0 and moves row i only while its column k - i lies in [0, T)."""
    T, N = tcols.shape
    s = np.zeros((Q + 1, N), np.int32)
    if head == "ramp":
        s[1:] = -np.arange(1, Q + 1, dtype=np.int32)[:, None]
    ring = [tcols[u].copy() if u < T else np.zeros(N, np.int32) for u in range(ahead)]
    best = np.full(N, -(2**30), np.int32)

    def round_(k0: int, guarded: bool) -> None:
        nonlocal best
        for u in range(unroll):
            k = k0 + u
            if not guarded:
                assert Q <= k < T + Q and k + ahead < T
            for i in range(Q, 0, -1):
                if head == "ramp" or 0 <= k - i < T:
                    s[i] = np.maximum(s[i] + np.int32(1), s[i - 1])
            if Q <= k < T + Q:
                best = np.maximum(best, s[Q])
            s[0] = ring[k % ahead] + np.int32(bias)
            if k + ahead < T:
                ring[k % ahead] = tcols[k + ahead].copy()

    k = 0
    while k < Q:
        round_(k, True)
        k += unroll
    while k + unroll + ahead <= T:
        round_(k, False)
        k += unroll
    while k < T + Q:
        round_(k, True)
        k += unroll
    return best


#: the ceiling's edge shapes (T, Q, bias, N): T < Q, T = Q, T = Q + 1,
#: T = 1, Q = 1, Q = 48, N = 1, N not a multiple of the 64-thread block,
#: bias below 0
EDGE_SHAPES = [
    (5, 20, -7, 64), (20, 20, 3, 65), (21, 20, -1, 130), (1, 20, 0, 64),
    (1, 1, -5, 1), (7, 1, 11, 70), (100, 48, 11, 1), (37, 48, -9, 131),
    (1024, 20, -2, 67), (50, 20, 0, 33),
]


@pytest.mark.parametrize("head", ["ramp", "guard"])
@pytest.mark.parametrize("T,Q,bias,N", [
    *EDGE_SHAPES,
    (30, 20, 2**31 - 60, 5),  # tcol + bias wraps in int32, in both
])
def test_wavefront_order_equals_plain_ceiling(T, Q, bias, N, head):
    """The skewed wavefront's order (the kernel's, and the one with every
    row guarded outside its columns) gives the plain ceiling's result bit
    for bit, at the kernel's ring and rounds and at shorter ones (more
    guarded rounds against T and Q)."""
    tcols = _tcols(T * 7 + Q + N, T, N)
    want = probes.ceiling_probe_reference(torch.from_numpy(tcols), Q, bias).numpy()
    for ahead, unroll in (_kernel_ring(), (16, 16), (4, 2), (1, 1)):
        got = _wavefront_model(tcols, Q, bias, ahead, unroll, head)
        np.testing.assert_array_equal(got, want)


def test_ceiling_shares():
    # config3's dual grid at 0.41 ms against a ceiling of 1e13 cells/s at
    # one N and 2e13 at another: 2 chains per window
    ops, _ = probes.grid_work(40_000_000, 0, 973, 41_238, 1000, 20)
    row = {"ops_per_s": 1e3 * ops / 0.41}
    got = probes.ceiling_shares(row, 2, {32_768: 1e13, 270_336: 2e13})
    cells = 2 * 20 * 41_238 * 1000 / 0.41e-3
    assert got["cells_per_s"] == pytest.approx(cells)
    assert got["cells_per_s_per_chain"] == pytest.approx(cells / 2)
    assert got["share_of_ceiling"] == pytest.approx({32_768: cells / 1e13,
                                                     270_336: cells / 2e13})
    assert got["share_of_ceiling_per_chain"] == pytest.approx(
        {32_768: cells / 2e13, 270_336: cells / 4e13})


def test_roofline_needs_a_cuda_device():
    with pytest.raises(ValueError):
        probes.roofline("cpu")
    with pytest.raises(ValueError):
        probe_ab.compare([], "cpu")


def test_probe_ab_reads_ptxas():
    report = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114ceiling_kernelILi20EEEvPKiixiPi'"
        " for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_114ceiling_kernelILi20EEEvPKiixiPi\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 56 registers, used 0 barriers, 8192 bytes smem\n"
    )
    assert probe_ab.ptxas_of(report) == {"registers": 56, "spill_bytes": 12}
    assert probe_ab.ptxas_of(report, 48) == {"registers": None, "spill_bytes": None}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T,N,Q,bias", [
    (16, 2048, 5, 0), (7, 1000, 1, -3), (33, 4096, 48, 9), (1024, 32_768, 20, -1),
    *((T, N, Q, bias) for T, Q, bias, N in EDGE_SHAPES),
])
@pytest.mark.parametrize("name", ["ceiling_probe", "peak_probe"])
def test_kernel_equals_plain_probe(cuda, name, T, N, Q, bias):
    tcols = torch.from_numpy(_tcols(T + N + Q, T, N)).to(cuda)
    launches = dp_cuda.launches[name]
    got = getattr(probes, name)(tcols, Q, bias)
    torch.cuda.synchronize()
    assert dp_cuda.launches[name] == launches + 1
    want = getattr(probes, name + "_reference")(tcols, Q, bias)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_probe_rejects_long_query(cuda):
    with pytest.raises(NotImplementedError):
        probes.ceiling_probe(torch.zeros((2, 8), dtype=torch.int32, device=cuda), 49)
