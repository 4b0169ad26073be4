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

from calitas_tpu_torch.ops import dp_cuda, probes

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


def test_roofline_needs_a_cuda_device():
    with pytest.raises(ValueError):
        probes.roofline("cpu")


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T,N,Q,bias", [
    (16, 2048, 5, 0), (7, 1000, 1, -3), (33, 4096, 48, 9), (1024, 32_768, 20, -1),
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
