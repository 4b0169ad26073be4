"""A NumPy model of ``csrc/pam_annotate.cu``'s word arithmetic, held bit
for bit against the plain version (``annotate_genome_pam_reference``) on
the CPU: the bit-plane transposes, the match planes of the distinct base
masks, the bit-sliced mismatch counters, the gap offsets as funnel shifts,
the way back to bits 4/5, and the tiles with their halos.  The kernel
itself is held against the plain version on the card
(tests/test_torch_dp_cuda.py); this model lets the design be checked
where there is no card."""

import numpy as np
import pytest
import torch

from calitas_tpu_torch.ops import dp_cuda
from calitas_tpu_torch.ops import genome_screen as gs

M32 = 0xFFFFFFFF
THREADS = 256  # the kernel's kThreads = kWords
HALO_WORDS = 3
TILE_WORDS = THREADS - 2 * HALO_WORDS
TILE = 32 * TILE_WORDS  # kTile, 8,000 positions


def _u32(x):
    return np.asarray(x, dtype=np.uint64) & M32


def funnel_r(lo, hi, s):
    """``__funnelshift_r``: the low word of (hi:lo) >> (s & 31)."""
    return ((_u32(hi) << 32 | _u32(lo)) >> (s & 31)) & M32


def funnel_l(lo, hi, s, clamp=False):
    """``__funnelshift_l`` (``_lc`` with ``clamp``): the high word of
    (hi:lo) << s, s taken mod 32 or clamped to 32."""
    s = min(s, 32) if clamp else s & 31
    return (((_u32(hi) << 32 | _u32(lo)) << s) >> 32) & M32


def byte_perm(x, y, sel):
    """``__byte_perm``: byte n of the result is byte (sel >> 4n) & 7 of
    (y:x)."""
    both = [(_u32(x) >> 8 * i) & 0xFF for i in range(4)] + [(_u32(y) >> 8 * i) & 0xFF for i in range(4)]
    return sum(both[(sel >> 4 * n) & 7] << 8 * n for n in range(4))


def transpose4(x):
    t = (x ^ (x >> 14)) & 0x0000CCCC
    x = x ^ t ^ ((t << 14) & M32)
    t = (x ^ (x >> 7)) & 0x00AA00AA
    return x ^ t ^ ((t << 7) & M32)


def to_planes(w):
    """``to_planes``: 8 words of 4 position bytes each -> bit planes b."""
    u = [transpose4((w[2 * k] & 0x0F0F0F0F) | ((w[2 * k + 1] << 4) & 0xF0F0F0F0)) for k in range(4)]
    a, b = byte_perm(u[0], u[1], 0x5140), byte_perm(u[0], u[1], 0x7362)
    c, d = byte_perm(u[2], u[3], 0x5140), byte_perm(u[2], u[3], 0x7362)
    return [byte_perm(a, c, 0x5410), byte_perm(a, c, 0x7632),
            byte_perm(b, d, 0x5410), byte_perm(b, d, 0x7632)]


def merge_gate(w, end, start):
    w = list(w)
    for k in (0, 2):
        x = transpose4(byte_perm(end, start, k | (4 + k) << 4 | (k + 1) << 8 | (5 + k) << 12))
        w[2 * k] |= (x << 4) & 0x30303030
        w[2 * k + 1] |= x & 0x30303030
        w[2 * k + 2] |= (x << 2) & 0x30303030
        w[2 * k + 3] |= (x >> 2) & 0x30303030
    return w


def rc_mask(m):
    return ((m & 1) << 3) | ((m & 2) << 1) | ((m & 4) >> 1) | ((m & 8) >> 3)


def fit_plane(match, t, idx, plen, levels, forward):
    c = [0] * levels
    for k in range(plen):
        m = match[idx[k]]
        hit = funnel_r(m[t], m[t + 1], k) if forward else funnel_l(m[t - 1], m[t], plen - 1 - k)
        miss = ~hit & M32
        for lev in range(levels - 1, 0, -1):
            c[lev] |= c[lev - 1] & miss
        c[0] |= miss
    return ~c[levels - 1] & M32


def kernel_model(genome: np.ndarray, spec) -> np.ndarray:
    """``calitas_pam_annotate`` and its kernel, word for word, on the
    host (vectorized over a tile's words)."""
    pams, max_mm, gap = spec
    masks, index = [], {}
    fwd, rev = [], []
    for p in pams:
        def distinct(m):
            if m not in index:
                index[m] = len(masks)
                masks.append(m)
            return index[m]
        fwd.append([distinct(m) for m in p])
        rev.append([distinct(rc_mask(m)) for m in reversed(p)])
    levels = min(max_mm + 1, 17)
    n = len(genome)
    out = genome.copy()
    for tile in range(-(-n // TILE)):
        base = tile * TILE - 32 * HALO_WORDS
        raw = np.zeros(32 * THREADS, np.uint8)
        lo, hi = max(base, 0), min(base + raw.size, n)
        raw[lo - base : hi - base] = genome[lo:hi]
        w = [_u32(col) for col in raw.view("<u4").reshape(THREADS, 8).T]  # w[k][t]
        p = to_planes(w)
        match = [np.bitwise_or.reduce([p[b] * (m >> b & 1) for b in range(4)]) for m in masks]
        t = np.arange(2, THREADS - 1)  # the threads that compute fit planes
        fe = np.zeros(THREADS, np.uint64)
        fs = np.zeros(THREADS, np.uint64)
        for f, r, plen in zip(fwd, rev, map(len, pams)):
            fe[t] |= fit_plane(match, t, f, plen, levels, True)
            fs[t] |= fit_plane(match, t, r, plen, levels, False)
        t = np.arange(HALO_WORDS, HALO_WORDS + TILE_WORDS)
        a, b, c = fe[t], fe[t + 1], fe[t + 2]
        end = np.zeros(len(t), np.uint64)
        for o in range(1, gap + 2):
            end |= funnel_r(a, b, o) if o < 32 else funnel_r(b, c, o - 32)
        start = fs[t].copy()
        for o in range(1, gap + 1):
            start |= funnel_l(fs[t - 1], fs[t], o, clamp=True)
        words = merge_gate([x[t] for x in w], end, start)
        tile_bytes = np.stack(words, axis=1).astype("<u4").view(np.uint8).reshape(-1)
        lo, hi = tile * TILE, min(tile * TILE + TILE, n)
        out[lo:hi] = tile_bytes[: hi - lo]
    return out


SPECS = [
    (("nrg",), 1, 3),
    (("ngg", "nag"), 1, 0),
    (("tttv",), 0, 2),
    (("nrg", "nnnrrt"), 2, 1),
    (("tttv",), 4, 3),
    (("nrg",), 255, dp_cuda.PAM_MAX_GAP),
    (tuple(("acgtrymkswbdhvnn" * 2)[i : i + 16] for i in range(dp_cuda.PAM_MAX_PAMS)), 5, 31),
    (("acgtacgtacgtacgt", "nrg"), 9, 2),
]


@pytest.mark.parametrize("length", [1, 32, 777, TILE - 1, TILE + 2, 2 * TILE + 97, 3 * TILE + 64])
@pytest.mark.parametrize("spec", SPECS)
def test_model_matches_plain_version(spec, length):
    enc = gs.encode_pam_spec(spec)
    assert dp_cuda.annotates_on_kernel(enc, "cuda")
    rng = np.random.default_rng(length + len(spec[0]))
    genome = rng.choice(np.array([1, 2, 4, 8, 0, 5, 10, 15], np.uint8), length,
                        p=[.22] * 4 + [.03] * 4)
    if length % 2:
        genome = rng.integers(0, 256, length, dtype=np.uint8)  # bits 4-7 come through
    want = gs.annotate_genome_pam_reference(torch.from_numpy(genome), enc).numpy()
    np.testing.assert_array_equal(kernel_model(genome, enc), want)
