"""K15's tiling (``csrc/resample.cu``) on the CPU, where the kernel cannot
run: the banded bank the wrapper passes it (``ops.resample.band_bank``),
the super-cycles, and a numpy evaluation of the kernel in its own tile
and loop order, block by block and warp by warp, over the shared-memory
layout it stages (the pitched span, then the output tile), in float64
with j ascending. That evaluation is held to the polyphase sum in float64
(and to ``resample_np``, which sums in float32), one-shot, with a carried
history and in chunks; it writes every output exactly once, reads only
staged words, and stays inside the shared memory the plan asks for."""
import numpy as np
import pytest

from soundkit_tpu_torch.ops import resample as rs
from soundkit_tpu_torch.tools import kernel_check as kc

S = rs.SINC_LEN
P = rs.GROUP_PHASES
PAIRS = sorted(set(kc.RESAMPLE_PAIRS) | {(3000, 2000)})


def _xpad(x, hist, need):
    """hist ++ x ++ zeros, [B, need] float64."""
    B, n = x.shape
    h = np.zeros((B, S - 1)) if hist is None else hist.astype(np.float64)
    xa = np.concatenate([h, x.astype(np.float64)], axis=1)
    return np.pad(xa, ((0, 0), (0, max(0, need - xa.shape[1]))))


def polyphase_f64(x, hist, in_rate, out_rate, n_out):
    """y[b, k] = sum_q taps_rev[p, q] xpad[b, floor(k M / L) + q] in float64."""
    taps, off, L, M = rs.design_polyphase(in_rate, out_rate)
    k = np.arange(n_out)
    start = k * M // L
    xp = _xpad(x, hist, int(start.max()) + S + 1 if n_out else 0)
    win = xp[:, start[:, None] + np.arange(S)[None, :]]  # [B, n_out, S]
    return np.einsum("bks,ks->bk", win, taps[k % L].astype(np.float64))


def k15_tile_eval(x, hist, in_rate, out_rate, n_out, plan=None):
    """K15 as the kernel runs it -> (out float64 [B, n_out], writes [B, n_out])."""
    W, meta, _, Lq, Mq, _ = rs.band_bank(in_rate, out_rate)
    plan = plan or rs.k15_plan(in_rate, out_rate, n_out)
    B, n = x.shape
    words = plan.smem // 4 - plan.WS * plan.GB * plan.band_max * P  # the bank rows after
    ncp = -(-n_out // Lq)
    out = np.full((B, n_out), np.nan)
    writes = np.zeros((B, n_out), dtype=np.int64)
    opitch = plan.GB * P + 4
    lanes = np.arange(32)
    for b in range(B):
        for bx in range(plan.tiles * plan.chunks):
            g0 = bx % plan.chunks * plan.GB
            gn = min(plan.GB, plan.G - g0)
            c0 = bx // plan.chunks * plan.ct
            lo = int(meta[g0, 0])
            span = (plan.ct - 1) * Mq + int(meta[g0 + gn - 1].sum()) - lo
            # staging
            sm = np.full(words, np.nan)
            s = np.arange(span)
            e = c0 * Mq + lo - (S - 1) + s
            v = np.zeros(span)
            if hist is not None:
                v[e < 0] = hist[b, e[e < 0] + S - 1]
            inx = (e >= 0) & (e < n)
            v[inx] = x[b, e[inx]]
            gap = plan.pitch - Mq
            addr = s + s // Mq * gap
            assert addr.max() < words
            sm[addr] = v
            # the warps
            tile = np.full(words, np.nan)
            for warp in range(plan.S * plan.GB):
                gi, u0 = warp % plan.GB, warp // plan.GB * 32 * plan.RC
                if gi >= gn:
                    continue
                acc = np.zeros((32, plan.RC, P))
                if c0 + u0 < ncp:
                    base = int(meta[g0 + gi, 0]) - lo
                    band = int(meta[g0 + gi, 1])
                    j = np.arange(band)
                    skips = ((base + j) // Mq - base // Mq) * gap
                    first = (u0 + lanes) * plan.pitch + base + base // Mq * gap
                    rows = first[:, None] + 32 * plan.pitch * np.arange(plan.RC)[None, :]
                    a = rows[:, :, None] + (j + skips)[None, None, :]  # [32, RC, band]
                    assert a.max() < words
                    xs = sm[a]
                    assert not np.isnan(xs).any(), "a read of an unstaged word"
                    acc = xs @ W[g0 + gi, :band].astype(np.float64)
                for r in range(plan.RC):
                    dst = (u0 + lanes + 32 * r) * opitch + gi * P
                    tile[dst[:, None] + np.arange(P)[None, :]] = acc[:, r]
            # the copy-out, u = f / width by the kernel's float32 reciprocal
            width = gn * P
            inv = np.float32(1.0) / np.float32(width)
            f = np.arange(plan.ct * width)
            u = ((f.astype(np.float32) + np.float32(0.5)) * inv).astype(np.int64)
            assert np.array_equal(u, f // width)
            i = f - u * width
            p = g0 * P + i
            k = (c0 + u) * Lq + p
            ok = (p < Lq) & (k < n_out)
            vals = tile[u * opitch + i][ok]
            assert not np.isnan(vals).any(), "an output the warps did not write"
            out[b, k[ok]] = vals
            np.add.at(writes[b], k[ok], 1)
    return out, writes


def _rows(seed, B, n):
    return kc.resample_rows(seed, B, n, "cpu").numpy()


@pytest.mark.parametrize("in_rate,out_rate", PAIRS)
def test_band_bank_holds_each_phase_taps_in_its_group(in_rate, out_rate):
    """Every super-phase's 256 taps sit in its group's band at j = off_i -
    off_first + q; everything else in the band is zero; a group's band is
    its last offset less its first, plus 256."""
    taps, off, L, M = rs.design_polyphase(in_rate, out_rate)
    W, meta, g, Lq, Mq, offp = rs.band_bank(in_rate, out_rate)
    assert W.shape == (-(-Lq // P), int(meta[:, 1].max()), P) and W.dtype == np.float32
    seen = np.zeros(W.shape, dtype=bool)
    for sp in range(Lq):
        k, i = divmod(sp, P)
        d = int(offp[sp] - meta[k, 0])
        np.testing.assert_array_equal(W[k, d:d + S, i], taps[sp % L])
        seen[k, d:d + S, i] = True
    assert not W[~seen].any()
    for k in range(W.shape[0]):
        last = min(P * k + P, Lq) - 1
        assert meta[k, 0] == offp[P * k] and meta[k, 1] == offp[last] - offp[P * k] + S


@pytest.mark.parametrize("in_rate,out_rate", PAIRS)
def test_super_cycle_offsets_and_stride(in_rate, out_rate):
    """g cycles make a super-cycle: Lq = g L outputs from Mq = g M inputs,
    super-phase r L + p at r M + off[p]; output c Lq + p' then starts its
    window at floor((c Lq + p') M / L), where the reference starts it."""
    _, off, L, M = rs.design_polyphase(in_rate, out_rate)
    _, _, g, Lq, Mq, offp = rs.band_bank(in_rate, out_rate)
    assert g == rs.super_cycle(L) and (Lq, Mq) == (g * L, g * M)
    assert (L >= 16 and g == 1) or (L < 16 and Lq % P == 0)
    for r in range(g):
        np.testing.assert_array_equal(offp[r * L:(r + 1) * L], r * M + off)
    c = np.arange(5)[:, None]
    k = c * Lq + np.arange(Lq)[None, :]
    np.testing.assert_array_equal(c * Mq + offp[None, :], k * M // L)


@pytest.mark.parametrize("in_rate,out_rate", PAIRS)
def test_tile_order_evaluation_matches_the_polyphase_sum(in_rate, out_rate):
    """One-shot, from a carried history, and in three chunks with the
    history carried, the kernel's tile order gives the float64 polyphase
    sum within 1e-9 and writes each output once; one-shot it is
    ``resample_np`` within float32 rounding."""
    _, _, L, M = rs.design_polyphase(in_rate, out_rate)
    n = 9 * M + 37
    x = _rows(in_rate % 997 + out_rate % 89, 2, n)
    n_out = rs.out_len(n, L, M)
    got, writes = k15_tile_eval(x, None, in_rate, out_rate, n_out)
    assert (writes == 1).all()
    np.testing.assert_allclose(got, polyphase_f64(x, None, in_rate, out_rate, n_out),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(got, rs.resample_np(x, in_rate, out_rate), rtol=0, atol=1e-5)

    hist = _rows(7, 2, S - 1)
    got, writes = k15_tile_eval(x, hist, in_rate, out_rate, n_out)
    assert (writes == 1).all()
    np.testing.assert_allclose(got, polyphase_f64(x, hist, in_rate, out_rate, n_out),
                               rtol=0, atol=1e-9)

    chunk = 3 * M
    xs = _rows(11, 2, 3 * chunk)
    h, outs = None, []
    for lo in range(0, xs.shape[1], chunk):
        part = xs[:, lo:lo + chunk]
        o, w = k15_tile_eval(part, h, in_rate, out_rate, chunk * L // M)
        assert (w == 1).all()
        outs.append(o)
        h = xs[:, max(0, lo + chunk - (S - 1)):lo + chunk]
        if h.shape[1] < S - 1:
            h = np.pad(h, ((0, 0), (S - 1 - h.shape[1], 0)))
    np.testing.assert_allclose(np.concatenate(outs, axis=1),
                               polyphase_f64(xs, None, in_rate, out_rate, 3 * chunk * L // M),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("shape", ["transcode", "stretch", "one_row", "ragged"])
def test_tile_order_at_the_paths_shapes(shape):
    """The launches the paths make (one row each): the transcode chunk
    (44.1 -> 8 kHz, 28,224 samples and a history: two slabs of super-cycles
    in one block), the pitch shift's 3000 -> 2000 over a long row (seven
    tiles, the last partly past the row), a row of one output, and n_out
    short of a whole super-cycle."""
    a, b, n, hist = {"transcode": (44100, 8000, 28224, True), "stretch": (3000, 2000, 33075, False),
                     "one_row": (3000, 2000, 1, False), "ragged": (44100, 8000, 883, False)}[shape]
    _, _, L, M = rs.design_polyphase(a, b)
    x = _rows(3, 1, n)
    h = _rows(4, 1, S - 1) if hist else None
    n_out = rs.out_len(n, L, M)
    got, writes = k15_tile_eval(x, h, a, b, n_out)
    assert (writes == 1).all()
    np.testing.assert_allclose(got, polyphase_f64(x, h, a, b, n_out), rtol=0, atol=1e-9)


@pytest.mark.parametrize("Mq", [1, 2, 3, 4, 6, 7, 8, 12, 16, 24, 40, 80, 96, 147, 160, 441, 640])
def test_pitch_spreads_the_lanes_over_the_banks(Mq):
    """The 32 lanes, one super-cycle (``pitch`` words) apart, read 32 banks
    a step: the pitch is odd, ``Mq`` or one more."""
    pitch = rs.k15_pitch(Mq)
    assert pitch - Mq in (0, 1) and pitch % 2 == 1
    assert len(set((np.arange(32) * pitch) % 32)) == 32


@pytest.mark.parametrize("in_rate,out_rate", PAIRS)
def test_launch_stays_under_the_shared_memory_limit(in_rate, out_rate):
    """At every row length the plan's block fits the card (227 KB of shared
    memory, the warps its instance allows) and its staged span and output
    tile fit the shared memory it asks for, before the bank rows it stages
    wherever a block holds both."""
    W, meta, _, Lq, Mq, _ = rs.band_bank(in_rate, out_rate)
    for n_out in (1, Lq - 1, 5120, 110250, 10 ** 6):
        plan = rs.k15_plan(in_rate, out_rate, n_out)
        assert plan.smem <= rs.SMEM_LIMIT and plan.threads <= 32 * rs.max_warps(plan.RC)
        assert plan.tiles * plan.ct >= -(-n_out // Lq) > (plan.tiles - 1) * plan.ct
        span = (plan.ct - 1) * Mq + max(int(meta[min(k + plan.GB, plan.G) - 1].sum())
                                         - int(meta[k, 0]) for k in range(0, plan.G, plan.GB))
        last = span - 1 + (span - 1) // Mq * (plan.pitch - Mq)
        words = plan.smem // 4 - plan.WS * plan.GB * plan.band_max * P
        assert words % 4 == 0 and last < words
        assert plan.ct * (plan.GB * P + 4) <= words
        one_slab = rs._tile_smem(meta, Mq, plan.pitch, plan.GB, 32 * plan.RC)
        assert plan.WS == (one_slab + plan.GB * plan.band_max * P * 4 <= rs.SMEM_LIMIT)
