"""K11's schedule (``csrc/celt_postfilter.cu``) on the CPU, where the
kernel cannot run: a numpy mirror of its order of work, held to
``celt_postfilter_plain``.

The mirror runs the comb by regions (set a for the first 120 samples, set
b to 240, set b's second tap alone after, where the first's crossfade
weight is 0), each at a step width bounded only by the periods of the taps
whose gains are not all zero (at most 128 samples); a zero tap reads at its
region's other period, and a region with no active tap runs no comb. Then
the de-emphasis in the kernel's scan order: a lane a block in rounds of 32
blocks, the carried memory through a round by five Kogge-Stone levels of
``s + m^d s_{l-d}``. The comb's output (the new history) equals the plain
version's but for the sign of a zero; the PCM and the memory hold 1e-5 of
the largest plain value."""
import numpy as np
import pytest
import torch

from soundkit_tpu_torch.ops import celt_postfilter as cp
from soundkit_tpu_torch.tools import kernel_check as kc

F = np.float32
SMAX, WARP, BLK, NBLK = 128, 32, 8, 120
N, OV, HIST = cp.N, cp.OVERLAP, cp.HIST


def _period(v) -> int:
    return min(max(int(v), cp.T_MIN), cp.T_MAX)


def k11_plan(comb_row: np.ndarray) -> dict:
    """The kernel's make_plan: each region's tap periods (a zero tap's its
    region's other one) and step width (0: no comb there)."""
    on = comb_row != 0
    ga, gb, gc, gd = (bool(on[s: s + 3].any()) for s in (2, 5, 10, 13))
    ta0, ta1, tb0, tb1 = (_period(comb_row[i]) for i in (0, 1, 8, 9))
    a0, a1 = (ta0 if ga else ta1), (ta1 if gb else ta0)
    b0, b1 = (tb0 if gc else tb1), (tb1 if gd else tb0)
    return dict(a=(a0, a1, min(SMAX, min(a0, a1) - 2) if ga or gb else 0),
                b=(b0, b1, min(SMAX, min(b0, b1) - 2) if gc or gd else 0),
                b2=(tb1, tb1, min(SMAX, tb1 - 2) if gd else 0))


def _tap5(x, p, T, g):
    a = g[0] * x[p - T]
    b = g[1] * (x[p - T - 1] + x[p - T + 1])
    c = g[2] * (x[p - T - 2] + x[p - T + 2])
    return (a + b) + c


def k11_schedule(full, comb, valid, ola, hist, emph):
    """(pcm, new_ola, new_hist, new_emph) of :func:`cp.celt_postfilter` in
    the kernel's order."""
    full, comb, valid, ola, hist, emph = (t.numpy() for t in (full, comb, valid, ola, hist, emph))
    B, C, _ = full.shape
    tab = cp.kernel_tables(torch.device("cpu")).numpy()
    w2, cpow, mpow = tab[:OV], tab[OV: OV + BLK + 1], tab[OV + BLK + 1:]
    pcm = np.zeros((B, C, N), F)
    new_ola, new_hist, new_emph = ola.copy(), hist.copy(), emph.copy()
    for b in range(B):
        if not valid[b]:
            continue
        q = k11_plan(comb[b])
        gains = [comb[b, s: s + 3] for s in (2, 5, 10, 13)]
        for c in range(C):
            frame = full[b, c, :N].copy()
            frame[:OV] = frame[:OV] + ola[b, c]
            x = np.concatenate([hist[b, c], frame])
            for (T0, T1, S), (js, je), (g0, g1), xf in (
                    (q["a"], (0, OV), gains[0:2], True), (q["b"], (OV, 2 * OV), gains[2:4], True),
                    (q["b2"], (2 * OV, N), gains[3:4] * 2, False)):
                for j0 in range(js, je, S or je):
                    if not S:
                        break
                    j = np.arange(j0, min(j0 + S, je))
                    p = HIST + j
                    y1 = _tap5(x, p, T1, g1)
                    if xf:
                        f = w2[j - js]
                        y = (x[p] + (F(1) - f) * _tap5(x, p, T0, g0)) + f * y1
                    else:
                        y = x[p] + y1
                    x[p] = y  # every read of the step lies before it
            y = x[HIST:].reshape(NBLK, BLK)
            a = np.zeros(NBLK, F)
            for i in range(BLK):
                a = a + y[:, i] * cpow[BLK - 1 - i]
            out = np.zeros((NBLK, BLK), F)
            em = emph[b, c]
            for r in range(-(-NBLK // WARP)):
                n = np.arange(WARP) + WARP * r
                s = np.where(n < NBLK, a[np.minimum(n, NBLK - 1)], F(0))
                d = 1
                while d < WARP:
                    t = s.copy()
                    s[d:] = s[d:] + mpow[d] * t[:-d]
                    d *= 2
                e = s + mpow[1: WARP + 1] * em
                em_in = np.concatenate([[em], e[:-1]]).astype(F)
                live = n < NBLK
                for k in range(BLK):
                    acc = np.zeros(int(live.sum()), F)
                    for i in range(k + 1):
                        acc = acc + y[n[live], i] * cpow[k - i]
                    out[n[live], k] = (acc + em_in[live] * cpow[k + 1]) * F(1.0 / 32768.0)
                em = e[min(WARP, NBLK - WARP * r) - 1]
            pcm[b, c] = out.reshape(N)
            new_hist[b, c] = x[-HIST:]
            new_ola[b, c] = full[b, c, N:]
            new_emph[b, c] = em
    return tuple(torch.from_numpy(a) for a in (pcm, new_ola, new_hist, new_emph))


def _check(inputs) -> None:
    got = k11_schedule(*inputs)
    want = cp.celt_postfilter_plain(*inputs)
    bound = kc.REL_BOUND["celt_postfilter"]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.isfinite(g).all()
        rel = (g.double() - w.double()).abs().max() / max(w.double().abs().max(), 1e-30)
        assert rel <= bound
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])  # +0 == -0
    kc.celt_invalid_passthrough(got, inputs)


@pytest.mark.parametrize("channels", [2, 1])
def test_schedule_on_the_schedule_draws(channels):
    """Postfilter off, turning on (zero sets at period 15 beside a long
    active one), turning off, every set active, periods 15 and 1024 active
    side by side, zero gains at random; invalid streams."""
    inputs = kc.celt_postfilter_schedule_inputs(90 + channels, streams=24, channels=channels)
    _check(inputs)


@pytest.mark.parametrize("channels", [2, 1])
def test_schedule_on_the_random_draws(channels):
    """``chip_smoke.py``'s random frames at a small size."""
    _check(kc.celt_postfilter_random_inputs(95 + channels, streams=19, channels=channels))


def test_zero_sets_do_not_bound_the_step():
    """A frame turning the postfilter on (stage A and stage B's first set
    zero at period 15, the new period long) steps 128 samples wide after
    sample 120 and runs no comb before; the first design stepped 13 (its
    width the smallest of all four periods, minus 2). A frame with every
    gain zero runs no comb at all."""
    comb = kc.celt_postfilter_schedule_inputs(1, streams=6)[1].numpy()
    on, off = k11_plan(comb[1]), k11_plan(comb[0])
    assert comb[1, 9] >= 200 and comb[1, [0, 1, 8]].tolist() == [15, 15, 15]
    assert on["a"][2] == 0 and on["b"][2] == 128 and on["b2"][2] == 128
    assert off["a"][2] == off["b"][2] == off["b2"][2] == 0


def test_a_skipped_read_that_is_not_finite():
    """Where a zero tap's own period reaches history that is not finite,
    the plain version's 0 x inf gives NaN and the schedule, which reads at
    the region's other period, does not: the one way besides the sign of a
    zero in which the two may differ."""
    full, comb, valid, ola, hist, emph = (t.clone() for t in
                                          kc.celt_postfilter_schedule_inputs(1, streams=6))
    valid[:] = True
    b = 1  # turning on: set a zero at period 15, set b's second at period 1000
    comb[b, 9] = 1000.0  # its reads end at HIST - 38
    hist[b, :, HIST - 17] = float("inf")  # the period-15 taps' first read
    got = k11_schedule(full, comb, valid, ola, hist, emph)
    want = cp.celt_postfilter_plain(full, comb, valid, ola, hist, emph)
    assert torch.isnan(want[0][b]).any() and torch.isfinite(got[0][b]).all()
    others = [i for i in range(6) if i != b]
    for g, w in zip(got, want):
        rel = (g[others].double() - w[others].double()).abs().max() / w[others].abs().max()
        assert rel <= kc.REL_BOUND["celt_postfilter"]
