"""K12's schedule (``csrc/silk_synth.cu``) on the CPU, where the kernel
cannot run: a numpy mirror of its order of work, held bit for bit to
``silk_synth_plain``.

The mirror takes the kernel's rows eight to an LPC warp. Its stage warps
run the re-whitening FIR once over each voiced row's span of the
subframes that read only the history (all four, or 0-1 on a lead-in row),
then, a subframe at a time, each voiced row's rescaled span, its gain-ratio
range from the lowest position a later subframe still reads, and the LTP in steps of ``min(32, lag - 2)`` samples, keeping
``r_j g_i`` in the frame's part of the output line before the next
subframe's rescale; the LPC warp runs each subframe as its ``r_j g_i`` is
ready. Subframe 2 of a voiced lead-in row waits for the LPC to finish
subframe 1: its FIR over the span of subframes 2-3 reads that output. Each
value's products and sums are those of the plain version, rounded one by
one in float32."""
import numpy as np
import pytest
import torch

from soundkit_tpu_torch.ops import silk_synth as ss
from soundkit_tpu_torch.tools import kernel_check as kc

F = np.float32
R = 8  # rows a pair of warps (csrc/silk_synth.cu)


def _clamp_lag(lag) -> int:
    return min(max(int(lag), ss.LAG_MIN), ss.LAG_MAX)


def _group(lead: bool, i: int) -> int:
    """1 for a lead-in row's subframes 2-3 (their FIR reads the frame's
    output), else 0 (it reads only the history)."""
    return 1 if lead and i >= 2 else 0


def k12_schedule(bw: int, inputs, late_rg: bool = False):
    """(dst, new tail) of :func:`ss.silk_synth` in the kernel's order; with
    ``late_rg`` (rows without lead-in only) the stage runs all four
    subframes first and the LPC reads r_j g_i formed from the residual as
    the later subframes' rescales left it (the mistake the kernel's order
    avoids)."""
    exc, gains, coef, hl, vo, lags, ltp, lsc, hist, tail = (t.numpy() for t in inputs)
    sfl, order = ss.SFL[bw], ss.ORDER[bw]
    flen, H, M = 4 * sfl, ss.HIST, ss.MAXLAG
    rows = exc.shape[0] * 2
    exc, gains, coef, hl, vo = (a.reshape(rows, *a.shape[2:]) for a in (exc, gains, coef, hl, vo))
    lags, ltp, lsc = (a.reshape(rows, *a.shape[2:]) for a in (lags, ltp, lsc))
    dst = np.zeros((rows, H + flen), F)
    dst[:, :H] = hist.reshape(rows, H)
    res = np.zeros((rows, M + flen), F)
    res[:, M:] = exc[:, :flen]
    tail = tail.reshape(rows, ss.TAIL).copy()
    sub = np.arange(flen) // sfl
    for r in range(rows):  # an unvoiced row's r_j g_i, up front
        if not vo[r]:
            dst[r, H:] = res[r, M:] * gains[r, sub]
    span = {(r, i): i * sfl - _clamp_lag(lags[r, i]) - ss.LTP_ORDER // 2
            for r in range(rows) for i in range(4)}
    v, lo = {}, {}

    def fir(r: int, gr: int) -> None:
        """The FIR once over the union of group gr's spans of row r."""
        hi = 2 * sfl if gr else 0
        lo[r] = min(span[r, i] for i in range(4) if _group(bool(hl[r]), i) == gr)
        c = coef[r, 0 if (gr == 0 and hl[r]) else 1]
        p = np.arange(lo[r], hi)
        acc = np.zeros(len(p), F)
        for k in range(order):
            acc = acc + dst[r, H + p - 1 - k] * c[k]
        v[r] = np.clip(dst[r, H + p] - acc, F(-1), F(1))

    def hi_of(r: int, i: int) -> int:
        return 2 * sfl if _group(bool(hl[r]), i) else 0

    def subframe(r: int, i: int) -> None:
        gr = _group(bool(hl[r]), i)
        hi = hi_of(r, i)
        g = gains[r, i]
        s = (F(1) if gr else lsc[r]) / g
        q = gains[r, i - 1] / g if i else F(0)
        new = np.arange(min(span[r, i], hi), hi)
        res[r, M + new] = v[r][new - lo[r]] * s
        # the gain ratio from the lowest position a subframe i' >= i still
        # reads, max(lo_i', hi_i'): below it the residual is read no more
        reads = min(max(span[r, k], hi_of(r, k)) for k in range(i, 4))
        old = np.arange(max(hi, reads), i * sfl)
        res[r, M + old] = res[r, M + old] * q
        lag = _clamp_lag(lags[r, i])
        step = min(32, lag - 2)
        for j0 in range(0, sfl, step):
            pos = M + i * sfl + np.arange(j0, min(j0 + step, sfl))
            acc = np.zeros(len(pos), F)
            for k in range(ss.LTP_ORDER):
                acc = acc + ltp[r, i, k] * res[r, pos - lag + ss.LTP_ORDER // 2 - k]
            rj = res[r, pos] + acc
            res[r, pos] = rj
            dst[r, pos - M + H] = rj * g

    def lpc(rs, c, j0: int, j1: int) -> None:
        for j in range(j0, j1):
            older = ss._pairwise_sum([c[:, k] * tail[rs, k] for k in range(order - 1, 0, -1)])
            u = (dst[rs, H + j] + older) + c[:, 0] * tail[rs, 0]
            tail[rs, 1:] = tail[rs, :-1]
            tail[rs, 0] = u
            dst[rs, H + j] = np.clip(u, F(-1), F(1))

    for p0 in range(0, rows, R):
        rs = np.arange(p0, min(p0 + R, rows))
        voiced = [r for r in rs if vo[r]]
        for r in voiced:
            fir(r, 0)
        if late_rg:
            for r in voiced:
                for i in range(4):
                    subframe(r, i)
                dst[r, H:] = res[r, M:] * gains[r, sub]
            lpc(rs, coef[rs, 1, :order], 0, flen)
            continue
        for i in range(4):
            if i == 2:  # after the LPC of subframes 0-1
                for r in voiced:
                    if hl[r]:
                        fir(r, 1)
            for r in voiced:
                subframe(r, i)
            c = np.where((hl[rs, None] != 0) & (i < 2), coef[rs, 0], coef[rs, 1])[:, :order]
            lpc(rs, c, i * sfl, (i + 1) * sfl)
    B = exc.shape[0] // 2
    return (torch.from_numpy(dst.reshape(B, 2, H + flen)),
            torch.from_numpy(tail.reshape(B, 2, ss.TAIL)))


def _bit_equal(bw: int, inputs) -> None:
    got = k12_schedule(bw, inputs)
    want = ss.silk_synth_plain(bw, *inputs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("bw", [0, 1, 2])
def test_schedule_bit_exact_on_the_schedule_draws(bw):
    """Warps of rows without lead-in, with it on every row, on every
    second row and at random; voiced and unvoiced rows; lags 3, 16 and 288
    beside drawn ones; gains drawn apart for every subframe."""
    inputs = kc.silk_synth_schedule_inputs(70 + bw, bw, streams=14)
    assert {int(x) for x in inputs[5].flatten()} >= {3, 16, 288}
    _bit_equal(bw, inputs)


@pytest.mark.parametrize("channels", [2, 1])
@pytest.mark.parametrize("bw", [0, 1, 2])
def test_schedule_bit_exact_on_the_random_draws(bw, channels):
    """``chip_smoke.py``'s random rounds at a small size: lags over the
    range and at both ends, invalid and all-zero lanes, mono side rows."""
    _bit_equal(bw, kc.silk_synth_random_inputs(80 + bw, bw, streams=11, channels=channels))


def test_schedule_keeps_r_g_before_the_next_rescale():
    """Voiced WB rows without lead-in whose gains differ in every subframe:
    the schedule has the plain version's bits, and taking r_j g_i from the
    residual after the later subframes rescaled it would not."""
    inputs = [t.clone() for t in kc.silk_synth_schedule_inputs(5, 2, streams=2)]
    inputs[3].zero_()
    inputs[4].fill_(1)
    inputs[5][:] = torch.tensor([40, 120, 200, 280], dtype=torch.int32)
    inputs[1][:] = torch.tensor([1.0, 8.0, 0.5, 30.0])
    _bit_equal(2, inputs)
    late = k12_schedule(2, inputs, late_rg=True)[0]
    assert not torch.equal(late, ss.silk_synth_plain(2, *inputs)[0])
