"""K16's work split (``csrc/stretch_ola.cu``) on the CPU, where the kernel
cannot run: the outputs a thread the wrapper passes it
(``ops.stretch_ola.k16_vector``: V), the cover a vector of V samples
shares, and a numpy mirror of the kernel in its own grid, thread and loop
order (THREADS, ROWS and CHUNK read from the source): each thread's
vector of ROWS lanes, its covering frames in load groups of CHUNK in
ascending t, the divisor from the same window values, the IEEE
divide, the warp's pass through shared memory and its stores. The mirror
rounds each product and sum alone in float32, as the kernel's
``__fmul_rn`` / ``__fadd_rn``, and is held bit for bit to
``overlap_add_plain`` on the pitch shift's shape and on odd ones."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from soundkit_tpu_torch.ops import stretch as st
from soundkit_tpu_torch.ops import stretch_ola as so
from soundkit_tpu_torch.tools import kernel_check as kc

SRC = Path(so.__file__).resolve().parent.parent / "csrc" / "stretch_ola.cu"
CONST = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", SRC.read_text())}
THREADS, ROWS, CHUNK = CONST["THREADS"], CONST["ROWS"], CONST["CHUNK"]
F32 = np.float32
EPS = F32(1e-8)

#: (B, T, hop, target, F): the pitch shift's shape at two lanes, then the
#: card tests' odd ones
CASES = [
    (2, 348, 960, 165375, 2048),
    (5, 9, 960, 3000, 2048), (2, 7, 333, 1500, 2048), (4, 4, 2048, 9000, 2048),
    (2, 9, 962, 3001, 2048), (3, 5, 2500, 9000, 2048), (2, 9, 960, 4000, 512),
    (1, 9, 960, 5001, 2048), (3, 6, 960, 7777, 2048), (2, 12, 256, 2999, 2048),
]


def cover(J, T: int, F: int, hop: int):
    """(t_lo, t_hi) of the frames that cover line samples ``J``, as the
    kernel forms them (empty where t_lo > t_hi)."""
    J = np.asarray(J, dtype=np.int64)
    t_hi = np.minimum(J // hop, T - 1)
    t_lo = np.where(J >= F, (J - F) // hop + 1, 0)
    return t_lo, t_hi


def k16_mirror(frames: np.ndarray, win: np.ndarray, hop: int, target: int, V=None, C=CHUNK):
    """K16 as the kernel runs it, with ``V`` outputs a thread
    (``k16_vector``'s by default) and load groups of ``C`` frames -> (out
    f32 [B, target], writes [B, target], den f32 [target]: the divisor
    each output's vector formed)."""
    B, T, F = frames.shape
    start = F // 2
    V = V or so.k16_vector(F, hop, start)
    vectors = -(-target // V)
    gx, gy = -(-vectors // THREADS), -(-B // ROWS)
    out = np.full((B, target), np.nan, dtype=F32)
    writes = np.zeros((B, target), dtype=np.int64)
    den_seen = np.full(target, np.nan, dtype=F32)
    # every thread of a row of blocks at once: thread id u = bx THREADS + tid
    u = np.arange(gx * THREADS)
    j0 = u * V
    J0 = start + j0
    t_hi = np.where(j0 < target, np.minimum(J0 // hop, T - 1), -1)
    t_lo = np.where(J0 >= F, (J0 - F) // hop + 1, 0)
    e = np.arange(V)
    n_groups = int(max(0, (t_hi - t_lo + 1).max()) + C - 1) // C
    for by in range(gy):
        b0 = by * ROWS
        fr = frames[np.minimum(b0 + np.arange(ROWS), B - 1)]  # a lane past B reads B - 1 again
        acc = np.zeros((ROWS, u.size, V), dtype=F32)
        den = np.zeros((u.size, V), dtype=F32)
        for g in range(n_groups):
            t0 = t_lo + g * C
            # the group's loads, all before its first add
            loads = []
            for c in range(C):
                t = t0 + c
                live = t <= t_hi
                i = np.where(live, J0 - t * hop, 0)[:, None] + e
                tt = np.where(live, t, 0)
                w = win[i]
                f = fr[:, tt[:, None], i]  # [ROWS, threads, V]
                loads.append((live, w, f))
            for live, w, f in loads:
                den = np.where(live[:, None], den + w * w, den)
                acc = np.where(live[None, :, None], acc + w * f, acc)
        q = acc / np.fmax(den, EPS)  # [ROWS, threads, V]
        # the warp's shared stage: row r, lane l's V values at r 32 V + l V;
        # store k of the warp writes stage[r 32 V + k 32 + lane] at jw + k 32 + lane
        warps = u.size // 32
        stage = q.reshape(ROWS, warps, 32 * V)
        jw = j0.reshape(warps, 32)[:, 0]
        for r in range(ROWS):
            b = b0 + r
            if b >= B:
                break
            for k in range(V):
                s = k * 32 + np.arange(32)
                pos = jw[:, None] + s[None, :]
                ok = pos < target
                out[b, pos[ok]] = stage[r][:, s][ok]
                np.add.at(writes[b], pos[ok], 1)
    idx = j0[:, None] + e[None, :]
    den_seen[idx[idx < target]] = np.fmax(den, EPS)[idx < target]
    return out, writes, den_seen


def _inputs(B, T, F, seed):
    frames, win = kc.stretch_ola_inputs(seed, B, T, torch.device("cpu"), F=F)
    return frames, win


def test_the_sources_constants():
    """A load group holds every frame that covers a sample at the pitch
    shift's hop of 960 (ceil(2048 / 960) = 3)."""
    assert CHUNK == -(-2048 // 960)
    assert THREADS % 32 == 0 and ROWS >= 1


@pytest.mark.parametrize("F,hop,addresses,V", [
    (2048, 960, (), 4),           # the pitch shift: time 1.25 x pitch 1.5
    (2048, 962, (), 2),           # hop 962 is even, not a multiple of 4
    (2048, 333, (), 1),           # odd hop, seven covering frames
    (2048, 2500, (), 4),          # hop > F: one frame at most
    (512, 960, (), 4),
    (2048, 256, (), 4),           # eight covering frames
    (2048, 1024, (), 4),
    (2047, 960, (), 1),           # odd F: start 1023
    (2048, 960, (4096, 4100), 1),  # an input 4 bytes past 16
    (2048, 960, (4104, 8192), 2),  # 8 bytes past 16
])
def test_k16_vector(F, hop, addresses, V):
    assert so.k16_vector(F, hop, F // 2, *addresses) == V


@pytest.mark.parametrize("time_ratio,V", [(1.875, 4), (1.25, 4), (1.0, 4), (0.75, 4),
                                          (1.8789, 2), (1.877, 1), (0.6504, 1)])
def test_the_vocoders_hop_sets_v(time_ratio, V):
    """The hop the vocoder passes K16 (``round(HOP_A ratio)``): V = 4 at
    the pitch shift's 1.875 and at hops that are multiples of 4, 2 or 1
    at the others (an odd hop: V = 1)."""
    hop = max(1, int(round(st.HOP_A * time_ratio)))
    assert so.k16_vector(st.FRAME, hop, st.FRAME // 2) == V


@pytest.mark.parametrize("T,F,hop", [(348, 2048, 960), (9, 2048, 962), (7, 2048, 333),
                                     (5, 2048, 2500), (9, 512, 960), (12, 2048, 256)])
def test_a_vectors_cover_is_each_of_its_samples(T, F, hop):
    """Each vector's cover, from its first sample, equals the cover of each
    of its V samples, over the whole line and past it; hop > F leaves gap
    samples no frame covers, and past the line the cover is empty."""
    V = so.k16_vector(F, hop, F // 2)
    line = hop * (T - 1) + F
    J0 = F // 2 + V * np.arange(-(-(line + 64) // V))
    lo0, hi0 = cover(J0, T, F, hop)
    for e in range(V):
        lo, hi = cover(J0 + e, T, F, hop)
        assert np.array_equal(np.maximum(hi - lo + 1, 0), np.maximum(hi0 - lo0 + 1, 0))
        live = lo <= hi
        assert np.array_equal(lo[live], lo0[live]) and np.array_equal(hi[live], hi0[live])
    n = np.maximum(hi0 - lo0 + 1, 0)
    assert n.max() <= -(-F // hop)
    assert (n[J0 >= line] == 0).all()
    assert ((n == 0) & (J0 < line)).any() == (hop > F)


@pytest.mark.parametrize("B,T,hop,target,F", CASES)
def test_mirror_equals_the_plain_version_bit_for_bit(B, T, hop, target, F):
    frames, win = _inputs(B, T, F, B + T + hop)
    ref = so.overlap_add_plain(frames, win, hop, target).numpy()
    got, writes, _ = k16_mirror(frames.numpy(), win.numpy(), hop, target)
    assert (writes == 1).all()
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("V,C", [(2, CHUNK), (1, CHUNK), (4, 1), (4, 2), (4, 4), (1, 1)])
def test_every_plan_keeps_the_bits(V, C):
    """The vector width and the load group change the work split, not the
    sums: each width the kernel takes, and other group sizes, equal the
    plain version on the pitch shift's hop."""
    frames, win = _inputs(3, 9, 2048, 21)
    ref = so.overlap_add_plain(frames, win, 960, 5001).numpy()
    got, writes, _ = k16_mirror(frames.numpy(), win.numpy(), 960, 5001, V, C)
    assert (writes == 1).all()
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("B,T,hop,target,F", [(3, 5, 2500, 9000, 2048), (2, 9, 960, 4000, 512),
                                              (4, 4, 2048, 9000, 2048),
                                              (3, 6, 960, 7777, 2048)])
def test_gaps_and_the_lines_end_give_positive_zero(B, T, hop, target, F):
    """Samples in a gap (hop > F) and past the line's end inside the crop:
    no covering frame, so 0 / max(0, 1e-8) = +0, the plain version's bits."""
    frames, win = _inputs(B, T, F, 3)
    got, _, _ = k16_mirror(frames.numpy(), win.numpy(), hop, target)
    J = F // 2 + np.arange(target)
    lo, hi = cover(J, T, F, hop)
    empty = lo > hi
    assert empty.any()
    assert (got[:, empty].view(np.uint32) == 0).all()
    ref = so.overlap_add_plain(frames, win, hop, target).numpy()
    assert (ref[:, empty].view(np.uint32) == 0).all()


@pytest.mark.parametrize("T,hop,target,F", [(348, 960, 165375, 2048), (5, 2500, 9000, 2048),
                                            (6, 960, 7777, 2048), (9, 962, 3001, 2048),
                                            (7, 333, 1500, 2048)])
def test_the_inline_divisor_is_the_norm_kernels_rule(T, hop, target, F):
    """The divisor each vector forms from its window loads equals, bit for
    bit, the first design's norm kernel: fmaxf of the squares summed from
    0 in ascending t inside the line. Past the line the norm kernel wrote
    1 and the output 0; the inline divisor is 1e-8 there, its output +0."""
    frames, win = _inputs(1, T, F, 5)
    _, _, den = k16_mirror(frames.numpy(), win.numpy(), hop, target)
    w = win.numpy()
    line = hop * (T - 1) + F
    J = F // 2 + np.arange(target)
    lo, hi = cover(J, T, F, hop)
    rule = np.ones(target, dtype=F32)
    acc = np.zeros(target, dtype=F32)
    for t in range(T):
        use = (lo <= t) & (t <= hi)
        i = np.where(use, J - t * hop, 0)
        acc = np.where(use, acc + w[i] * w[i], acc)
    inside = J < line
    rule[inside] = np.fmax(acc[inside], EPS)
    assert np.array_equal(den[inside].view(np.uint32), rule[inside].view(np.uint32))
    assert (den[~inside] == EPS).all()
