"""What the redesigned FLAC kernels lean on, on the CPU.

K9 (``csrc/flac_lpc.cu``) does not sum all 32 taps of a 64-bit history
as the reference does: it keeps an int32 ring as deep as the bucket of
taps (4, 8 or 16; the kernel takes its warp's, the form each row's),
sums the taps with the one of s[n-1] last, as int32 x int32 products
while the row's history fits int32, and goes on in 64-bit products from
the sample after the first one that leaves int32 (inside a row the
kernel redoes that sample's group of R in 64 bits, which gives the same
bits); rows of more than 16 taps take 64-bit products from the start.
The wasted-bit shift and the decorrelation come at the write-back.
:func:`lpc_form` is that order of work in plain torch.

K8 (``csrc/flac_rice.cu``) reads a segment's bits through a 64-bit
window refilled one word at a time, decodes up to ``CHUNK`` values and
writes them as one run, dropping targets outside the plane, then goes on
with the next chunk. :func:`rice_form` is that reader and writer in
plain Python.

Both must equal the plain versions bit for bit
(``tests/test_torch_flac_ops.py`` ties the plain versions to the JAX
package's), on the fixture wire, on random and ``wild`` inputs, on rows
that leave int32 in mid-block and on segments longer than a chunk.
"""
import functools
import re

import pytest
import torch

from soundkit_tpu_torch import _build
from soundkit_tpu_torch.ops import flac_lpc, flac_rice
from soundkit_tpu_torch.tools import kernel_check as kc

M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1


def cu_constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", (_build.CSRC_DIR / source).read_text())
    assert m, f"csrc/{source} defines no {name}"
    return int(m.group(1))


CHUNK = cu_constant("flac_rice.cu", "CHUNK")


@functools.lru_cache(maxsize=1)
def fixture_wire():
    return kc.flac_fixture_wire(9, 2, "cpu")


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------

def to_i32(x):
    return ((x + (1 << 31)) & M32) - (1 << 31)


def lpc_form(resw, coef, order, shift, wasted, chan_assign, block_size, lane_valid):
    """K9's order of work -> (samples [L, 2, T] int32, the sample each
    row went on in 64 bits from, -1 for none)."""
    L, C, T = resw.shape
    rows = L * C
    r = resw.reshape(rows, T).to(torch.int64)
    cf = coef.reshape(rows, 32).to(torch.int64)
    ord_ = order.reshape(rows).to(torch.int64)
    sh = shift.reshape(rows).to(torch.int64)
    sh = torch.where((sh >= 0) & (sh < 64), sh, 63)  # unsigned min(shift, 63)
    live = torch.where(lane_valid, block_size.to(torch.int64).clamp(0, T), 0)
    live = live.repeat_interleave(2)
    idx = torch.arange(32)
    taps = torch.where(cf != 0, idx + 1, 0).amax(1)
    bucket = torch.full_like(taps, 32)  # past 16 taps: 64-bit products from the start
    for b in (16, 8, 4):
        bucket = torch.where(taps <= b, b, bucket)

    s_all = torch.zeros((rows, T), dtype=torch.int64)
    wide_from = torch.full((rows,), -1, dtype=torch.int64)
    for R in (4, 8, 16, 32):
        sel = (bucket == R).nonzero().flatten()
        if not len(sel):
            continue
        ring = torch.zeros((len(sel), R), dtype=torch.int64)
        wide = torch.full((len(sel),), R > 16)
        wide_from[sel] = 0 if R > 16 else -1
        rr, cc, oo, ss, ll = r[sel], cf[sel], ord_[sel], sh[sel], live[sel]
        for n in range(T):
            acc = torch.zeros(len(sel), dtype=torch.int64)
            for k in range(R - 1, -1, -1):  # s[n-1] enters last
                hv = ring[:, (n - 1 - k) % R]
                acc = acc + cc[:, k] * torch.where(wide, hv, to_i32(hv))
            s = torch.where(n < oo, rr[:, n], rr[:, n] + (acc >> ss))
            on = n < ll
            ring[:, n % R] = torch.where(on, s, ring[:, n % R])
            s_all[sel, n] = torch.where(on, s, 0)
            leaves = on & ~wide & (s != to_i32(s))
            wide_from[sel] = torch.where(leaves, n + 1, wide_from[sel])
            wide = wide | leaves

    # the write-back: wasted bits and decorrelation in 64 bits, cut to int32
    s = s_all.reshape(L, 2, T)
    ws = wasted.to(torch.int64)[..., None]
    c = torch.where((ws >= 0) & (ws < 64), s << ws.clamp(0, 63), 0)
    c0, c1 = c[:, 0], c[:, 1]
    a = chan_assign.to(torch.int64)[:, None]
    mid = (c0 << 1) | (c1 & 1)
    v0 = torch.where(a == 10, (mid + c1) >> 1, torch.where(a == 9, c1 + c0, c0))
    v1 = torch.where(a == 10, (mid - c1) >> 1, torch.where(a == 8, c0 - c1, c1))
    n_idx = torch.arange(T)
    out = torch.stack([v0, v1], 1)
    out = torch.where(n_idx < live.reshape(L, 2)[..., None], out, 0)
    return to_i32(out).to(torch.int32), wide_from


def check_lpc(args):
    got, wide_from = lpc_form(*args)
    assert torch.equal(got, flac_lpc.flac_frame_plain(*args))
    return got, wide_from


def test_lpc_form_on_the_fixture_wire():
    wire = fixture_wire()
    plane = flac_rice.flac_rice_plane_plain(*wire[:9], 4608)
    got, wide_from = check_lpc((plane, *wire[9:]))
    assert (wide_from < 0).all(), "16- and 24-bit streams stay on the int32 path"
    assert got.any()


@pytest.mark.parametrize("wild", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_lpc_form_on_random_inputs(seed, wild):
    args = kc.flac_lpc_random_inputs(seed, lanes=24, T=70, wild=wild)
    _, wide_from = check_lpc(args)
    assert (wide_from > 0).any() and (wide_from < 0).any()


@pytest.mark.parametrize("lanes,T", [(40, 96), (3, 33)])
def test_lpc_form_switches_to_64_bits_in_mid_block(lanes, T):
    args = kc.flac_lpc_switch_inputs(lanes, T)
    _, wide_from = check_lpc(args)
    assert (wide_from > 0).all(), "every row leaves int32"
    assert int(wide_from.min()) <= 4, "on its first samples"
    assert len(set(wide_from.tolist())) >= min(T, 2 * lanes) // 3, "at many sample positions"
    assert T < 96 or int(wide_from.max()) > 64, "past the first tile"


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------

class Reader:
    """K8's bit reader: a 64-bit window holding ``nbits`` >= 32 bits
    from ``bitpos`` on, the next word loaded one refill ahead."""

    def __init__(self, flat, lane, W):
        self.flat, self.base, self.W = flat, lane * W, W

    def word(self, i):
        f = self.base + min(i, self.W - 1)
        n = len(self.flat)
        if 0 <= f < n:
            return self.flat[f]
        return self.flat[f + n] if -n <= f < 0 else M32

    def seek(self, pos):
        self.bitpos = pos
        wi, sh = pos >> 5, pos & 31
        self.win = (((self.word(wi) << 32) | self.word(wi + 1)) << sh) & M64
        self.nbits, self.nw = 64 - sh, wi + 2
        self.next = self.word(self.nw)

    def top(self):
        return self.win >> 32

    def skip(self, c):
        assert 0 <= c <= 32 and self.nbits >= 32
        self.win = (self.win << c) & M64
        self.nbits -= c
        self.bitpos += c
        if self.nbits < 32:
            self.win |= self.next << (32 - self.nbits)
            self.nbits += 32
            self.nw += 1
            self.next = self.word(self.nw)

    def advance(self, c):
        self.skip(c) if c <= 32 else self.seek(self.bitpos + c)


def clz32(x):
    return 32 - x.bit_length()


def decode_one(rd, sk, W):
    """One code, or None for a quotient that never ends."""
    if sk < 0:
        width = -sk - 1
        v = 0
        if 1 <= width <= 32:
            t = rd.top()
            v = (t - ((t >> 31) << 32)) >> (32 - width)
        rd.advance(width)
        return v
    q, lead = 0, clz32(rd.top())
    while lead >= 24:
        if rd.top() == 0 and (rd.bitpos >> 5) >= W - 1:
            return None
        q += 24
        rd.skip(24)
        lead = clz32(rd.top())
    q = (q + lead) & M32
    rd.skip(lead + 1)
    rwin = rd.top()
    rem = 0 if sk == 0 else rwin >> (32 - sk) if sk <= 32 else 0
    zz = (0 if sk >= 32 else (q << sk) & M32) | rem
    v = (zz >> 1) ^ -(zz & 1)
    rd.advance(sk)
    return v


def rice_form(words, seg_lane, seg_bitoff, seg_k, seg_n, seg_dest, warm, const_flag, const_val,
              stride):
    """K8's order of work -> (plane [NL, 2, stride] int32, the number of
    chunks a segment took at most)."""
    NL, W = words.shape
    plane = torch.where((const_flag == 1)[..., None], const_val[..., None],
                        torch.nn.functional.pad(warm, (0, stride - 32)))
    flat = plane.reshape(-1).clone()
    total = flat.numel()
    words_u = (words.reshape(-1).to(torch.int64) & M32).tolist()
    most = 0
    for lane, off, sk, n, dest in zip(*(t.tolist() for t in (seg_lane, seg_bitoff, seg_k,
                                                              seg_n, seg_dest))):
        if n <= 0:
            continue
        rd = Reader(words_u, lane, W)
        rd.seek(off)
        done, chunks = 0, 0
        while done < n:
            vals = []
            while done < n and len(vals) < CHUNK:
                v = decode_one(rd, sk, W)
                if v is None:
                    n = done
                    break
                vals.append(v)
                done += 1
            chunks += 1
            for i, v in enumerate(vals):  # the warp's run: drop targets outside the plane
                t = dest + done - len(vals) + i
                if 0 <= t < total:
                    flat[t] = v
        most = max(most, chunks)
    return flat.reshape(NL, 2, stride), most


def check_rice(args, stride):
    got, most = rice_form(*args, stride)
    assert torch.equal(got, flac_rice.flac_rice_plane_plain(*args, stride))
    return most


def test_rice_form_on_the_fixture_wire():
    wire = fixture_wire()
    assert check_rice(wire[:9], 4608) == -(-144 // CHUNK), "a walk's longest segment: 144 codes"


@pytest.mark.parametrize("wild", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_rice_form_on_random_inputs(seed, wild):
    args = kc.flac_rice_random_inputs(seed, stride=321, wild=wild)
    check_rice(args, 321)


@pytest.mark.parametrize("seed", range(2))
def test_rice_form_segments_longer_than_a_chunk_and_past_the_plane(seed):
    args = kc.flac_rice_long_inputs(seed)
    assert int((args[5] + args[4]).max()) > 8 * 2 * 1280, "targets past the plane"
    assert check_rice(args, 1280) >= 600 // CHUNK
