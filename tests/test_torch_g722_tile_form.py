"""What the redesigned telephony kernels lean on, on the CPU.

K7 (``csrc/g722.cu``) does not walk the reference's steps one by one: it
stages a tile of steps, compacts each lane's valid steps, runs the two
bands' ADPCM apart over the compacted steps, and computes the QMF as a
FIR over the tile's delay line (before the scan on encode, after it on
decode). :func:`tile_decode` and :func:`tile_encode` are that order of
work in plain torch; they must equal the step-by-step plain scans bit
for bit, masks with holes and partial last tiles included
(``tests/test_torch_telephony_ops.py::test_g722_scan_matches_jax`` ties
the plain scans to the JAX package's).

K3 (``csrc/g711.cu``) reads its codes in place and splits a row into a
head up to a 16-byte boundary, 16-byte chunks and a tail: the plain
version on views at odd offsets and ragged row lengths equals the
contiguous result.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from soundkit_tpu_torch.ops import companding, g722
from soundkit_tpu_torch.tools import kernel_check as kc

I32 = torch.int32
BAND_FIELDS = ("s", "sp", "sz", "r", "p", "a", "b", "d", "nb", "det")


def split_bands(state):
    """The line x [B, 24] and each band's fields, band dim kept at size 1."""
    st = g722.G722_LAYOUT.views(state)
    bands = [{f: getattr(st, f)[:, k:k + 1].clone() for f in BAND_FIELDS} for k in (0, 1)]
    return st.x.clone(), bands


def join_bands(x, bands):
    fields = {f: torch.cat([bands[0][f], bands[1][f]], dim=1) for f in BAND_FIELDS}
    return g722.G722_LAYOUT.pack(x.shape[0], x=x, **fields)


def band_step(t, q, high, x, encode):
    """One step of one band alone. Decode: ``x`` is the band's code bits,
    returns (new fields, rlow or rhigh). Encode: ``x`` is xlow or xhigh,
    returns (new fields, the band's code bits)."""
    s, det = q["s"][:, 0], q["det"][:, 0]
    if encode:
        e = g722._sat(x - s)
        wd = torch.where(e >= 0, e, -(e + 1))
        if high:
            level = torch.where(wd >= ((564 * det) >> 12), 2, 1).long()
            code = torch.where(e < 0, t["IHN"][level], t["IHP"][level])
        else:
            thr = (t["Q6"][None, 1:30] * det[:, None]) >> 12
            level = (1 + (wd[:, None] >= thr).sum(-1, dtype=I32)).long()
            code = torch.where(e < 0, t["ILN"][level], t["ILP"][level])
    else:
        code = x.to(I32)
    if high:
        j = code.long()
        d = (det * t["QM2"][j]) >> 15
        out = (d + s).clamp(-16384, 16383)
        step, top = t["WH"][t["RH2"][j].long()], 22528
    else:
        j = (code >> 2).long()
        d = (det * t["QM4"][j]) >> 15
        out = (s + ((det * t["QM6"][code.long()]) >> 15)).clamp(-16384, 16383)
        step, top = t["WL"][t["RL42"][j].long()], 18432
    nb = (((q["nb"][:, 0] * 127) >> 7) + step).clamp(0, top)
    new = g722._block4(SimpleNamespace(**q), d[:, None])
    new["nb"] = nb[:, None]
    new["det"] = g722._scale(nb, high)[:, None]
    return new, (code if encode else out)


def band_scan(t, q, high, xs, m, encode):
    """A band over the compacted steps ``xs [B, M]``; lane b takes its
    first ``m[b]`` steps, the rest are dropped."""
    ys = torch.zeros(xs.shape, dtype=I32)
    for j in range(int(m.max())):
        new, y = band_step(t, q, high, xs[:, j], encode)
        on = j < m
        q = {f: torch.where(on.reshape(-1, *[1] * (q[f].dim() - 1)), new[f], q[f]) for f in q}
        ys[:, j] = torch.where(on, y, 0)
    return q, ys


def compact(valid):
    """Each step's position among its lane's valid steps, and the count."""
    v = valid.to(I32)
    return (torch.cumsum(v, 1) - v).long(), v.sum(1)


def fir(t, line, pos):
    """The two 12-tap sums of the QMF for the steps at line positions
    ``pos [B, n]``: a step's 24 entries end with its own pair."""
    idx = 2 * (pos[:, :, None] + 1) + torch.arange(24)
    win = torch.gather(line[:, None, :].expand(-1, pos.shape[1], -1), 2, idx)
    h = t["QMF_COEFFS"]
    return (win[:, :, 0::2] * h).sum(-1, dtype=I32), (win[:, :, 1::2] * h.flip(0)).sum(-1, dtype=I32)


def scatter_pairs(line, pos, valid, first, second):
    """Write each valid step's pair behind the 24 carried entries."""
    b, n = torch.nonzero(valid, as_tuple=True)
    line[b, 24 + 2 * pos[b, n]] = first[b, n]
    line[b, 25 + 2 * pos[b, n]] = second[b, n]


def tile_decode(codes, state, valid, tile):
    t = g722._t(codes.device)
    B, N = codes.shape
    x, bands = split_bands(state)
    pcm = torch.zeros((B, N, 2), dtype=torch.int16)
    for t0 in range(0, N, tile):
        v = valid[:, t0:t0 + tile]
        nt = v.shape[1]
        pos, m = compact(v)
        code = codes[:, t0:t0 + nt].to(I32)
        comp = torch.zeros((B, nt), dtype=I32)
        b, n = torch.nonzero(v, as_tuple=True)
        comp[b, pos[b, n]] = code[b, n]
        bands[0], rlow = band_scan(t, bands[0], False, comp & 63, m, False)
        bands[1], rhigh = band_scan(t, bands[1], True, comp >> 6, m, False)
        # the scan left one pair per compacted step; the FIR runs after it
        line = torch.cat([x, torch.zeros((B, 2 * nt), dtype=I32)], dim=1)
        at = torch.arange(nt)[None].expand(B, -1)
        scatter_pairs(line, at, at < m[:, None], rlow + rhigh, rlow - rhigh)
        even, odd = fir(t, line, pos)
        out = torch.stack([g722._sat(odd >> 11), g722._sat(even >> 11)], dim=-1)
        pcm[:, t0:t0 + nt] = torch.where(v[:, :, None], out, 0).to(torch.int16)
        x = torch.gather(line, 1, 2 * m[:, None] + torch.arange(24))
    return pcm.reshape(B, 2 * N), join_bands(x, bands)


def tile_encode(samples, state, valid, tile):
    t = g722._t(samples.device)
    B, N = samples.shape[0], samples.shape[1] // 2
    pairs = samples.reshape(B, N, 2).to(I32)
    x, bands = split_bands(state)
    codes = torch.zeros((B, N), dtype=torch.uint8)
    for t0 in range(0, N, tile):
        v = valid[:, t0:t0 + tile]
        nt = v.shape[1]
        pos, m = compact(v)
        # gather the valid sample pairs, then the FIR, then the scan
        line = torch.cat([x, torch.zeros((B, 2 * nt), dtype=I32)], dim=1)
        scatter_pairs(line, pos, v, pairs[:, t0:t0 + nt, 0], pairs[:, t0:t0 + nt, 1])
        even, odd = fir(t, line, torch.arange(nt)[None].expand(B, -1))
        bands[0], ilow = band_scan(t, bands[0], False, (even + odd) >> 14, m, True)
        bands[1], ihigh = band_scan(t, bands[1], True, (even - odd) >> 14, m, True)
        comp = (ihigh << 6) | ilow
        codes[:, t0:t0 + nt] = torch.where(v, torch.gather(comp, 1, pos), 0).to(torch.uint8)
        x = torch.gather(line, 1, 2 * m[:, None] + torch.arange(24))
    return codes, join_bands(x, bands)


def _closure(fn):
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("tile", [16, 37])
@pytest.mark.parametrize("encode", [False, True])
def test_g722_tile_form_equals_the_plain_scan(encode, tile, carried):
    """N = 50 leaves a partial last tile; lanes 3 and 6 of the case's
    mask stop early and have holes, lane 1 is empty."""
    _, plain = kc.g722_case(8, 50, encode, torch.device("cpu"), seed=3 + tile, carried=carried)
    c = _closure(plain)
    want = plain()
    got = (tile_encode if encode else tile_decode)(c["xs"], c["state"], c["valid"], tile)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert torch.count_nonzero(want[0]) > 0


@pytest.mark.parametrize("encode", [False, True])
def test_g722_tile_form_from_any_state(encode):
    """The state is the caller's: random rows, some over the whole int32
    range (a negative step size among them), give the same bits."""
    rng = np.random.default_rng(5)
    _, plain = kc.g722_case(8, 24, encode, torch.device("cpu"), seed=2)
    c = _closure(plain)
    state = rng.integers(-70000, 70000, (8, 70))
    state[:3] = rng.integers(-2**31, 2**31, (3, 70))
    state = torch.from_numpy(state.astype(np.int32))
    scan = g722.g722_encode_scan_plain if encode else g722.g722_decode_scan_plain
    want = scan(c["xs"], state, c["valid"])
    got = (tile_encode if encode else tile_decode)(c["xs"], state, c["valid"], 16)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def test_g722_bands_are_independent():
    """Given the codes, the low band's state does not depend on the high
    band's code bits, nor the high band's on the low band's."""
    rng = np.random.default_rng(9)
    codes = torch.from_numpy(rng.integers(0, 256, (4, 40)).astype(np.uint8))
    other = torch.from_numpy(rng.integers(0, 256, (4, 40)).astype(np.uint8))
    state = g722.g722_init_state(4, "cpu")
    base = g722.G722_LAYOUT.views(g722.g722_decode_scan_plain(codes, state)[1])
    low_kept = g722.G722_LAYOUT.views(
        g722.g722_decode_scan_plain((codes & 63) | (other & 192), state)[1])
    high_kept = g722.G722_LAYOUT.views(
        g722.g722_decode_scan_plain((codes & 192) | (other & 63), state)[1])
    for f in BAND_FIELDS:
        assert torch.equal(getattr(base, f)[:, 0], getattr(low_kept, f)[:, 0]), f
        assert torch.equal(getattr(base, f)[:, 1], getattr(high_kept, f)[:, 1]), f


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("N", [1, 15, 16, 17, 257])
@pytest.mark.parametrize("offset", [0, 1, 4, 16])
def test_g711_plain_on_a_view_equals_the_contiguous_result(offset, N, ragged):
    """The case's codes are a view into a larger buffer; a fresh
    contiguous copy of them gives the same samples, and zeros from each
    lane's count on."""
    kernel, plain = kc.g711_case(5, N, torch.device("cpu"), seed=N, offset=offset, ragged=ragged)
    c = _closure(plain)
    codes = c["codes"]
    assert codes.storage_offset() == offset and codes.is_contiguous()
    want = companding.g711_decode_plain(codes.clone(), c["law"], c["counts"])
    assert torch.equal(plain(), want) and torch.equal(kernel(), want)
    if ragged:
        past = torch.arange(N)[None] >= c["counts"][:, None]
        assert not want[past].any()


def test_g711_case_without_an_offset_is_unchanged():
    """``offset=0`` draws the same codes, laws and counts as a case built
    from a ``[B, N]`` draw."""
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 256, (9, 64)).astype(np.uint8)
    c = _closure(kc.g711_case(9, 64, torch.device("cpu"), seed=4)[1])
    assert np.array_equal(c["codes"].numpy(), codes)
    assert c["counts"][0] == 64 and c["counts"][1] == 0
