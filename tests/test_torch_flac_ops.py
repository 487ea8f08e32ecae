"""Port parity of the FLAC device ops on the CPU: the plain versions of
K8 (``ops.flac_rice.flac_rice_plane``) and K9 (``ops.flac_lpc.flac_frame``)
against the JAX package's ``flac_rice_plane_device`` and
``flac_frame_device_x64``, on the fixtures' wire, on seeded random
inputs and on crafted segments. Everything bit-exact."""
import functools

import jax
import numpy as np
import pytest
import torch

from soundkit_tpu.ops.flac_lpc import flac_frame_device_x64
from soundkit_tpu.ops.flac_rice import flac_rice_plane_device
from soundkit_tpu_torch.ops import flac_lpc, flac_rice
from soundkit_tpu_torch.tools import kernel_check as kc

STEPS = 400  # scan steps of the JAX Rice decoder: past every case's longest segment


@functools.lru_cache(maxsize=1)
def _jax_rice():
    return jax.jit(flac_rice_plane_device, static_argnums=(9, 10, 11))


def jax_rice_plane(args, stride, steps=STEPS):
    na = [a.numpy() for a in args]
    na[0] = na[0].view(np.uint32)
    return np.asarray(_jax_rice()(*na, steps, na[0].shape[0], stride))


def jax_lpc(args):
    return flac_frame_device_x64(*[a.numpy() for a in args])


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def fixture_wire():
    """Two rounds of nine ragged fixture lanes (every clip, several offsets)."""
    return kc.flac_fixture_wire(9, 2, "cpu")


def test_lpc_matches_jax_on_the_fixture_wire():
    wire = fixture_wire()
    plane = flac_rice.flac_rice_plane(*wire[:9], 4608)
    args = (plane, *wire[9:])
    got = flac_lpc.flac_frame(*args)
    assert got.dtype == torch.int32 and got.shape == plane.shape
    np.testing.assert_array_equal(got.numpy(), jax_lpc(args))
    assignments = set(wire[13].tolist())
    assert {0, 1, 10} <= assignments and int(wire[10].max()) >= 8, "mid/side and LPC orders"
    assert int(wire[12].max()) == 2, "a wasted-bits channel"
    assert np.count_nonzero(got.numpy()) > 100000


@pytest.mark.parametrize("wild", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_lpc_matches_jax_on_random_inputs(seed, wild):
    args = kc.flac_lpc_random_inputs(seed, wild=wild)
    got = flac_lpc.flac_frame(*args).numpy()
    np.testing.assert_array_equal(got, jax_lpc(args))
    assert np.count_nonzero(got) > 0


def _lpc_args(seed, lanes=6, T=48, **fixed):
    """Random K9 inputs with some fields pinned to one value."""
    names = ("resw", "coef", "order", "shift", "wasted", "assign", "bs", "valid")
    args = dict(zip(names, kc.flac_lpc_random_inputs(seed, lanes=lanes, T=T)))
    for name, value in fixed.items():
        args[name] = torch.full_like(args[name], value)
    return tuple(args.values())


@pytest.mark.parametrize("assign", [0, 1, 8, 9, 10])
def test_lpc_every_channel_assignment(assign):
    args = _lpc_args(20 + assign, assign=assign, valid=True, bs=48)
    got = flac_lpc.flac_frame(*args).numpy()
    np.testing.assert_array_equal(got, jax_lpc(args))
    plain = _lpc_args(20 + assign, assign=0, valid=True, bs=48)
    differs = not np.array_equal(got, flac_lpc.flac_frame(*plain).numpy())
    assert differs == (assign >= 8)


@pytest.mark.parametrize("order", [0, 1, 2, 4, 8, 12, 31, 32])
def test_lpc_orders(order):
    args = _lpc_args(40 + order, order=order, valid=True, bs=48, assign=1, wasted=0)
    got = flac_lpc.flac_frame(*args).numpy()
    np.testing.assert_array_equal(got, jax_lpc(args))
    # the first `order` samples are the warm-up, passed through
    np.testing.assert_array_equal(got[:, :, :order], args[0].numpy()[:, :, :order])


@pytest.mark.parametrize("shift,wasted", [(0, 0), (15, 3), (31, 8), (7, 31)])
def test_lpc_shifts_and_wasted_bits(shift, wasted):
    args = _lpc_args(60 + shift, shift=shift, wasted=wasted, valid=True)
    np.testing.assert_array_equal(flac_lpc.flac_frame(*args).numpy(), jax_lpc(args))


@pytest.mark.parametrize("bs", [0, 1, 17, 48, 1000])
def test_lpc_short_blocks_are_zero_past_their_end(bs):
    args = _lpc_args(80 + bs, bs=bs, valid=True)
    got = flac_lpc.flac_frame(*args).numpy()
    np.testing.assert_array_equal(got, jax_lpc(args))
    assert not got[:, :, bs:].any()


def test_lpc_invalid_lanes_are_silent():
    args = list(_lpc_args(99, bs=48))
    args[7] = torch.tensor([True, False, True, False, False, True])
    got = flac_lpc.flac_frame(*args).numpy()
    np.testing.assert_array_equal(got, jax_lpc(args))
    assert not got[[1, 3, 4]].any() and got[[0, 2, 5]].any()


def test_lpc_wraps_in_64_bits_not_32():
    """Mid/side on sums past 32 bits: the reference cuts to int32 only at
    the end, so ``(mid + side) >> 1`` keeps the carried bit."""
    resw = torch.tensor([[[2**31 - 1, -(2**31)], [2**31 - 1, 2**31 - 1]]], dtype=torch.int32)
    z2 = torch.zeros((1, 2), dtype=torch.int32)
    args = (resw, torch.zeros((1, 2, 32), dtype=torch.int32), z2, z2, z2,
            torch.tensor([10], dtype=torch.int32), torch.tensor([2], dtype=torch.int32),
            torch.tensor([True]))
    got = flac_lpc.flac_frame(*args).numpy()
    np.testing.assert_array_equal(got, jax_lpc(args))
    mid, side = 2 * (2**31 - 1) + 1, 2**31 - 1
    assert got[0, 0, 0] == np.int64((mid + side) >> 1).astype(np.int32)


def test_lpc_shifts_past_63_follow_xla():
    """No walk emits such shifts; the reference's int64 shifts read the
    amount as unsigned: a prediction shifted by 64 or more (or by a
    negative amount) keeps its sign, 0 or -1, and wasted bits of 64 or
    more (or negative) leave 0. The plain version computes the same."""
    args = list(_lpc_args(5, lanes=9, valid=True, bs=48))
    args[3] = args[3] + torch.tensor([64, 0, 100, -1, 2**31 - 1, 63, 0, 65, -64],
                                     dtype=torch.int32)[:, None]
    args[4] = args[4] + torch.tensor([[128, 0], [0, 64], [0, 0], [-3, 0], [0, 0], [0, 70],
                                      [0, 0], [0, 0], [0, 0]], dtype=torch.int32)
    got = flac_lpc.flac_frame(*args).numpy()
    np.testing.assert_array_equal(got, jax_lpc(args))
    assert not got[0, 0].any() and not got[1, 1].any(), "wasted bits past 63 leave 0"
    wild = kc.flac_lpc_random_inputs(5, wild=True)
    assert int(wild[3].max()) >= 64 and int(wild[4].max()) >= 64
    np.testing.assert_array_equal(flac_lpc.flac_frame(*wild).numpy(), jax_lpc(wild))


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------

def test_rice_matches_jax_on_the_fixture_segments():
    wire = fixture_wire()
    L = wire[0].shape[0]
    got = flac_rice.flac_rice_plane(*wire[:9], 4608)
    assert got.dtype == torch.int32 and got.shape == (L, 2, 4608)
    np.testing.assert_array_equal(got.numpy(), jax_rice_plane(wire[:9], 4608))
    k, n = wire[3].numpy(), wire[4].numpy()
    assert n.max() == 144 and len(set(k[n > 0].tolist())) >= 6
    assert int(wire[7].sum()) >= 4, "constant channels on the wire"


def test_rice_parameters_no_walk_emits_follow_xla():
    """Rice parameters of 32 and more, and negative bit offsets, as the
    reference computes them: its 32-bit shifts by 32 or more give 0, so
    k = 32 takes the remainder window as the value's zigzag and k > 32
    gives 0, each advancing by lead + 1 + k; a negative offset reads
    through ``jnp.take``, counting flat indices below 0 from the end of
    all rows and reading the take's fill below that."""
    args, stride, _ = crafted_wire([(31, [5]), (31, [-7]), (3, [1, -2, 3]), (3, [4, 5])])
    args = list(args)
    args[3] = torch.tensor([32, 35, 40, 3], dtype=torch.int32)
    n_bits = 32 * args[0].numel()
    args[2] = torch.tensor([0, 40, -45, -n_bits - 70], dtype=torch.int32)
    got = flac_rice.flac_rice_plane(*args, stride).numpy()
    np.testing.assert_array_equal(got, jax_rice_plane(args, stride))
    flat = got.reshape(-1)
    assert flat[40] != 0 and flat[190] == 0, "k = 32 keeps the window, k = 35 gives 0"
    wild = kc.flac_rice_random_inputs(3, wild=True)
    assert int(wild[3].max()) >= 32 and int(wild[2].min()) < 0
    np.testing.assert_array_equal(flac_rice.flac_rice_plane(*wild, 320).numpy(),
                                  jax_rice_plane(wild, 320))


@pytest.mark.parametrize("wild", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_rice_matches_jax_on_random_inputs(seed, wild):
    args = kc.flac_rice_random_inputs(seed, wild=wild)
    got = flac_rice.flac_rice_plane(*args, 320).numpy()
    np.testing.assert_array_equal(got, jax_rice_plane(args, 320))
    assert int(args[5].max()) > got.size, "segments past the plane's end"
    assert np.count_nonzero(got) > 1000


class Bits:
    """MSB-first bit writer for crafted frame rows."""

    def __init__(self, lead: int = 0):
        self.bits = [1] * lead  # ones: no segment starts inside them

    def rice(self, v: int, k: int) -> None:
        zz = (v << 1) if v >= 0 else (-(v << 1) - 1)
        self.bits += [0] * (zz >> k) + [1]
        self.bits += [(zz >> i) & 1 for i in range(k - 1, -1, -1)]

    def fixed(self, v: int, width: int) -> None:
        self.bits += [(v >> i) & 1 for i in range(width - 1, -1, -1)]

    def words(self, n_words: int, fill: int = 1) -> np.ndarray:
        bits = self.bits + [fill] * (32 * n_words - len(self.bits))
        assert len(bits) == 32 * n_words, "row too short for the crafted codes"
        return np.packbits(np.array(bits, np.uint8)).view(">u4").astype(np.uint32)


def crafted_wire(segments, n_words=160, stride=256, fill=1, lead=0):
    """One frame row holding ``segments`` back to back, each a tuple
    (k, values): Rice parameter ``k >= 0``, or ``-width - 1`` for fixed
    width. Segment ``i`` lands at ``dest = 40 + 150 * i``; empty frame rows
    follow until the plane holds every dest. Returns the K8 arguments and
    the values expected at each dest."""
    w = Bits(lead)
    lane, bitoff, ks, ns, dest = [], [], [], [], []
    for i, (k, values) in enumerate(segments):
        lane.append(0)
        bitoff.append(len(w.bits))
        ks.append(k)
        ns.append(len(values))
        dest.append(40 + 150 * i)
        for v in values:
            w.rice(v, k) if k >= 0 else w.fixed(v, -k - 1)
    n_rows = -(-(dest[-1] + ns[-1] + 1) // (2 * stride))
    words = np.zeros((n_rows, n_words), np.uint32)
    words[0] = w.words(n_words, fill)
    warm = np.zeros((n_rows, 2, 32))
    warm[0] = np.random.default_rng(1).integers(-99, 99, (2, 32))
    arrays = (words.view(np.int32), lane, bitoff, ks, ns, dest,
              warm, np.zeros((n_rows, 2)), np.zeros((n_rows, 2)))
    args = tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)) for a in arrays)
    return args, stride, list(zip(dest, (v for _, v in segments)))


def check_crafted(segments, **kw):
    args, stride, expect = crafted_wire(segments, **kw)
    got = flac_rice.flac_rice_plane(*args, stride).numpy()
    np.testing.assert_array_equal(got, jax_rice_plane(args, stride))
    flat = got.reshape(-1)
    for d, values in expect:
        np.testing.assert_array_equal(flat[d: d + len(values)], np.array(values, np.int64))
    return args, flat


RNG = np.random.default_rng(7)
CRAFTED = {
    "k0": [(0, [0, -1, 1, 5, -13, 2, 0, 0, -3])],
    "k7": [(7, RNG.integers(-400, 400, 30).tolist())],
    "k30": [(30, [2**29 + 5, -(2**29) - 77, 0, -1, 2**30 - 1, -(2**30)])],
    "quotient_past_24_zeros": [(0, [13, -13, 12, 20])],       # 26, 25, 24 and 40 zeros
    "quotient_past_48_zeros": [(0, [50, -13]), (3, [300, -200, 7])],  # 100 zeros; q = 75, 49
    "fixed_width_1": [(-2, [0, -1, -1, 0, -1])],
    "fixed_width_9": [(-10, RNG.integers(-256, 256, 16).tolist())],
    "fixed_width_32": [(-33, [2**31 - 1, -(2**31), 0, -1, 123456789, -987654321])],
    "fixed_width_0": [(-1, [0] * 16), (4, [9, -9])],
    "pad_rows_between_segments": [(2, [3, -4]), (0, []), (5, []), (-6, []), (2, [5, 6, -7])],
    "longest_segment": [(4, RNG.integers(-40, 40, 144).tolist())],
    "escape_and_rice_mix": [(0, [50, -13] + [0] * 14), (-10, RNG.integers(-200, 200, 16).tolist()),
                            (7, RNG.integers(-400, 400, 16).tolist()), (-1, [0] * 16)],
}


@pytest.mark.parametrize("name", CRAFTED)
def test_rice_crafted_segments(name):
    check_crafted(CRAFTED[name])


@pytest.mark.parametrize("lead", [0, 5, 27, 32])
def test_rice_code_ending_on_a_word_boundary(lead):
    """Codes whose last bit is the last bit of a word, and a segment that
    starts on a word boundary, at several alignments of the row."""
    first = [3, -2, 1]
    w = Bits(lead)
    for v in first:
        w.rice(v, 4)
    # a fixed-width code that takes the row up to a word boundary
    pad = (-len(w.bits)) % 32 or 32
    args, flat = check_crafted([(4, first), (-pad - 1, [-(1 << (pad - 1))]), (2, [7, -7, 0])],
                               lead=lead)
    assert int(args[2][2]) % 32 == 0


def test_rice_quotient_that_never_ends_emits_nothing_more():
    """A Rice segment that runs into the zero tail of its row: the codes
    before the tail decode, the rest stay at the fill."""
    args, stride, _ = crafted_wire([(1, [4, -5, 6])], n_words=8, fill=0)
    args = list(args)
    args[4] = torch.tensor([9], dtype=torch.int32)  # asks for nine codes: six are not there
    got = flac_rice.flac_rice_plane(*args, stride).numpy()
    np.testing.assert_array_equal(got, jax_rice_plane(args, stride))
    flat = got.reshape(-1)
    np.testing.assert_array_equal(flat[40:43], [4, -5, 6])
    assert not flat[43:49].any()


def test_rice_values_past_the_plane_are_dropped():
    args, stride, _ = crafted_wire([(3, list(range(-20, 20)))])
    args = list(args)
    args[5] = torch.tensor([2 * stride - 25], dtype=torch.int32)
    got = flac_rice.flac_rice_plane(*args, stride).numpy()
    np.testing.assert_array_equal(got, jax_rice_plane(args, stride))
    np.testing.assert_array_equal(got.reshape(-1)[-25:], np.arange(-20, 5))


def test_rice_segments_overwrite_warmup_and_constant_fill():
    """Channel 0 is constant, channel 1 has its warm-up; a segment lands
    on each and wins; the rest of both fills stays."""
    args, stride, _ = crafted_wire([(2, [11, -12, 13]), (2, [21, -22])])
    args = list(args)
    args[5] = torch.tensor([5, stride + 3], dtype=torch.int32)
    args[7] = torch.tensor([[1, 0]], dtype=torch.int32)
    args[8] = torch.tensor([[-777, 555]], dtype=torch.int32)
    got = flac_rice.flac_rice_plane(*args, stride).numpy()
    np.testing.assert_array_equal(got, jax_rice_plane(args, stride))
    want0 = np.full(stride, -777)
    want0[5:8] = [11, -12, 13]
    want1 = np.zeros(stride, np.int64)
    want1[:32] = args[6][0, 1].numpy()
    want1[3:5] = [21, -22]
    np.testing.assert_array_equal(got[0, 0], want0)
    np.testing.assert_array_equal(got[0, 1], want1)


def test_rice_with_no_segment_is_the_fill():
    z = torch.zeros(1, dtype=torch.int32)
    warm = torch.arange(128, dtype=torch.int32).reshape(2, 2, 32)
    args = (torch.zeros((2, 4), dtype=torch.int32), z, z, z, z, z, warm,
            torch.zeros((2, 2), dtype=torch.int32), torch.zeros((2, 2), dtype=torch.int32))
    got = flac_rice.flac_rice_plane(*args, 64).numpy()
    np.testing.assert_array_equal(got, jax_rice_plane(args, 64))
    np.testing.assert_array_equal(got[:, :, :32], warm.numpy())


def test_frames_segs_is_rice_then_lpc():
    wire = fixture_wire()
    got = flac_rice.flac_frames_segs(wire[0], wire[1:6], *wire[6:], 4608)
    plane = flac_rice.flac_rice_plane(*wire[:9], 4608)
    assert torch.equal(got, flac_lpc.flac_frame(plane, *wire[9:]))


def test_wrappers_default_to_the_kernel_and_refuse_other_devices():
    """A CPU tensor takes the plain version and counts no launch; a
    tensor on neither the CPU nor a CUDA device raises."""
    before = (flac_rice.flac_rice_plane.launches, flac_lpc.flac_frame.launches)
    args = kc.flac_lpc_random_inputs(1, lanes=2, T=8)
    flac_lpc.flac_frame(*args)
    with pytest.raises(ValueError, match="CUDA device"):
        flac_lpc.flac_frame(*[a.to("meta") for a in args])
    rargs = kc.flac_rice_random_inputs(1)
    with pytest.raises(ValueError, match="CUDA device"):
        flac_rice.flac_rice_plane(*[a.to("meta") for a in rargs], 320)
    assert before == (flac_rice.flac_rice_plane.launches, flac_lpc.flac_frame.launches)
