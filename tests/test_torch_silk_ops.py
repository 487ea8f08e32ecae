"""Port parity of the batched SILK synthesis: soundkit_tpu_torch's
``ops/silk_synth.py`` (K12's plain version, the one the CPU runs) and
``ops/silk_batch.py`` against the JAX package's ``ops/silk_batch.py``
on the same inputs, made with numpy from a seed or exported by the SILK
walk from the committed voice fixtures (tests/data/torch_port/opus).

Bars: on seeded rows, one frame (``synth_frame``) within 1e-5 of the JAX
op's largest value, the output line and the tail (the sums run in
another order than XLA's einsums). On frames the walk exports from the
fixtures, one frame or one round (``silk_round``) from a given state in
float64 within 1e-9 of the JAX op's largest value (the same algorithm),
and in float32 each package within 2.5e-5 of it from the float64 result:
the JAX op's own float32 result lies up to 1.6e-5 from it there (an LPC
of high gain amplifies the rounding of its sums), so no float32 sum
order meets 1e-5 on every such frame. Chained rounds: float64 at 160 dB
a lane, each package's float32 chain at 95 dB against the float64 one.
The committed resampler table equals the JAX package's probe of its
libswresample-matched resampler bit for bit."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from soundkit_tpu.codecs.silk_native import NativeSilkBatch as JaxSilkBatch
from soundkit_tpu.ops import silk_batch as jsb
from soundkit_tpu_torch.codecs.silk_native import NativeSilkBatch
from soundkit_tpu_torch.ops import silk_batch as sb
from soundkit_tpu_torch.ops import silk_synth as ss
from soundkit_tpu_torch.tools import opus_fixtures
from torch_port_helpers import lane_snrs

REL = 1e-5
# float32 against float64 on the walked frames, for either package: the
# JAX op's own float32 result lies up to 1.6e-5 of its largest value from
# its float64 result on these frames (an LPC of high gain amplifies the
# rounding of its sums), so 1e-5 holds for no float32 sum order there
F32_WALKED = 2.5e-5


def close(got, want, bound=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= bound * np.abs(want).max()


def random_frame(rng, B: int, bw: int):
    """The export of one frame for [B, 2] rows: voiced and unvoiced rows,
    with and without lead-in, lags at the bandwidth's minimum and maximum
    and between, stable low-order LPC, an all-zero row."""
    exc = (rng.standard_normal((B, 2, 320)) * 0.05).astype(np.float32)
    gains = rng.uniform(0.2, 2.0, (B, 2, 4)).astype(np.float32)
    coef = (rng.standard_normal((B, 2, 2, 16)) * 0.08).astype(np.float32)
    lead = rng.integers(0, 2, (B, 2)).astype(np.int32)
    voiced = rng.integers(0, 2, (B, 2)).astype(np.int32)
    lo, hi = (16, 24, 32)[bw], (144, 216, 288)[bw]
    lags = rng.integers(lo, hi + 1, (B, 2, 4)).astype(np.int32)
    lags[0, 0], lags[0, 1], voiced[0] = lo, hi, 1
    ltp = (rng.standard_normal((B, 2, 4, 5)) * 0.1).astype(np.float32)
    ltpscale = rng.uniform(0.5, 1.5, (B, 2)).astype(np.float32)
    hist = np.clip(rng.standard_normal((B, 2, 322)) * 0.3, -1, 1).astype(np.float32)
    tail = (rng.standard_normal((B, 2, 16)) * 0.3).astype(np.float32)
    ins = [exc, gains, coef, lead, voiced, lags, ltp, ltpscale, hist, tail]
    for a in ins:
        a[B - 1, 1] = 0
    return ins


@pytest.mark.parametrize("bw", [0, 1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_synthesis_matches_synth_frame_on_random_rows(bw, seed):
    rng = np.random.default_rng(100 * bw + seed)
    ins = random_frame(rng, 7, bw)
    want = jax.jit(jsb.synth_frame(jnp.float32, ss.SFL[bw], ss.ORDER[bw]))(*ins)
    got = ss.silk_synth(bw, *[torch.from_numpy(a) for a in ins])  # CPU: the plain version
    for g, w in zip(got, want):
        close(g.numpy(), w)
    assert not got[0][6, 1].any()  # the all-zero row


def walk_rounds(clip_name: str, rounds: int, lanes: int = 3, starts=None):
    """The JAX walk's export of ``rounds`` frames of a voice clip for
    ``lanes`` lanes (lane b starts ``starts[b]`` packets in, 5 b by
    default), a dict of numpy planes a round."""
    clip = opus_fixtures.load_clips(names=(clip_name,))[0]
    starts = starts or [5 * b for b in range(lanes)]
    frames = [opus_fixtures.lane_frames([clip], 0)[starts[b]:] for b in range(lanes)]
    bw = frames[0][0][1]
    walk = JaxSilkBatch(lanes, 2)
    out = []
    for r in range(rounds):
        p = walk.parse_many([f[r][0] for f in frames], [bw] * lanes, [f[r][2] for f in frames],
                            [20] * lanes, [1] * lanes)
        assert (p["n"] > 0).all()
        out.append(p)
    return bw, out


def round_args(p, B, gain=1.0, valid=None, fresh=None):
    """silk_round's per-round arguments from a walk export, as numpy."""
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    i32 = lambda a: np.ascontiguousarray(a, np.int32)  # noqa: E731
    return (f32(p["exc"]), f32(p["gains"]), f32(p["coef"]), i32(p["flags"][:, 7:9]),
            i32(p["flags"][:, 5:7]), i32(p["lags"]), f32(p["ltp"]), f32(p["ltpscale"]),
            i32(p["flags"][:, 9:11]), i32(p["flags"][:, 2] == 2), i32(p["flags"][:, 4]),
            f32(p["stereo_w"]), np.full(B, gain, np.float32),
            np.ones(B, bool) if valid is None else valid,
            np.zeros(B, np.float32) if fresh is None else fresh)


def f64(a):
    a = np.asarray(a)
    return a.astype(np.float64) if a.dtype == np.float32 else a


@pytest.mark.parametrize("clip", ["silk_nb", "silk_mb", "silk_wb", "silk_wb_stereo"])
def test_plain_synthesis_matches_synth_frame_on_walked_frames(clip):
    """Twelve frames of four lanes of a fixture as the walk exports them,
    each from the JAX op's state after the frame before. In float64 the
    plain version is the JAX op to 1e-9 of its largest value (the same
    algorithm). In float32 both packages' frames lie within
    ``F32_WALKED`` of the op's largest value from the float64 result."""
    bw, rounds = walk_rounds(clip, 12, lanes=4)
    state = [np.zeros((4, 2, 322), np.float32), np.zeros((4, 2, 16), np.float32)]
    run = jax.jit(jsb.synth_frame(jnp.float32, ss.SFL[bw], ss.ORDER[bw]))
    with jax.enable_x64():
        run64 = jax.jit(jsb.synth_frame(jnp.float64, ss.SFL[bw], ss.ORDER[bw]))
        for p in rounds:
            a = round_args(p, 4)
            ins = [a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], *state]
            want = [np.asarray(w) for w in run(*ins)]
            ref64 = [np.asarray(w) for w in run64(*map(f64, ins))]
            got = ss.silk_synth_plain(bw, *[torch.from_numpy(np.array(x)) for x in ins])
            got64 = ss.silk_synth_plain(bw, *[torch.from_numpy(f64(x)) for x in ins])
            scale = max(np.abs(r).max() for r in ref64)
            for g, w, g64, r in zip(got, want, got64, ref64):
                assert g.dtype == torch.float32 and g64.dtype == torch.float64
                assert np.abs(g64.numpy() - r).max() <= 1e-9 * scale
                assert np.abs(g.numpy().astype(np.float64) - r).max() <= F32_WALKED * scale
                assert np.abs(w.astype(np.float64) - r).max() <= F32_WALKED * scale
            state = [want[0][..., -322:], want[1]]


def test_silk_synth_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(9)
    ins = [torch.from_numpy(a) for a in random_frame(rng, 3, 2)]
    before = ss.silk_synth.launches
    for g, w in zip(ss.silk_synth(2, *ins), ss.silk_synth_plain(2, *ins)):
        assert torch.equal(g, w)
    assert ss.silk_synth.launches == before


def test_lags_outside_the_streams_range_stay_inside_the_lines():
    """The plain version clamps the lags to [3, 288], as K12 does: a row
    with lags of 0, 1, -7 or 999 reads no sample outside its lines, and
    the rows beside it keep their values."""
    rng = np.random.default_rng(10)
    ins = random_frame(rng, 4, 2)
    ins[4][2] = 1  # the wild row voiced
    base = ss.silk_synth_plain(2, *[torch.from_numpy(a) for a in ins])
    wild = [a.copy() for a in ins]
    wild[5][2] = np.array([[0, 1, -7, 999], [2, 3, 400, -1]], np.int32)
    got = ss.silk_synth_plain(2, *[torch.from_numpy(a) for a in wild])
    for g, b in zip(got, base):
        assert torch.isfinite(g[2]).all()
        assert torch.equal(torch.cat([g[:2], g[3:]]), torch.cat([b[:2], b[3:]]))


def jax_round(bw, stereo, args, state, dtype=np.float32):
    if dtype == np.float64:
        args = [f64(a) for a in args]
        state = [f64(x) for x in state]
    y, *state = jsb.silk_round(bw, stereo, *args, *state)
    return np.asarray(y), [np.asarray(s) for s in state]


def port_round(bw, stereo, args, state, dtype=np.float32):
    if dtype == np.float64:
        args = [f64(a) for a in args]
        state = [f64(x) for x in state]
    y, *state = sb.silk_round(bw, stereo, *[torch.from_numpy(np.array(a)) for a in args],
                              *[torch.from_numpy(np.array(s)) for s in state])
    return y.numpy(), [s.numpy() for s in state]


@pytest.mark.parametrize("clip,stereo", [("silk_nb", False), ("silk_mb", False),
                                         ("silk_wb_stereo", True), ("silk_wb_stereo", False)])
def test_silk_round_matches_jax_round_by_round_and_chained(clip, stereo):
    """Eight rounds of three lanes: lane 1 idles in round 3 and is fresh
    again (recycled) in round 5; the stereo clip codes mono and stereo
    packets (lane 1 switches to mono coding, lane 2 back to stereo with a
    side reset) and mid-only frames (lane 0).

    Each round from the JAX state: in float64 within 1e-9 of the op's
    largest value; in float32 both packages within ``F32_WALKED`` of it
    from the float64 result (see the walked-frame test of the
    synthesis). Chained, each package from its
    own state: float64 against float64 at 160 dB a lane; the port's
    float32 chain against the JAX float64 chain at 95 dB a lane, the bar
    the JAX package holds its own float32 serving path to
    (tests/test_silk_device.py), which its float32 chain meets here too.
    (Two float32 chains are not held to each other at 100 dB: on the WB
    clips each lies 97-101 dB from the float64 result, so they may lie
    95-97 dB apart.)"""
    bw, rounds = walk_rounds(clip, 8, starts=[3, 20, 45] if clip == "silk_wb_stereo" else None)
    B = 3
    j32 = [np.asarray(s) for s in jsb.init_state(B, bw, np.float32)]
    j64, p32, p64 = [f64(x) for x in j32], [x.copy() for x in j32], [f64(x) for x in j32]
    ys = {k: [] for k in ("j32", "j64", "p32", "p64")}
    flags = np.stack([p["flags"] for p in rounds])
    with jax.enable_x64():
        for r, p in enumerate(rounds):
            valid = np.array([True, r != 3, True])
            fresh = np.array([r == 0, r in (0, 5), r == 0], np.float32)
            args = round_args(p, B, gain=0.5 if bw == 1 else 1.0, valid=valid, fresh=fresh)
            want64 = jax_round(bw, stereo, args, j32, np.float64)
            got64 = port_round(bw, stereo, args, j32, np.float64)
            one = port_round(bw, stereo, args, j32)
            want = jax_round(bw, stereo, args, j32)
            outs64 = [want64[0], *want64[1]]
            scale = max(np.abs(w).max() for w in outs64)
            for g, w in zip([got64[0], *got64[1]], outs64):
                assert g.dtype == np.float64 and np.abs(g - w).max() <= 1e-9 * scale
            for g, w, r in zip([one[0], *one[1]], [want[0], *want[1]], outs64):
                assert g.dtype == np.float32
                assert np.abs(g.astype(np.float64) - r).max() <= F32_WALKED * scale
                assert np.abs(w.astype(np.float64) - r).max() <= F32_WALKED * scale
            for key, fn, dt in (("j32", jax_round, np.float32), ("j64", jax_round, np.float64),
                                ("p32", port_round, np.float32), ("p64", port_round, np.float64)):
                state = {"j32": j32, "j64": j64, "p32": p32, "p64": p64}[key]
                y, state = fn(bw, stereo, args, state, dt)
                ys[key].append(y)
                if key == "j32":
                    j32 = state
                elif key == "j64":
                    j64 = state
                elif key == "p32":
                    p32 = state
                else:
                    p64 = state
    y = {k: np.stack(v) for k, v in ys.items()}
    assert lane_snrs(y["p64"], y["j64"], lane_axis=1).min() >= 160
    assert lane_snrs(y["p32"], y["j64"], lane_axis=1).min() >= 95
    assert lane_snrs(y["j32"], y["j64"], lane_axis=1).min() >= 95
    if clip == "silk_wb_stereo":
        assert (flags[:, :, 2] == 2).any() and (flags[:, :, 2] == 1).any()
        assert flags[:, :, 3].any() and flags[:, :, 4].any()  # mid-only frames, a side reset


@pytest.mark.parametrize("bw", [0, 1, 2])
def test_committed_resampler_table_equals_the_jax_probe(bw):
    taps, off = jsb.resampler_taps(bw)
    got_taps, got_off = sb.resampler_taps(bw)
    assert got_off == off and got_taps.dtype == taps.dtype
    np.testing.assert_array_equal(got_taps, taps)
    want_c = jsb.first_slot_correction(bw)
    assert sb.first_slot_correction(bw).dtype == want_c.dtype
    np.testing.assert_array_equal(sb.first_slot_correction(bw), want_c)
    for g, w in zip(sb._resample_plan(bw), jsb._resample_plan(bw)):
        np.testing.assert_array_equal(g, w)
    assert sb.lead_invalid(bw) == jsb.lead_invalid(bw) == (23, 0, 0)[bw]
    assert [s.shape for s in sb.init_state(2, bw, device="cpu")] == \
        [s.shape for s in jsb.init_state(2, bw)]


def test_resampler_table_regenerates(tmp_path):
    from torch_port_helpers import generate_silk_resampler_table

    generate_silk_resampler_table(tmp_path / "t.npz")
    with np.load(tmp_path / "t.npz") as new, np.load(sb.TABLE_PATH) as old:
        assert sorted(new.files) == sorted(old.files)
        for k in new.files:
            assert new[k].dtype == old[k].dtype
            np.testing.assert_array_equal(new[k], old[k])


def test_walk_exports_equal_the_jax_walk():
    """The port's build of ``silk_parse.cpp`` exports the JAX package's
    planes for the same frames (every field equal; the excitation, gains
    and LPC up to the compilers' rounding)."""
    clip = opus_fixtures.load_clips(names=("silk_wb_stereo",))[0]
    frames = opus_fixtures.lane_frames([clip], 0)
    port, ref = NativeSilkBatch(2, 2), JaxSilkBatch(2, 2)
    for r in range(30):
        fr = [frames[r][0], frames[r + 40][0]]
        args = (fr, [2, 2], [frames[r][2], frames[r + 40][2]], [20, 20], [1, r % 4 != 1])
        got, want = port.parse_many(*args), ref.parse_many(*args)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            if want[k].dtype == np.float64:
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
