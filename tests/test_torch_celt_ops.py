"""Port parity of the batched CELT synthesis: soundkit_tpu_torch's
``ops.celt_batch`` (the IMDCT products, then K11's plain version
``ops.celt_postfilter.celt_postfilter_plain`` on the CPU) against the JAX
package's ``ops/celt_batch.py`` and the masked steps of
``models/opus_batch.py`` on the CPU, on seeded numpy inputs: long and
short lanes, periods 15 and 1022 and between, every tapset, zero and
non-zero gains, a ragged validity mask, four chained frames from a
non-zero carried state; the int16 wire (dequantized by band) and a wire
trimmed to the coded band end; ``pack_comb_params``, the bin-to-band map
and K11's tables.

Tolerance: ``max|port - jax| <= 1e-5 * max|jax|`` on the PCM and on each
carried state (float32 products summed in another order; measured
~1e-6). A stream with ``valid`` False keeps its state bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soundkit_tpu.codecs.opus_tables import tables as jax_tables
from soundkit_tpu.models import opus_batch as jax_ob
from soundkit_tpu.ops import celt_batch as jax_cb
from soundkit_tpu_torch.models import opus_batch as ob
from soundkit_tpu_torch.ops import celt_batch as cb
from soundkit_tpu_torch.ops import celt_postfilter as cp
from soundkit_tpu_torch.tools import kernel_check as kc

REL = 1e-5
TAPS = jax_tables()["celt_postfilter_taps"].astype(np.float64)


def assert_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= REL * scale, f"{what}: max|d| {err} = {err / scale:.2e} of max|ref|"


def frame_inputs(rng, B, C, W=960):
    """One round: spectra f32 [B, C, W] (zero above the coded width),
    transient flags (~a third), comb parameters by ``pack_comb_params``
    from drawn postfilter states (periods 15..1022, with 15 and 1022 on
    the first lanes; gains 0..0.75 with a quarter zero; every tapset) and
    a ragged validity mask."""
    freq = (rng.standard_normal((B, C, W)) * 300).astype(np.float32)
    freq[..., 700:] *= 0.05  # the spectrum falls off toward the band end
    sflag = (rng.random(B) < 0.35).astype(np.int32)
    comb = np.zeros((B, 16), np.float32)
    for b in range(B):
        per = rng.integers(15, 1023, 3)
        if b < 2:
            per[:] = (15, 1022)[b]
        gains = rng.uniform(0, 0.75, 3) * (rng.random(3) >= 0.25)
        tap = rng.integers(0, 3, 3)
        state = (int(per[0]), int(per[1]), float(gains[0]), float(gains[1]), int(tap[0]),
                 int(tap[1]))
        comb[b] = jax_cb.pack_comb_params(state, int(per[2]), float(gains[2]), int(tap[2]), TAPS)
    valid = rng.random(B) < 0.75
    valid[0] = True
    return freq, sflag, comb, valid


def random_state(rng, B, C):
    return ((rng.standard_normal((B, C, 120)) * 2000).astype(np.float32),
            (rng.standard_normal((B, C, 1200)) * 2000).astype(np.float32),
            (rng.standard_normal((B, C)) * 2000).astype(np.float32))


@pytest.mark.parametrize("C", [2, 1])
def test_masked_step_matches_jax_over_chained_frames(C):
    """``celt_synth_step`` (the plain path on the CPU) against the JAX
    package's masked step, four frames chained from a random state."""
    rng = np.random.default_rng(20 + C)
    B = 11
    state = random_state(rng, B, C)
    j_state = tuple(jnp.asarray(a) for a in state)
    p_state = tuple(torch.from_numpy(a) for a in state)
    step = jax_ob._celt_masked_step()
    for r in range(4):
        ins = frame_inputs(rng, B, C)
        want = step(*(jnp.asarray(a) for a in ins), *j_state)
        got = cb.celt_synth_step(*(torch.from_numpy(a) for a in ins), *p_state)
        for name, g, w in zip(("pcm", "ola", "hist", "emph"), got, want):
            assert_close(g.numpy(), w, f"frame {r} {name}")
        off = ~ins[3]
        for g, before in zip(got[1:], p_state):
            assert torch.equal(g[torch.from_numpy(off)], before[torch.from_numpy(off)])
        assert not got[0][torch.from_numpy(off)].any()
        j_state, p_state = tuple(want[1:]), tuple(got[1:])
    assert float(np.abs(np.asarray(want[0])).max()) > 0.01


def test_unmasked_step_and_the_plain_step_match_jax():
    """All lanes valid: the JAX package's ``celt_synth_step`` against the
    port's step and ``celt_synth_step_plain``, which agree bit for bit on
    the CPU."""
    rng = np.random.default_rng(7)
    B, C = 9, 2
    freq, sflag, comb, _ = frame_inputs(rng, B, C)
    ola, hist, emph = random_state(rng, B, C)
    want = jax_cb.celt_synth_step(*(jnp.asarray(a) for a in (freq, sflag, comb, ola, hist, emph)))
    args = [torch.from_numpy(a) for a in (freq, sflag, comb, np.ones(B, bool), ola, hist, emph)]
    got = cb.celt_synth_step(*args)
    plain = cb.celt_synth_step_plain(*args)
    for name, g, p, w in zip(("pcm", "ola", "hist", "emph"), got, plain, want):
        assert torch.equal(g, p), name
        assert_close(g.numpy(), w, name)


def test_imdct_matches_the_float64_bases():
    """The long and short IMDCTs with the long/short select, against the
    products in float64 of the same bases."""
    rng = np.random.default_rng(1)
    B, C = 5, 2
    freq = (rng.standard_normal((B, C, 960)) * 300).astype(np.float32)
    sflag = np.array([0, 1, 1, 0, 1], np.int32)
    got = cb.celt_imdct(torch.from_numpy(freq), torch.from_numpy(sflag)).numpy()
    long_m, short_m = (m.astype(np.float64) for m in jax_cb._bases())
    f = freq.astype(np.float64)
    want = f @ long_m
    short = np.einsum("bckj,kt->bcjt", f.reshape(B, C, 120, 8), short_m)
    ws = np.zeros((B, C, 1080))
    for j in range(8):
        ws[..., 120 * j: 120 * j + 240] += short[:, :, j]
    want[sflag == 1] = ws[sflag == 1]
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


@pytest.mark.parametrize("quant", [False, True])
def test_multi_round_wire_matches_jax(quant):
    """Eight masked rounds of the reference's ``_celt_multi_step`` on a
    wire trimmed to 800 bins (a fullband collect): the float32 wire, and
    the int16 wire with its per-(round, lane, band) scales, against the
    port's rounds (``dequant_wire``, ``pad_wire``, then the step)."""
    rng = np.random.default_rng(30 + quant)
    R, B, C, W = 8, 7, 2, 800
    rounds = [frame_inputs(rng, B, C, W) for _ in range(R)]
    freq, sflag, comb, valid = (np.stack([r[i] for r in rounds]) for i in range(4))
    state = random_state(rng, B, C)
    extra_j, bidx = (), ob._band_of_bin(W)
    if quant:
        freq = rng.integers(-3000, 3000, freq.shape).astype(np.int16)
        scales = rng.uniform(0.01, 0.3, (R, B, 21)).astype(np.float32)
        extra_j = (jnp.asarray(scales), jnp.asarray(bidx))
    want_pcm, *want_state = jax_ob._celt_multi_step(quant)(
        *(jnp.asarray(a) for a in (freq, sflag, comb, valid, *state)), *extra_j)
    ola, hist, emph = (torch.from_numpy(a) for a in state)
    pcm = []
    for r in range(R):
        f = torch.from_numpy(freq[r])
        if quant:
            f = cb.dequant_wire(f, torch.from_numpy(scales[r]), torch.from_numpy(bidx).long())
        out, ola, hist, emph = cb.celt_synth_step(
            cb.pad_wire(f), torch.from_numpy(sflag[r]), torch.from_numpy(comb[r]),
            torch.from_numpy(valid[r]), ola, hist, emph)
        pcm.append(out)
    assert_close(torch.stack(pcm).numpy(), want_pcm, "pcm")
    for name, g, w in zip(("ola", "hist", "emph"), (ola, hist, emph), want_state):
        assert_close(g.numpy(), w, name)


def test_pack_comb_params_and_band_map_equal_the_jax_package():
    rng = np.random.default_rng(2)
    for _ in range(50):
        per = rng.integers(0, 1023, 3)
        g = rng.uniform(0, 0.8, 3)
        tap = rng.integers(0, 3, 3)
        state = (int(per[0]), int(per[1]), float(g[0]), float(g[1]), int(tap[0]), int(tap[1]))
        np.testing.assert_array_equal(
            cb.pack_comb_params(state, int(per[2]), float(g[2]), int(tap[2]), TAPS),
            jax_cb.pack_comb_params(state, int(per[2]), float(g[2]), int(tap[2]), TAPS))
    for width in (160, 320, 640, 800, 960):
        np.testing.assert_array_equal(ob._band_of_bin(width), jax_ob._band_of_bin(width))
    assert (cb.N, cb.NB_SHORT, cb.HIST) == (jax_cb.N, jax_cb.NB_SHORT, jax_cb.HIST)
    for got, want in zip(cb._bases(), jax_cb._bases()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cb._win2(), jax_cb._win2())


def test_k11_tables_are_the_reference_window_and_powers():
    """K11's table: ``w^2`` and ``c^0 .. c^8`` as the reference's scan
    builds its ``fvec``, ``Lmat`` and ``cpow``, then the de-emphasis
    scan's ``m^0 .. m^32``, ``m`` the float32 ``c^8`` and each power the
    float32 product of the one before and ``m``."""
    tab = cp.kernel_tables(torch.device("cpu")).numpy()
    np.testing.assert_array_equal(tab[:120], jax_cb._win2())
    c = np.float32(27853.0 / 32768.0)
    np.testing.assert_array_equal(tab[120:129], np.power(c, np.arange(9)).astype(np.float32))
    m = tab[128]
    assert tab[129] == 1 and len(tab) == 129 + 33
    np.testing.assert_array_equal(tab[130:], tab[129:-1] * m)
    fvec, lmat, cpow = (t.numpy() for t in cp._plain_tables(torch.device("cpu")))
    np.testing.assert_array_equal(cpow, tab[121:129])
    np.testing.assert_array_equal(lmat[:, 7], tab[127:119:-1])
    np.testing.assert_array_equal(fvec[240:], np.ones(720, np.float32))


def test_postfilter_clamps_periods_into_the_line():
    """Periods outside [15, 1024] (no parse emits them) read the line at
    the clamped period on the plain path, as K11 does, and never outside
    it; inside the range the clamp changes nothing."""
    inputs = kc.celt_postfilter_random_inputs(5, streams=6, channels=2)
    full, comb, valid, ola, hist, emph = inputs
    wild = comb.clone()
    wild[:, [0, 1, 8, 9]] = torch.tensor([0.0, -40.0, 1100.0, 5000.0])
    clamped = comb.clone()
    clamped[:, [0, 1, 8, 9]] = torch.tensor([15.0, 15.0, 1024.0, 1024.0])
    a = cp.celt_postfilter_plain(full, wild, valid, ola, hist, emph)
    b = cp.celt_postfilter_plain(full, clamped, valid, ola, hist, emph)
    for x, y in zip(a, b):
        assert torch.equal(x, y) and bool(torch.isfinite(x).all())


def test_postfilter_wrapper_routes_cpu_tensors_to_the_plain_version():
    inputs = kc.celt_postfilter_random_inputs(6, streams=5, channels=1)
    before = cp.celt_postfilter.launches
    out = torch.empty((5, 1, 960))
    got = cp.celt_postfilter(*inputs, pcm_out=out)
    want = cp.celt_postfilter_plain(*inputs)
    assert got[0] is out and cp.celt_postfilter.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    kc.celt_invalid_passthrough(got, inputs)


def test_postfilter_wrapper_on_cpu_views_equals_the_contiguous_result():
    """On the CPU the wrapper takes strided views of every input (every
    other element of a wider tensor) and gives the same PCM and state as on contiguous
    copies of them."""
    inputs = kc.celt_postfilter_random_inputs(7, streams=5, channels=2)
    views = tuple(torch.stack([t, t], dim=-1)[..., 0] for t in inputs)
    assert all(not v.is_contiguous() and torch.equal(v, t) for v, t in zip(views, inputs))
    for g, w in zip(cp.celt_postfilter(*views), cp.celt_postfilter(*inputs)):
        assert torch.equal(g, w)
