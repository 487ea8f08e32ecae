"""Port parity: the v4 glue, TNS and the frame step of
soundkit_tpu_torch/ops/aac_batch.py against soundkit_tpu/ops/aac_batch.py.

Integer maps are exact; float32 paths carry their stated tolerance."""
import numpy as np

import jax
import jax.numpy as jnp
import torch

from soundkit_tpu.codecs.aac_lc_native import prepare_frame_batch_grouped
from soundkit_tpu.ops import aac_batch as jab
from soundkit_tpu_torch.ops import aac_batch as tab

from torch_port_helpers import SR_INDEX_48K, host_parser, lane_snrs, picked_aus, v4_wire


def _wire_fields(B=None):
    aus = picked_aus() if B is None else picked_aus()[:B]
    buf = v4_wire(aus)
    return len(aus), buf, tab.unpack_v4_wire(torch.from_numpy(buf), len(aus)), \
        jab.unpack_v4_wire(jnp.asarray(buf), len(aus))


def _regions(rng, B, C, overlap: bool):
    r = np.zeros((B, C, jab.MAX_FILTERS, 3), np.int16)
    for f in range(3):
        start = rng.integers(0, 900, (B, C)) if overlap else f * 340 + rng.integers(0, 200, (B, C))
        r[:, :, f, 0] = start
        r[:, :, f, 1] = start + rng.integers(0, 124, (B, C))
        r[:, :, f, 2] = rng.integers(0, 2, (B, C))
    return r


def _lpc(rng, B, C):
    # |k| <= sin(4 / 4.77) = 0.74 at 4-bit resolution: stable filters
    refl = rng.integers(-4, 5, (B, C, jab.MAX_FILTERS, jab.MAX_ORDER)).astype(np.int8)
    crb = np.full((B, C, jab.MAX_FILTERS), 4, np.uint8)
    order = rng.integers(0, 21, (B, C, jab.MAX_FILTERS)).astype(np.uint8)
    return refl, crb, order


def test_unpack_v4_wire_fields_exact():
    B, _, t, j = _wire_fields()
    assert t.keys() == j.keys()
    for name in t:
        np.testing.assert_array_equal(t[name].numpy(), np.asarray(j[name]), err_msg=name)


def test_rle_expand_exact():
    B, _, t, j = _wire_fields()
    for lens, vals in (("sf_len", "sf_val"), ("msis_len", "msis_ms"),
                       ("msis_len", "msis_pos"), ("msis_len", "msis_sign")):
        got = tab.rle_expand(t[lens], t[vals]).numpy()
        ref = np.asarray(jab._rle_expand(j[lens], j[vals], 1024))
        np.testing.assert_array_equal(got, ref, err_msg=vals)


def test_perm_filt_from_regions_exact():
    rng = np.random.default_rng(3)
    for overlap in (False, True):
        regions = _regions(rng, 6, 2, overlap)
        perm, filt = tab.perm_filt_from_regions(torch.from_numpy(regions))
        jperm, jfilt = jab._perm_filt_from_regions(jnp.asarray(regions), 6, 2, 1024)
        np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
        np.testing.assert_array_equal(filt.numpy(), np.asarray(jfilt))


def test_pns_signs_exact():
    """The reference's v4 PNS fill (ops/aac_batch.py, v4 step) in uint32."""
    B, _, t, j = _wire_fields()
    mask, sign = tab.pns_signs(t["pns"], B)
    pns = j["pns"]
    line = jnp.arange(1024, dtype=jnp.uint32)[None, None, None, :]
    start = (pns & 4095)[..., None]
    nl = ((pns >> 12) & 1023)[..., None]
    ref_mask = jnp.any((line >= start) & (line < start + nl) & (nl > 0), axis=2)
    lane_id = jnp.arange(B, dtype=jnp.uint32)[:, None, None]
    h = line[:, :, 0] * jnp.uint32(2654435761) + lane_id * jnp.uint32(40503) + jnp.uint32(12345)
    ref_sign = jnp.where(((h >> jnp.uint32(13)) & 1) == 1, 1, -1).astype(jnp.int32)
    assert np.asarray(ref_mask).sum() > 100  # the picked AUs carry PNS bands
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_array_equal(sign.numpy(), np.asarray(ref_sign))


def test_tns_refl_to_lpc_matches_jax():
    rng = np.random.default_rng(4)
    B, _, t, j = _wire_fields()
    assert int((t["order"] > 0).sum()) >= 3  # real TNS filters in the wire
    cases = [(t["refl"], t["crb"], t["order"])]
    refl, crb, order = _lpc(rng, 8, 2)
    cases.append(tuple(torch.from_numpy(a) for a in (refl, crb, order)))
    for refl, crb, order in cases:
        got = tab.tns_refl_to_lpc(refl, crb, order).numpy()
        ref = np.asarray(jab._tns_refl_to_lpc(jnp.asarray(refl.numpy()), jnp.asarray(crb.numpy()),
                                              jnp.asarray(order.numpy())))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_tns_filter_plain_matches_scan():
    """Synthetic regions and LPC in every row (real TNS is rare);
    tolerance max|d| <= 1e-4 * max|ref| (a 20-tap float32 sum taken in
    another order, fed back through the recursion)."""
    rng = np.random.default_rng(6)
    B, C = 4, 2
    coef = (rng.standard_normal((B, C, 1024)) * 100).astype(np.float32)
    perm, filt = jab._perm_filt_from_regions(jnp.asarray(_regions(rng, B, C, False)), B, C, 1024)
    lpc = jab._tns_refl_to_lpc(*(jnp.asarray(a) for a in _lpc(rng, B, C)))
    ref = np.asarray(jax.jit(jab._tns_scan)(jnp.asarray(coef), perm, filt, lpc))
    got = tab.tns_filter(*(torch.from_numpy(np.array(a)) for a in (coef, perm, filt, lpc)))
    assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    assert not np.allclose(ref, coef)  # the filters did act


def test_decode_frame_matches_jax_full_wire():
    """The 12-argument frame step on a full-wire batch (host-dequantized
    inputs, including an EIGHT_SHORT lane and a TNS lane), from a
    nonzero carried state: PCM and state >= 100 dB per lane."""
    aus = picked_aus()[7:13]
    B = len(aus)
    fb = prepare_frame_batch_grouped({SR_INDEX_48K: host_parser()}, [SR_INDEX_48K] * B, aus)
    assert (fb.seq == 2).any() and (fb.filt_id >= 0).any()
    rng = np.random.default_rng(8)
    saved = (rng.standard_normal((B, 2, 1024)) * 1000).astype(np.float32)
    prev = rng.integers(0, 2, (B, 2)).astype(np.int32)
    fb.chan_valid[B - 1, 1] = False  # a ragged channel keeps its state
    args = (fb.quant, fb.scale, fb.ms_mask, fb.int_factor, fb.perm, fb.filt_id,
            fb.lpc, fb.seq, fb.shape, prev, fb.chan_valid, saved)
    ref = [np.asarray(x) for x in jax.jit(jab.aac_decode_frame_device)(*map(jnp.asarray, args))]
    got = [x.numpy() for x in tab.decode_frame(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))]
    assert lane_snrs(got[0], ref[0], 0).min() >= 100
    assert lane_snrs(got[1], ref[1], 0).min() >= 100
    np.testing.assert_array_equal(got[1][B - 1, 1], saved[B - 1, 1])
    # window shapes: the reference's on the channels that decoded; the
    # ragged channel keeps its own, as it keeps its state (the port's
    # stated departure, ``ops/aac_batch.py``)
    valid = fb.chan_valid.astype(bool)
    np.testing.assert_array_equal(got[2][valid], np.asarray(ref[2])[valid])
    np.testing.assert_array_equal(got[2][~valid], prev[~valid])
