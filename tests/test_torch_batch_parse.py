"""The Opus batch parses of the port's library against the JAX package's:
``NativeCeltBatch.parse_many`` / ``parse_many_q`` / ``parse_many_cont``
and ``NativeSilkBatch.decode_many`` / ``hybrid_parse_rounds``, each a
verbatim copy of the JAX package's wrapper over the port's build of the
same C++ sources. The same rounds of the in-repo Opus fixtures (ragged
lanes, a mono clip in stereo lanes, SILK NB / MB / WB and stereo, hybrid
SWB / FB) go through both, round after round on stateful handles.

Integer outputs (transient flags, parse results, sample counts, the
walk's info and flags, the TOC-derived lags) are equal. The JAX package
builds its library with ``-march=native``, so its compiler fuses products
into FMAs that the port's portable build rounds apart: float outputs agree
to rounding, held here at 1e-9 of the largest value (measured on these
inputs: the CELT spectra 1.3e-16 of it, the SILK export equal, the SILK
synthesis, an LPC of high gain, 4.3e-14), and the int16 spectra within 1 on
a few values, as ``tests/test_torch_host_copies.py`` holds the serving
walks."""
import numpy as np
import pytest

from soundkit_tpu.codecs.celt_native import NativeCeltBatch as JaxCelt
from soundkit_tpu.codecs.silk_native import NativeSilkBatch as JaxSilk
from soundkit_tpu_torch.codecs.celt_native import NativeCeltBatch
from soundkit_tpu_torch.codecs.silk_native import NativeSilkBatch
from soundkit_tpu_torch.codecs.opus_tables import tables
from soundkit_tpu_torch.models.opus_batch import BatchedCeltDecoder
from soundkit_tpu_torch.tools import opus_fixtures

REL = 1e-9


def assert_agree(got, want, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        scale = max(float(np.abs(want).max()), 1e-30)
        assert np.abs(got.astype(np.float64) - want).max() <= REL * scale, name


def celt_rounds(B, R):
    """R rounds of B ragged CELT lanes: per round the lanes' (frame, end
    band, coded channels) and their validity."""
    raws = [opus_fixtures.lane_raw(opus_fixtures.load_clips(), B, R - 2 * i)[i] for i in range(B)]
    lanes = BatchedCeltDecoder(B, 2, device="cpu")
    for i, r in enumerate(raws):
        lanes.push(i, r)
    rounds = []
    for r in range(R):
        q = [p[r] if r < len(p) else (b"", 21, 2) for p in lanes._packets]
        valid = np.array([r < len(p) for p in lanes._packets], np.uint8)
        rounds.append(([t[0] for t in q], [t[1] for t in q], [t[2] for t in q], valid))
    return rounds


@pytest.mark.parametrize("quantized", [False, True])
def test_celt_parse_many_walks_as_the_jax_package(quantized):
    B, R = 4, 6
    port, ref = NativeCeltBatch(B, 2), JaxCelt(B, 2)
    parsed = 0
    for frames, ends, coded, valid in celt_rounds(B, R):
        if quantized:
            got, want = port.parse_many_q(frames, ends, coded, valid), \
                ref.parse_many_q(frames, ends, coded, valid)
            g, w = got[0].astype(np.int32), want[0].astype(np.int32)
            assert got[0].dtype == want[0].dtype == np.int16
            assert np.abs(g - w).max() <= 1 and (g != w).mean() < 1e-3
            rest = zip(got[1:], want[1:], ("scale", "comb", "sflag", "ok"))
        else:
            got, want = port.parse_many(frames, ends, coded, valid), \
                ref.parse_many(frames, ends, coded, valid)
            rest = zip(got, want, ("freq", "comb", "sflag", "ok"))
        for g, w, name in rest:
            assert_agree(g, w, name)
        ok = got[-1]
        assert (ok[valid == 0] == -100).all() and (ok[valid == 1] == 0).all()
        parsed += int(valid.sum())
    assert parsed == 4 * R - 12


def hybrid_lanes(B, R):
    clips = opus_fixtures.load_clips(names=("hybrid_swb", "hybrid_fb"))
    return [opus_fixtures.lane_frames(clips, b, R - b) for b in range(B)]


def test_silk_and_celt_continuation_walk_hybrid_rounds_as_the_jax_package():
    """The one-round SILK parse-export of hybrid frames, then
    ``parse_many_cont`` from each lane's exported coder state (start band
    17), round after round."""
    B, R = 3, 5
    lanes = hybrid_lanes(B, R)
    band_end = tables()["celt_band_end"].astype(int)
    sides = [(NativeSilkBatch(B, 2), NativeCeltBatch(B, 2)), (JaxSilk(B, 2), JaxCelt(B, 2))]
    for r in range(R):
        valid = np.array([r < len(fr) for fr in lanes], np.uint8)
        frames = [fr[r][0] if v else b"" for fr, v in zip(lanes, valid)]
        bws = [2] * B
        coded = [fr[r][2] if v else 1 for fr, v in zip(lanes, valid)]
        ends = [band_end[fr[r][1]] if v else 21 for fr, v in zip(lanes, valid)]
        outs = []
        for silk, celt in sides:
            p = silk.parse_many(frames, bws, coded, [20] * B, valid)
            c = celt.parse_many_cont(frames, [17] * B, ends, coded, valid, p["info"][:, 4:13])
            outs.append((p, c))
        (gp, gc), (wp, wc) = outs
        for k in wp:
            assert_agree(gp[k], wp[k], k)
        for g, w, name in zip(gc, wc, ("freq", "comb", "sflag", "ok", "red")):
            assert_agree(g, w, name)
        assert (gc[3][valid == 1] == 0).all() and np.abs(gc[0]).max() > 0


def test_silk_decode_many_decodes_as_the_jax_package():
    """Eight lanes of the SILK clips (NB, MB, WB mono, WB stereo with
    mid-only frames), ragged, over six rounds: PCM at the internal rate,
    sample counts and the 13 info words of each lane."""
    clips = opus_fixtures.load_clips(names=("silk_nb", "silk_mb", "silk_wb", "silk_wb_stereo"))
    B, R = 8, 6
    lanes = [opus_fixtures.lane_frames(clips * 2, b, R - b // 2) for b in range(B)]
    port, ref = NativeSilkBatch(B, 2), JaxSilk(B, 2)
    decoded = 0
    for r in range(R):
        valid = np.array([r < len(fr) for fr in lanes], np.uint8)
        frames = [fr[r][0] if v else b"" for fr, v in zip(lanes, valid)]
        bws = [fr[0][1] for fr in lanes]
        coded = [fr[r][2] if v else 1 for fr, v in zip(lanes, valid)]
        got = port.decode_many(frames, bws, coded, [20] * B, valid)
        want = ref.decode_many(frames, bws, coded, [20] * B, valid)
        for g, w, name in zip(got, want, ("pcm", "n", "info")):
            assert_agree(g, w, name)
        assert (got[1][valid == 0] == -1).all() and (got[1][valid == 1] > 0).all()
        assert np.abs(got[0]).max() > 0
        decoded += int(valid.sum())
    assert decoded == 36


def test_hybrid_parse_rounds_walks_as_the_jax_package():
    """The unpacked hybrid walk: every float64 plane of the SILK export
    and the CELT continuation for a chunk of 8 rounds of three ragged
    lanes."""
    B, R = 3, 8
    lanes = hybrid_lanes(B, R)
    band_end = tables()["celt_band_end"].astype(int)
    plens, ends, coded = (np.zeros((B, R), np.int32) for _ in range(3))
    base, parts, pos = np.zeros(B, np.int64), [], 0
    for b, fr in enumerate(lanes):
        plens[b, :len(fr)] = [len(f) for f, _, _ in fr]
        ends[b, :len(fr)] = [band_end[bw] for _, bw, _ in fr]
        coded[b, :len(fr)] = [c for _, _, c in fr]
        base[b] = pos
        parts += [f for f, _, _ in fr]
        pos += sum(len(f) for f, _, _ in fr)
    buf = b"".join(parts)
    got = NativeSilkBatch(B, 2).hybrid_parse_rounds(NativeCeltBatch(B, 2), buf, base, plens,
                                                     ends, coded)
    want = JaxSilk(B, 2).hybrid_parse_rounds(JaxCelt(B, 2), buf, base, plens, ends, coded)
    assert sorted(got) == sorted(want)
    for k in want:
        assert_agree(got[k], want[k], k)
    assert (got["ok"][plens.T > 0] == 0).all() and (got["n"][plens.T > 0] > 0).all()
    assert np.abs(got["freq"]).max() > 0 and np.abs(got["exc"]).max() > 0
