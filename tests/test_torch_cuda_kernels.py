"""Each CUDA kernel against its plain PyTorch version on the card, with
the inputs and bounds of ``soundkit_tpu_torch.tools.kernel_check``
(the ones ``chip_smoke.py`` applies at B = 1024), at small shapes.

Needs an NVIDIA GPU (sm_90a) and nvcc; skipped without one. It imports
no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from soundkit_tpu_torch.native import AacHostParser
from soundkit_tpu_torch.ops import flac_lpc
from soundkit_tpu_torch.ops import silk_synth as ss
from soundkit_tpu_torch.tools import aac_fixtures as fx
from soundkit_tpu_torch.tools import kernel_check as kc

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("L,K", [(70, 1024), (300, 128)])
def test_imdct_window_kernels(dev, L, K):
    kc.compare("imdct_window", *kc.imdct_case(L, K == 128, dev, seed=L))
    kc.compare("dequant_imdct_window", *kc.dequant_imdct_case(L, dev, seed=L))


def test_spectral_decode_kernel_bit_exact(dev):
    B = 72
    buf, overflow = AacHostParser(3).pack_v4(fx.batch_aus(fx.clip_aus(fx.load_clips()), B, 0))
    assert not overflow
    kc.compare("spectral_decode", *kc.spectral_case(torch.from_numpy(buf).to(dev), B))


@pytest.mark.parametrize("seed", [1, 2])
def test_spectral_decode_kernel_random_inputs(dev, seed):
    """Random AU bytes, offsets and run programs on 74 lanes, not a
    multiple of the block's lanes."""
    kc.compare("spectral_decode", *kc.spectral_random_case(37, dev, seed=seed))


def test_tns_filter_kernel(dev):
    kc.compare("tns_filter", *kc.tns_case(40, 2, dev, seed=2, kind="overlap"))


@pytest.mark.parametrize("kind", kc.TNS_KINDS)
def test_tns_filter_kernel_layouts(dev, kind):
    """Every TNS layout, on a row count that leaves the last block part
    empty (the kernel stages four rows per block)."""
    kc.compare("tns_filter", *kc.tns_case(19, 2, dev, seed=3, kind=kind))


def test_g711_decode_kernel_bit_exact(dev):
    kc.compare("g711_decode", *kc.g711_case(50, 333, dev, seed=1))


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("N", [1, 15, 16, 17, 257, 2048])
@pytest.mark.parametrize("offset", [1, 4, 16])
def test_g711_decode_kernel_on_a_view(dev, offset, N, ragged):
    """Codes read in place from a larger buffer at a byte offset: rows
    that start off a 16-byte boundary and whose length is no multiple of
    16 take the kernel's one-by-one head and tail."""
    kc.compare("g711_decode", *kc.g711_case(9, N, dev, seed=N + offset, offset=offset,
                                            ragged=ragged))


@pytest.mark.parametrize("encode", [False, True])
@pytest.mark.parametrize("bits", [2, 3, 4, 5])
def test_g726_scan_kernel_bit_exact(dev, bits, encode):
    kc.compare("g726_scan", *kc.g726_case(70, 257, bits, encode, dev, seed=bits))


@pytest.mark.parametrize("N", [257, 264])
@pytest.mark.parametrize("encode", [False, True])
@pytest.mark.parametrize("bits", [2, 3, 4, 5])
def test_g726_scan_kernel_from_a_carried_state(dev, bits, encode, N):
    """From the state a first scan left; B = 70 leaves a ragged last
    block and N a ragged last tile, with rows that are not 4-byte
    aligned (257: staged by bytes) or are (264: cp.async)."""
    kc.compare("g726_scan", *kc.g726_case(70, N, bits, encode, dev, seed=bits, carried=True))


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("N", [257, 264])
@pytest.mark.parametrize("encode", [False, True])
def test_g722_scan_kernel_bit_exact(dev, encode, N, carried):
    """From the initial state and from the one a first scan left; B = 70
    leaves a ragged last block and N a partial last tile, with rows
    staged by bytes (257) or by cp.async (264); the mask has holes."""
    kc.compare("g722_scan", *kc.g722_case(70, N, encode, dev, seed=9, carried=carried))


@pytest.mark.parametrize("lanes,rounds", [(9, 1), (37, 2)])
def test_flac_kernels_on_the_fixture_wire(dev, lanes, rounds):
    """K8 and K9 on the wire of ragged fixture lanes: 37 lanes leave the
    last warp of K9 and the last block of K8 part empty."""
    wire = kc.flac_fixture_wire(lanes, rounds, dev)
    kc.compare("flac_rice_plane", *kc.flac_rice_case(wire))
    kc.compare("flac_frame", *kc.flac_lpc_case(wire))


@pytest.mark.parametrize("wild", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_flac_rice_kernel_random_inputs(dev, seed, wild):
    """Quotients past 24 and 48 zeros and ones that never end, fixed
    widths 0..32, values past the plane's end, windows past a row's end;
    ``wild``: Rice parameters past 31 and negative bit offsets."""
    kc.compare("flac_rice_plane", *kc.flac_rice_random_case(dev, seed=seed, wild=wild))


@pytest.mark.parametrize("wild", [False, True])
@pytest.mark.parametrize("lanes,T", [(37, 96), (16, 40), (1, 33), (70, 257)])
def test_flac_lpc_kernel_random_inputs(dev, lanes, T, wild):
    """Whole-range int32 residuals (64-bit wrap), orders 0..32, every
    assignment, short blocks and invalid lanes; lane counts that fill a
    warp, leave one part empty, or hold a single lane."""
    kc.compare("flac_frame",
               *kc.flac_lpc_random_case(dev, seed=lanes, lanes=lanes, T=T, wild=wild))


@pytest.mark.parametrize("wild", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_flac_rice_kernel_stride_not_a_multiple_of_4(dev, seed, wild):
    """Plane rows of 321 values: the fill takes one word a store."""
    kc.compare("flac_rice_plane",
               *kc.flac_rice_random_case(dev, seed=seed, stride=321, wild=wild))


@pytest.mark.parametrize("stride", [1280, 1281])
@pytest.mark.parametrize("seed", [1, 2])
def test_flac_rice_kernel_segments_longer_than_a_chunk(dev, seed, stride):
    """Segments of 600 codes: several rounds of the chunked writer."""
    wire = tuple(t.to(dev) for t in kc.flac_rice_long_inputs(seed, stride))
    kc.compare("flac_rice_plane", *kc.flac_rice_case(wire, stride))


@pytest.mark.parametrize("stride", [320, 321])
def test_flac_rice_kernel_empty_segment_table(dev, stride):
    """No segment: the plane is the fill."""
    args = [t.to(dev) for t in kc.flac_rice_random_inputs(4, stride=stride)]
    empty = args[1][:0]
    wire = (args[0], empty, empty, empty, empty, empty, *args[6:])
    kc.compare("flac_rice_plane", *kc.flac_rice_case(wire, stride))


@pytest.mark.parametrize("T", [33, 96, 257, 4608])
@pytest.mark.parametrize("lanes", [1, 37, 1001])
def test_flac_lpc_kernel_switch_to_64_bits_in_mid_block(dev, lanes, T):
    """Rows whose samples leave int32 at every sample position: the
    int32 path hands over to the 64-bit one in mid-block, across tile
    boundaries too; T = 96 and 4608 (the path's stride) take the 16-byte
    loads and stores, T = 33 and 257 the scalar ones."""
    args = [t.to(dev) for t in kc.flac_lpc_switch_inputs(lanes, T)]
    kc.compare("flac_frame", lambda: flac_lpc.flac_frame(*args),
               lambda: flac_lpc.flac_frame_plain(*args))


@pytest.mark.parametrize("channels", [2, 1])
@pytest.mark.parametrize("streams,granules", [(1, 2), (37, 4), (300, 5)])
def test_mp3_synth_kernel_random_inputs(dev, streams, granules, channels):
    """Random packed wires chained over several granules: block types
    -7..8, mixed lanes, invalid lanes, M/S with an invalid partner,
    alias boundaries outside 0..31 and a non-zero starting state; 37
    streams give rows on 16-byte boundaries, 1 and 300 rows that are not
    (the kernel's 4-byte loads)."""
    kc.compare("mp3_synth", *kc.mp3_synth_random_case(dev, seed=streams, streams=streams,
                                                      channels=channels, granules=granules))


@pytest.mark.parametrize("channels", [2, 1])
def test_mp3_synth_kernel_on_the_fixture_path(dev, channels):
    """The decoder's next wire row over 40 ragged fixture streams, mono
    streams in the stereo decoder among them, with its carried state."""
    kc.compare("mp3_synth", *kc.mp3_synth_pair(*kc.mp3_fixture_inputs(40, dev,
                                                                      channels=channels)))


def test_mp3_synth_holds_its_bound_with_tf32_on(dev):
    """A caller that turns TF32 on does not move the plain version off
    IEEE float32 (its products run under ``ieee_fp32``): K10 and the
    plain version still agree within the bound, and the caller's
    settings are back afterwards."""
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        kc.compare("mp3_synth", *kc.mp3_synth_random_case(dev, seed=9, streams=200, granules=3))
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False


def test_mp3_requantize_probe_on_the_card(dev):
    """K10's requantize arithmetic on the card against the plain
    version's on the CPU: ``exp2f`` and ``powf`` within 1 ulp, the line
    (their product with the sign, rounded twice on each side) within 3,
    the sentinel's scale 0, and the probe moves no K10 count
    (``[mp3-compare]`` measured 1 / 1 / 2 ulps on its 5.9 M pairs)."""
    from soundkit_tpu_torch.ops import mp3_synth

    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.integers(-8206, 8207, (3, 2, 576)).astype(np.int16))
    e = torch.from_numpy(rng.integers(-500, 100, (3, 2, 576)).astype(np.int16))
    e[0, 0, :16] = -32768
    before = mp3_synth.mp3_granule_packed.launches
    card = [t.cpu() for t in mp3_synth.requantize_probe(q.to(dev), e.to(dev))]
    assert mp3_synth.mp3_granule_packed.launches == before
    plain = mp3_synth.requantize_probe(q, e)
    for got, want, ulps in zip(card, plain, (1, 1, 3)):
        got, want = got.numpy().astype(np.float64), want.numpy()
        assert np.all(np.abs(got - want) <= ulps * np.spacing(np.abs(want)))
    assert not card[0][0, 0, :16].any()
    drift = kc.mp3_requantize_drift(kc.mp3_compare_rows(24), 24, 2, dev)
    assert drift["line"]["max_ulp"] <= 3 and drift["line"]["min_lane_snr_db"] > 120


def test_mp3_decoder_writes_the_collect_in_place(dev):
    """The decoder's granule steps on the card write their PCM into one
    collect tensor: one K10 launch a granule, and the collect equals
    the CPU plain path's within K10's bound."""
    from soundkit_tpu_torch.models.mp3_batch_model import BatchedMp3Decoder
    from soundkit_tpu_torch.ops import mp3_synth
    from soundkit_tpu_torch.tools import mp3_fixtures

    outs = []
    for device in ("cuda", "cpu"):
        model = BatchedMp3Decoder(12, device=device)
        for i, data in enumerate(mp3_fixtures.lane_streams(mp3_fixtures.load_clips(), 12, 3)):
            model.push(i, data)
        before = mp3_synth.mp3_granule_packed.launches
        outs.append(model.decode_batches(5, device_out=True).cpu())
        assert mp3_synth.mp3_granule_packed.launches - before == (5 if device == "cuda" else 0)
    kc.compare("mp3_synth", lambda: outs[0], lambda: outs[1])


def _celt_check(inputs):
    kernel, plain = kc.celt_postfilter_pair(inputs)
    kc.compare("celt_postfilter", kernel, plain)
    kc.celt_invalid_passthrough(kernel(), inputs)


@pytest.mark.parametrize("channels", [2, 1])
@pytest.mark.parametrize("streams", [1, 37, 300])
def test_celt_postfilter_kernel_random_inputs(dev, streams, channels):
    """Seeded frames: periods 15..1022 and the edge periods (15, 1022,
    1024, and 33-35 where a comb step widens), all three tapsets, zero and
    non-zero gains, a mix of valid and invalid streams; invalid streams
    pass their state through bit for bit."""
    _celt_check(tuple(t.to(dev) for t in kc.celt_postfilter_random_inputs(
        streams, streams=streams, channels=channels)))


@pytest.mark.parametrize("wire", ["f32", "i16"])
@pytest.mark.parametrize("channels", [2, 1])
def test_celt_postfilter_kernel_on_the_fixture_path(dev, wire, channels):
    """The decoder's next round over 40 ragged fixture lanes (postfilter
    and transient frames, a mono clip in stereo lanes), with its carried
    state after three rounds."""
    _celt_check(kc.celt_fixture_inputs(40, dev, channels=channels, wire=wire))


@pytest.mark.parametrize("channels", [2, 1])
@pytest.mark.parametrize("streams", [5, 37, 300])
def test_celt_postfilter_kernel_schedule_draws_and_first_design(dev, streams, channels):
    """Frames the comb's step widths turn on (``kc.celt_postfilter_schedule_inputs``:
    the postfilter off, turning on with zero sets at period 15 beside a long
    active one, turning off, every set active, periods 15 and 1024 side by
    side, zero gains at random; invalid streams): within the bound of the
    plain version and of the first design (``tools/first_designs``), the
    comb's output (the new history) equal to the plain version's, invalid
    streams passed through."""
    from soundkit_tpu_torch.tools import first_designs as fd

    inputs = tuple(t.to(dev) for t in kc.celt_postfilter_schedule_inputs(
        70 + streams, streams=streams, channels=channels))
    _celt_check(inputs)
    got, want = kc.celt_postfilter_pair(inputs)[0](), kc.celt_postfilter_pair(inputs)[1]()
    assert torch.equal(got[2], want[2])
    kc.compare("celt_postfilter", lambda: got, lambda: fd.celt_postfilter(*inputs))


def test_celt_step_holds_its_bound_with_tf32_on(dev):
    """A caller that turns TF32 on does not move the step's IMDCT
    products off IEEE float32 (they run under ``ieee_fp32``): the step on
    the card (the products, then K11) holds K11's bound against the plain
    step on the CPU, and the caller's settings are back afterwards."""
    import numpy as np

    from soundkit_tpu_torch.ops import celt_batch as cb

    rng = np.random.default_rng(3)
    B, C = 64, 2
    full, comb, valid, ola, hist, emph = kc.celt_postfilter_random_inputs(4, streams=B, channels=C)
    freq = torch.from_numpy((rng.standard_normal((B, C, 960)) * 400).astype(np.float32))
    sflag = torch.from_numpy((rng.random(B) < 0.3).astype(np.int32))
    args = (freq, sflag, comb, valid, ola, hist, emph)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        got = cb.celt_synth_step(*(t.to(dev) for t in args))
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
    kc.compare("celt_postfilter", lambda: tuple(t.cpu() for t in got),
               lambda: cb.celt_synth_step_plain(*args))


def test_celt_decoder_launches_k11_once_a_round(dev):
    """The CELT decoder on the card writes its rounds into one collect
    tensor with one K11 launch a round, and its collect and carried state
    equal the CPU plain path's within K11's bound."""
    from soundkit_tpu_torch.models.opus_batch import BatchedCeltDecoder
    from soundkit_tpu_torch.ops import celt_postfilter
    from soundkit_tpu_torch.tools import opus_fixtures

    outs = []
    for device in ("cuda", "cpu"):
        model = BatchedCeltDecoder(12, 2, device=device)
        for i, data in enumerate(opus_fixtures.lane_raw(opus_fixtures.load_clips(), 12, 9)):
            model.push(i, data)
        before = celt_postfilter.celt_postfilter.launches
        pcm, _ = model.decode_ready(device_out=True)
        assert celt_postfilter.celt_postfilter.launches - before == (9 if device == "cuda" else 0)
        outs.append((pcm.cpu(), model._ola.cpu(), model._hist.cpu(), model._emph.cpu()))
    kc.compare("celt_postfilter", lambda: outs[0], lambda: outs[1])


def test_celt_postfilter_refuses_a_strided_input_on_the_card(dev):
    """A non-contiguous view of the right shape and an aligned base is
    refused on the card, with no launch counted."""
    from soundkit_tpu_torch.ops import celt_postfilter

    inputs = [t.to(dev) for t in kc.celt_postfilter_random_inputs(2, streams=4, channels=2)]
    hist = inputs[4]
    inputs[4] = torch.cat([hist, hist[..., :4]], dim=-1)[..., :hist.shape[-1]]
    assert inputs[4].data_ptr() % 16 == 0 and not inputs[4].is_contiguous()
    before = celt_postfilter.celt_postfilter.launches
    with pytest.raises(ValueError, match="non-contiguous"):
        celt_postfilter.celt_postfilter(*inputs)
    assert celt_postfilter.celt_postfilter.launches == before


@pytest.mark.parametrize("channels", [2, 1])
@pytest.mark.parametrize("bw", [0, 1, 2])
@pytest.mark.parametrize("streams", [1, 37, 300])
def test_silk_synth_kernel_random_inputs(dev, streams, bw, channels):
    """Seeded frames at each bandwidth: lags over the whole range and at
    both ends, voiced and unvoiced rows, with and without lead-in, stable
    LPC; at C = 1 every side row zero; invalid lanes and lane 0 all zero.
    Bit-exact, the output line and the new tail."""
    kc.compare("silk_synth", *kc.silk_synth_random_case(dev, 40 + streams, bw, streams=streams,
                                                        channels=channels))


@pytest.mark.parametrize("bw", [0, 1, 2])
def test_silk_synth_kernel_on_the_fixture_path(dev, bw):
    """The SILK decoder's next round over 40 ragged lanes of the voice
    fixtures, with its carried state after three rounds."""
    kc.compare("silk_synth", *kc.silk_synth_pair(bw, kc.silk_fixture_inputs(40, dev, bw=bw)))


def test_silk_synth_kernel_all_zero_and_wild_rows(dev):
    """Rows of zeros (a gain of 0: rescale / g is not finite) and rows
    with lags outside the streams' range neither fault nor disturb the
    rows beside them; the kernel equals the plain version on every
    finite value."""
    inputs = [t.clone() for t in kc.silk_synth_random_inputs(5, 2, streams=24)]
    inputs[4][3:9] = 1            # voiced
    inputs[1][3:6] = 0            # zero gains
    inputs[5][6:9] = torch.tensor([0, 1, -9, 999], dtype=torch.int32)
    inputs = tuple(t.to(dev) for t in inputs)
    got = [t.cpu() for t in ss.silk_synth(2, *inputs)]
    torch.cuda.synchronize()
    want = [t.cpu() for t in ss.silk_synth_plain(2, *inputs)]
    for g, w in zip(got, want):
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))
        assert torch.isfinite(g[9:]).all() and torch.isfinite(g[:3]).all()


@pytest.mark.parametrize("bw", [0, 1, 2])
@pytest.mark.parametrize("streams", [3, 37, 300])
def test_silk_synth_kernel_schedule_draws_and_first_design(dev, streams, bw):
    """Rounds whose pairs of warps hold rows with and without lead-in side
    by side (none, all, every second, at random), voiced rows four in five,
    lags 3, 16 and 288 beside drawn ones and gains apart in every subframe
    (``kc.silk_synth_schedule_inputs``): bit-exact against the plain version
    and against the first design (``tools/first_designs``)."""
    from soundkit_tpu_torch.tools import first_designs as fd

    inputs = tuple(t.to(dev) for t in kc.silk_synth_schedule_inputs(60 + streams, bw,
                                                                    streams=streams))
    kernel, plain = kc.silk_synth_pair(bw, inputs)
    kc.compare("silk_synth", kernel, plain)
    for got, first in zip(kernel(), fd.silk_synth(bw, *inputs)):
        assert torch.equal(got, first)


@pytest.mark.parametrize("bw", [0, 1, 2])
def test_silk_synth_kernel_equals_its_first_design_on_random_rounds(dev, bw):
    from soundkit_tpu_torch.tools import first_designs as fd

    inputs = tuple(t.to(dev) for t in kc.silk_synth_random_inputs(70 + bw, bw, streams=45))
    for got, first in zip(ss.silk_synth(bw, *inputs), fd.silk_synth(bw, *inputs)):
        assert torch.equal(got, first)


def test_silk_round_holds_its_bound_with_tf32_on(dev):
    """A caller that turns TF32 on does not move the round's resample
    products off IEEE float32 (they run under ``ieee_fp32``): the round
    on the card holds 1e-5 against the plain round on the CPU, and the
    caller's settings are back afterwards."""
    from soundkit_tpu_torch.ops import silk_batch as sb

    args = kc.silk_round_random_args(6, 2, B=64)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        got = sb.silk_round(2, True, *(t.to(dev) for t in args))
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
    kc.compare("silk_round", lambda: tuple(t.cpu() for t in got),
               lambda: sb.silk_round(2, True, *args))


def test_silk_and_hybrid_decoders_on_the_card(dev):
    """The SILK decoder (NB, MB and WB lanes: three K12 launches a round)
    and the hybrid decoder (one K12 and one K11 launch a round) on the card
    against the CPU plain path: lengths identical, PCM >= 100 dB a lane."""
    import numpy as np

    from soundkit_tpu_torch.models.opus_batch import BatchedHybridDecoder, BatchedSilkDeviceDecoder
    from soundkit_tpu_torch.ops import celt_postfilter
    from soundkit_tpu_torch.tools import opus_fixtures

    voice = {c.name: c for c in opus_fixtures.load_clips(names=opus_fixtures.VOICE_CLIPS)}
    for cls, names, per_round in (
            (BatchedSilkDeviceDecoder, ("silk_nb", "silk_mb", "silk_wb", "silk_wb_stereo"), 3),
            (BatchedHybridDecoder, ("hybrid_swb", "hybrid_fb"), 1)):
        clips = [voice[n] for n in names]
        outs = []
        for device in ("cuda", "cpu"):
            model = cls(12, 2, device=device)
            for b in range(12):
                for frame, bw, coded in opus_fixtures.lane_frames(clips, b, 10):
                    model.push_packet(b, frame, bw, coded)
            k12, k11 = ss.silk_synth.launches, celt_postfilter.celt_postfilter.launches
            pcm, lens = model.decode_ready(device_out=True)
            if device == "cuda":
                rounds = 16 if cls is BatchedHybridDecoder else 10  # two chunks of 8
                assert ss.silk_synth.launches - k12 == per_round * rounds
                assert celt_postfilter.celt_postfilter.launches - k11 == \
                    (rounds if cls is BatchedHybridDecoder else 0)
            outs.append((pcm.cpu().numpy().astype(np.float64), lens))
        (g, gl), (c, cl) = outs
        np.testing.assert_array_equal(gl, cl)
        for b in range(12):
            sig, err = (c[:, b] ** 2).sum(), ((g[:, b] - c[:, b]) ** 2).sum()
            assert sig > 0 and 10 * np.log10(sig / max(err, 1e-300)) >= 100, (cls, b)


def test_silk_synth_refuses_a_strided_input_on_the_card(dev):
    inputs = [t.to(dev) for t in kc.silk_synth_random_inputs(2, 2, streams=4)]
    hist = inputs[8]
    inputs[8] = torch.cat([hist, hist[..., :2]], dim=-1)[..., :hist.shape[-1]]
    assert not inputs[8].is_contiguous()
    before = ss.silk_synth.launches
    with pytest.raises(ValueError, match="non-contiguous"):
        ss.silk_synth(2, *inputs)
    assert ss.silk_synth.launches == before


VORBIS_TOPOLOGIES = [(256, 2048), (512, 4096), (256, 256), (64, 8192), (128, 1024)]


@pytest.mark.parametrize("channels", [2, 1])
@pytest.mark.parametrize("n0,n1", VORBIS_TOPOLOGIES)
@pytest.mark.parametrize("streams", [1, 37, 300])
def test_vorbis_overlap_kernel_random_inputs(dev, streams, n0, n1, channels):
    """Seeded rounds: every (previous, current) block-size case, random
    window flags, invalid lanes, a random lap. Bit-exact, the PCM and the
    new lap."""
    kc.compare("vorbis_overlap", *kc.vorbis_overlap_random_case(
        dev, 50 + streams, streams=streams, channels=channels, n0=n0, n1=n1))


def test_vorbis_overlap_kernel_on_the_fixture_path(dev):
    """The Vorbis decoder's next round over 40 ragged stereo fixture
    lanes, with its lap after three rounds."""
    kc.compare("vorbis_overlap", *kc.vorbis_overlap_pair(kc.vorbis_fixture_inputs(40, dev)))


def test_vorbis_imdct_holds_the_bar_with_tf32_on(dev):
    """A caller that turns TF32 on does not move the Vorbis IMDCT off IEEE
    float32 (its products run under ``ieee_fp32``): the step on the card
    (the products, then K13) stays within 1e-6 of the largest value of
    the plain step on the CPU, lengths and flags equal, and the caller's
    settings are back afterwards."""
    import numpy as np

    from soundkit_tpu_torch.ops import vorbis_batch as vb

    rng = np.random.default_rng(5)
    B, C, n0, n1 = 64, 2, 256, 2048
    pcm1, pcm0, bank, flags, carry = kc.vorbis_overlap_random_inputs(6, B, C, n0, n1)
    n_flag, pf, nf, valid, cflag = flags
    spec = (rng.standard_normal((B, C, n1 // 2)) * 0.05).astype(np.float32)
    spec[n_flag.numpy() == 0, :, n0 // 2:] = 0.0
    primed = torch.from_numpy(rng.random(B) < 0.8)
    args = (torch.from_numpy(spec), n_flag, pf, nf, valid.bool(), primed, carry, cflag)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        got = vb.vorbis_synth_step(*(t.to(dev) for t in args), n0=n0, n1=n1)
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
    ref = vb.vorbis_synth_step_plain(*args, n0=n0, n1=n1)
    for i in (0, 2):
        scale = ref[i].abs().max().item()
        assert (got[i].cpu() - ref[i]).abs().max().item() <= 1e-6 * scale
    assert torch.equal(got[1].cpu(), ref[1]) and torch.equal(got[3].cpu(), ref[3])


def test_vorbis_decoder_launches_k13_once_a_round(dev):
    """The Vorbis decoder on the card launches K13 once a round, and its
    rounds and lap equal the CPU plain path's within 1e-6 of their largest
    value (the IMDCT products are summed in another order on the card),
    lengths identical."""
    from soundkit_tpu_torch.models.vorbis_batch import BatchedVorbisDecoder
    from soundkit_tpu_torch.ops import vorbis_overlap
    from soundkit_tpu_torch.tools import vorbis_fixtures as vf

    outs = []
    for device in ("cuda", "cpu"):
        model = BatchedVorbisDecoder(12, device=device)
        for i, data in enumerate(vf.lane_streams(vf.load_clips(names=vf.STEREO), 12, 2)):
            model.push(i, data)
        n = max(model.lane_ready(i) for i in range(12))
        before = vorbis_overlap.vorbis_overlap.launches
        pcm, lens = model.decode_batches(n, device_out=True)
        assert vorbis_overlap.vorbis_overlap.launches - before == (n if device == "cuda" else 0)
        outs.append((torch.stack(pcm).cpu(), lens, model._carry.cpu()))
    (g, gl, gc), (c, cl, cc) = outs
    assert (gl == cl).all()
    for a, b in ((g, c), (gc, cc)):
        assert (a - b).abs().max().item() <= 1e-6 * b.abs().max().item()


def test_vorbis_overlap_refuses_a_misaligned_input_on_the_card(dev):
    """A view that starts off a 16-byte boundary is refused on the card,
    with no launch counted."""
    from soundkit_tpu_torch.ops import vorbis_overlap

    inputs = [t.to(dev) for t in kc.vorbis_overlap_random_inputs(3, 4, 2, 256, 2048)]
    inputs[4] = torch.empty(4 * 2 * 1024 + 1, device=dev)[1:].view(4, 2, 1024)
    before = vorbis_overlap.vorbis_overlap.launches
    with pytest.raises(ValueError, match="16-byte"):
        vorbis_overlap.vorbis_overlap(*inputs)
    assert vorbis_overlap.vorbis_overlap.launches == before


@pytest.mark.parametrize("channels", [2, 1])
@pytest.mark.parametrize("bits", [16, 24])
def test_flac_analyze_kernel_random_inputs(dev, bits, channels):
    """Seeded rows of every kind (correlated, independent and equal
    channels, low-passed and white noise, a few LSB) at 4096 samples:
    plan rows identical."""
    x = kc.flac_analyze_inputs(60 + bits + channels, 37, 4096, bits, channels).to(dev)
    kc.compare("flac_analyze", *kc.flac_analyze_pair(x, 4096, bits, channels))


@pytest.mark.parametrize("bits", [16, 24])
def test_flac_analyze_kernel_edge_rows(dev, bits):
    """Silence, constant blocks, full-scale noise, +-max alternating with
    R = -L (a side channel of bits + 1), 16-sample blocks, n_valid < N
    with junk past it and a block longer than a tile, stereo and mono:
    plan rows identical. A failed build or launch fails the test."""
    for name, x, n_valid, channels in kc.flac_analyze_edge_cases(bits):
        try:
            kc.compare("flac_analyze", *kc.flac_analyze_pair(x.to(dev), n_valid, bits, channels))
        except kc.KernelMismatch as e:
            raise kc.KernelMismatch(f"{name}: {e}") from None


@pytest.mark.parametrize("rows", [1, 131, 133, 10240])
def test_flac_analyze_kernel_row_counts(dev, rows):
    """K14's persistent grid walks rows in strides of its size: row
    counts below it, around a multiple of it and far above it give the
    plan rows of the plain version."""
    x = kc.flac_analyze_inputs(rows, rows, 4096, 16).to(dev)
    kc.compare("flac_analyze", *kc.flac_analyze_pair(x, 4096, 16))


def test_flac_analyze_kernel_window_follows_n_valid(dev):
    """Three calls back to back with n_valid 4096, 1000, 4096: each
    builds the window of its own n_valid (a window kept from the call
    before would move the plans)."""
    x = kc.flac_analyze_inputs(11, 40, 4096, 16).to(dev)
    for n_valid in (4096, 1000, 4096):
        kc.compare("flac_analyze", *kc.flac_analyze_pair(x, n_valid, 16))


@pytest.mark.parametrize("bits", [16, 24])
def test_flac_analyze_kernel_longest_block(dev, bits):
    """One row of 65535 samples, the longest block FLAC declares: 16
    tiles, the window built again for each and pass C predicting again."""
    x = kc.flac_analyze_inputs(bits, 1, 65535, bits).to(dev)
    kc.compare("flac_analyze", *kc.flac_analyze_pair(x, 65535, bits))


@pytest.mark.parametrize("channels", [2, 1])
def test_flac_analyze_kernel_full_scale_24_bits(dev, channels):
    """A 24-bit int32 wire at +-(2^23 - 1): a thread's 32-bit sums of
    |d_4| come near 2^32, and a warp's go past it (the halves summed
    apart)."""
    x = kc.flac_analyze_full_scale(5, 6, 4096, 24, channels).to(dev)
    kc.compare("flac_analyze", *kc.flac_analyze_pair(x, 4096, 24, channels))


@pytest.mark.parametrize("bits", [16, 24])
def test_flac_analyze_plain_on_the_card_equals_the_cpu(dev, bits):
    """The plain version gives the same plan rows on the card as on the
    CPU (every float64 operation rounded alone, divisions as tensors), on
    the edge rows: the pure tone of the multi-tile rows moves with any
    rounding difference."""
    for name, x, n_valid, channels in kc.flac_analyze_edge_cases(bits):
        card = kc.flac_analyze_pair(x.to(dev), n_valid, bits, channels)[1]()
        cpu = kc.flac_analyze_pair(x, n_valid, bits, channels)[1]()
        assert torch.equal(card.cpu(), cpu), name


def test_flac_analyze_refuses_samples_beyond_24_bits(dev):
    """An int32 wire holding a sample outside 24 bits raises before the
    launch (the kernel's differences are 32-bit); the extremes of 24 bits
    pass."""
    from soundkit_tpu_torch.ops import flac_analyze

    x = torch.zeros((2, 2, 64), dtype=torch.int32, device=dev)
    x[0, 0, 5], x[1, 1, 7] = (1 << 23) - 1, -(1 << 23)
    flac_analyze.flac_analyze(x, 64, 24)
    before = flac_analyze.flac_analyze.launches
    for v in (1 << 23, -(1 << 23) - 1):
        y = x.clone()
        y[1, 0, 9] = v
        with pytest.raises(ValueError, match="24-bit"):
            flac_analyze.flac_analyze(y, 64, 24)
    assert flac_analyze.flac_analyze.launches == before


def test_flac_encoder_on_the_card_equals_the_cpu(dev):
    """1024 lanes of the stereo16 fixture's PCM (each lane rotated by its
    own offset, 0.5 s) through the encoder on the card and on the CPU, in
    two pushes with encode_pending after each, then finish_all: the
    streams are byte-identical, and K14 launched once a device call."""
    from soundkit_tpu_torch.models.flac_encode_batch import BatchedFlacEncoder
    from soundkit_tpu_torch.ops import flac_analyze
    from soundkit_tpu_torch.tools import flac_fixtures as ff

    pcm = ff.clip_pcm(ff.load_clips()[0], dev)
    lanes = ff.rotated_lanes([pcm], 1024, 22050)
    streams = []
    for device in ("cuda", "cpu"):
        enc = BatchedFlacEncoder(1024, 44100, 2, 16, device=device)
        before = flac_analyze.flac_analyze.launches
        for lo, hi in ((0, 10000), (10000, None)):
            for i, x in enumerate(lanes):
                enc.push(i, x[:, lo:hi])
            enc.encode_pending()
        streams.append(enc.finish_all())
        if device == "cuda":
            assert flac_analyze.flac_analyze.launches - before == 3  # two pending, one tail
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# the resampler (K15) and the phase vocoder (K16, K17)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("in_rate,out_rate", kc.RESAMPLE_PAIRS)
def test_polyphase_fir_kernel_every_rate_pair(dev, in_rate, out_rate):
    """K15 against its plain version (cuDNN's convolution in IEEE float32)
    one-shot and from a carried history, and chunked equal to one-shot
    bit for bit, at every supported rate pair and the pitch shift's."""
    from soundkit_tpu_torch.ops import resample as rs

    kc.compare("polyphase_fir", *kc.resample_case(in_rate, out_rate, 5, dev, seed=1))
    kc.compare("polyphase_fir", *kc.resample_case(in_rate, out_rate, 3, dev, seed=2,
                                                  stateful=True))
    M = rs.design_polyphase(in_rate, out_rate)[3]
    chunked, one = kc.resample_chunked(kc.resample_rows(3, 3, 12 * M, dev), in_rate, out_rate,
                                       4 * M)
    assert torch.equal(chunked, one)


def test_polyphase_fir_kernel_on_the_transcode_chunk(dev):
    """K15 at the transcode chain's shape (44.1 -> 8 kHz, 28,224 samples a
    row, a carried history), 64 rows; chunked over three such chunks equals
    one-shot; one launch a call."""
    from soundkit_tpu_torch.ops import resample as rs

    x = kc.resample_rows(4, 64, 3 * 28224, dev)
    hist = kc.resample_rows(5, 64, 255, dev)
    kc.compare("polyphase_fir", *kc.resample_pair(x[:, :28224].contiguous(), 44100, 8000, hist))
    before = rs.polyphase_fir.launches
    chunked, one = kc.resample_chunked(x, 44100, 8000, 28224)
    assert torch.equal(chunked, one) and rs.polyphase_fir.launches - before == 4


@pytest.mark.parametrize("in_rate,out_rate,B,n", [
    (44100, 8000, 1, 28224 + 3 * 441 + 17),  # B = 1, the last tile past the row
    (16000, 8000, 3, 2 * 8192 + 5),          # L = 1: a super-cycle of 8
    (48000, 8000, 2, 77777),                 # L = 1, M = 6: Mq 48, pitched
    (96000, 8000, 2, 12 * 2048 + 11),        # L = 1, M = 12: Mq 96, pitched
    (8000, 44100, 2, 4003),                  # L = 441: groups in four chunks
    (8000, 88200, 1, 1001),                  # L = 441, M = 40
    (3000, 2000, 2, 165375),                 # the pitch shift's row, seven tiles
    (3000, 2000, 5, 3),                      # fewer outputs than a super-cycle
])
def test_polyphase_fir_kernel_at_tile_edges(dev, in_rate, out_rate, B, n):
    """K15 where its tiles end: n_out not a multiple of a tile or of a
    super-cycle, L = 1 (super-cycles of 8) and L = 441 (groups split over
    blocks), B = 1; one-shot and from a carried history, against the plain
    version and, bit for bit, against its first design."""
    from soundkit_tpu_torch.ops import resample as rs
    from soundkit_tpu_torch.tools import first_designs as fd

    x = kc.resample_rows(n % 89, B, n, dev)
    for hist in (None, kc.resample_rows(5, B, rs.SINC_LEN - 1, dev)):
        kernel, plain = kc.resample_pair(x, in_rate, out_rate, hist)
        kc.compare("polyphase_fir", kernel, plain)
        L, M = rs.design_polyphase(in_rate, out_rate)[2:4]
        assert torch.equal(kernel(), fd.polyphase_fir(x, hist, in_rate, out_rate,
                                                      rs.out_len(n, L, M)))


@pytest.mark.parametrize("in_rate,out_rate", [(44100, 8000), (3000, 2000), (8000, 44100)])
def test_polyphase_fir_kernel_bits_do_not_depend_on_the_plan(dev, in_rate, out_rate):
    """Every launch shape K15 can take (1, 2, 4 and 8 super-cycles a thread,
    one slab or several, the bank read through L1 or staged in shared
    memory) gives the same bits: each output sums its taps in one order
    whatever the tile."""
    from soundkit_tpu_torch.ops import resample as rs

    x = kc.resample_rows(2, 3, 40000, dev)
    hist = kc.resample_rows(3, 3, rs.SINC_LEN - 1, dev)
    L, M = rs.design_polyphase(in_rate, out_rate)[2:4]
    n_out = rs.out_len(40000, L, M)
    ref = rs.polyphase_fir(x, hist, in_rate, out_rate, n_out)
    for rc in rs.CYCLES_PER_THREAD:
        for slabs in (1, 2):
            for ws in (0, 1):
                try:
                    plan = rs.k15_plan(in_rate, out_rate, n_out, rc=rc, slabs=slabs, ws=ws)
                except ValueError:  # more warps or shared memory than a block may have
                    continue
                got = rs.launch_k15(x, hist, in_rate, out_rate, n_out, plan)
                assert torch.equal(got, ref), plan


def test_plain_resampler_is_ieee_under_the_guard_with_tf32_on(dev):
    """cuDNN's TF32 on, the plain resampler (a conv1d under ``ieee_fp32``)
    still agrees within 1e-5 with the same polyphase bank evaluated in
    float64 by numpy on a unit-scale signal (TF32's 10-bit mantissa would
    miss by 1e-4 or more); the caller's flag comes back."""
    import numpy as np

    from soundkit_tpu_torch.ops import resample as rs

    x = kc.resample_rows(6, 4, 4410, dev)
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        got = rs.polyphase_fir_plain(x, None, 44100, 48000, rs.out_len(4410, 160, 147))
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    taps, offs, L, M = rs.design_polyphase(44100, 48000)
    x64 = x.double().cpu().numpy()
    n_out = got.shape[1]
    xp = np.pad(x64, ((0, 0), (255, n_out // L * M + M + 256)))
    ref = np.empty((4, n_out))
    for k in range(n_out):
        c, p = divmod(k, L)
        ref[:, k] = xp[:, c * M + offs[p]: c * M + offs[p] + 256] @ taps[p].astype(np.float64)
    assert np.abs(got.cpu().numpy() - ref).max() < 1e-5


#: K16's cases: (B, T, hop, target, F)
OLA_CASES = [
    (5, 9, 960, 3000, 2048), (3, 40, 960, 36000, 2048), (2, 7, 333, 1500, 2048),
    (4, 4, 2048, 9000, 2048),   # the line ends inside the crop
    (2, 9, 962, 3001, 2048),    # V = 2
    (3, 5, 2500, 9000, 2048),   # hop > F: samples no frame covers
    (2, 9, 960, 4000, 512),     # F = 512, gaps too
    (1, 9, 960, 5001, 2048),    # one lane, a target no multiple of a vector or a block
    (3, 6, 960, 7777, 2048),    # the line ends inside the crop, a ragged last vector
    (2, 12, 256, 2999, 2048),   # eight covering frames: two load groups
]


@pytest.mark.parametrize("B,T,hop,target,F", OLA_CASES)
def test_overlap_add_kernel_bit_exact(dev, B, T, hop, target, F):
    frames, win = kc.stretch_ola_inputs(B + T, B, T, dev, F=F)
    kc.compare("overlap_add", *kc.stretch_ola_pair(frames, win, hop, target))


@pytest.mark.parametrize("offset", [1, 2])
def test_overlap_add_kernel_on_frames_off_16_byte_boundaries(dev, offset):
    """Frames 4 or 8 bytes past a 16-byte boundary take V = 1 or 2 and
    keep the bits."""
    from soundkit_tpu_torch.ops import stretch_ola

    B, T, F = 3, 9, 2048
    src, win = kc.stretch_ola_inputs(7, B, T, dev)
    frames = torch.empty(B * T * F + offset, device=dev)[offset:].view(B, T, F)
    frames.copy_(src)
    assert stretch_ola.k16_vector(F, 960, F // 2, frames.data_ptr(), win.data_ptr()) == offset
    kc.compare("overlap_add", *kc.stretch_ola_pair(frames, win, 960, 5001))


@pytest.mark.parametrize("B,T,hop,target,F", OLA_CASES)
def test_overlap_add_kernel_equals_its_first_design(dev, B, T, hop, target, F):
    """K16 bit for bit its first design (``tools/first_designs``)."""
    from soundkit_tpu_torch.ops import stretch_ola
    from soundkit_tpu_torch.tools import first_designs as fd

    frames, win = kc.stretch_ola_inputs(B + T + 1, B, T, dev, F=F)
    assert torch.equal(stretch_ola.overlap_add(frames, win, hop, target),
                       fd.overlap_add(frames, win, hop, target))


def test_overlap_add_kernel_under_every_vector_width(dev):
    """K16's V = 4, 2 and 1 instances on one input (V = 4 allowed): the
    same bits as the plain version."""
    from soundkit_tpu_torch.ops import stretch_ola

    frames, win = kc.stretch_ola_inputs(11, 3, 9, dev)
    ref = stretch_ola.overlap_add_plain(frames, win, 960, 5001)
    for V in (4, 2, 1):
        assert torch.equal(stretch_ola.launch_k16(frames, win, 960, 5001, V), ref), V


@pytest.mark.parametrize("span", [50.0, 1e5, 1e6])
def test_phase_lock_kernel_nearest_identical(dev, span):
    """K17's nearest identical to the plain version's, ties and flat runs
    included, and its spectrum within 3 ulps of the rotation's argument,
    with synthesis phases up to ``span`` rad."""
    kc.phase_lock_check(*kc.phase_lock_inputs(int(span) % 97, 37, 1025, dev, span=span))
    kc.phase_lock_check(*kc.phase_lock_inputs(3, 5, 33, dev, span=span))


@pytest.mark.parametrize("K", [1, 31, 32, 33, 1025, 1280])
def test_phase_lock_kernel_against_float64_and_its_first_design(dev, K):
    """K17 at row widths around a step of 32 bins and at its largest:
    nearest identical to the plain version's and to its first design's, the
    spectrum within 2^-21 of the magnitude of float64 cos / sin of the
    float32 argument (``phase_lock_check``), up to 1.05e6 rad; rows with
    NaN magnitudes take the plain version's nearest too."""
    from soundkit_tpu_torch.ops import phase_lock
    from soundkit_tpu_torch.tools import first_designs as fd

    mag, phase, syn = kc.phase_lock_inputs(K, 19, K, dev, span=1.05e6)
    r = kc.phase_lock_check(mag, phase, syn)
    assert r["max_f64_err"] <= kc.PHASE_LOCK_F64_BOUND
    _, near = phase_lock.phase_lock(mag, phase, syn, with_nearest=True)
    assert torch.equal(near, fd.phase_lock(mag, phase, syn, with_nearest=True)[1])
    mag[3, ::7] = float("nan")
    _, near = phase_lock.phase_lock(mag, phase, syn, with_nearest=True)
    assert torch.equal(near, phase_lock.nearest_peak_plain(mag))


def test_pitch_shift_on_the_card_matches_the_cpu(dev):
    """The device pitch shift (K17, K16, K15 on the card) against the same
    function on the CPU: 60 dB (the FFTs and the angle differ by ulps, and
    the synthesis phase's running sum magnifies them)."""
    import numpy as np

    from soundkit_tpu_torch.ops import phase_lock, stretch_ola
    from soundkit_tpu_torch.ops import resample as rs
    from soundkit_tpu_torch.ops import stretch as st

    t = np.arange(16000) / 16000
    x = np.stack([np.sin(2 * np.pi * (200 + 50 * b) * t) * 0.5 for b in range(3)])
    x = torch.from_numpy(x.astype(np.float32))
    before = (rs.polyphase_fir.launches, stretch_ola.overlap_add.launches,
              phase_lock.phase_lock.launches)
    got = st.pitch_shift_batch_device(x.to(dev), 1.25, 1.5).cpu().numpy()
    after = (rs.polyphase_fir.launches, stretch_ola.overlap_add.launches,
             phase_lock.phase_lock.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    ref = st.pitch_shift_batch_device(x, 1.25, 1.5).numpy()
    snr = 10 * np.log10(np.mean(ref ** 2) / np.mean((ref - got) ** 2))
    assert got.shape == ref.shape and snr > 60, snr


# ---------------------------------------------------------------------------
# the streaming pipeline: K3, K6, K7 and K10 at B = 1
# ---------------------------------------------------------------------------

STREAM_CASES = ["g711_decode/1", "g711_decode/127", "g711_decode/313",
                f"g711_decode/{kc.STREAM_SEND}",
                *(f"g722_scan/{w}/{n}" for w in ("decode", "encode") for n in kc.STREAM_LENGTHS),
                *(f"g722_scan/{w}/{kc.send_codes(encode=w == 'encode')}"
                  for w in ("decode", "encode")),
                *(f"g726_scan/{b}/{w}/{n}" for b in (2, 3, 4, 5) for w in ("decode", "encode")
                  for n in kc.STREAM_LENGTHS),
                *(f"g726_scan/{b}/{w}/{kc.send_codes(b, w == 'encode')}" for b in (2, 3, 4, 5)
                  for w in ("decode", "encode")),
                "mp3_synth/stereo44", "mp3_synth/mono16"]
_STREAM_CASES = {}  # built once, on the first case's device


@pytest.mark.parametrize("case", STREAM_CASES)
def test_kernels_at_the_streaming_shapes(dev, case):
    """One lane, the chunk lengths of the streaming codecs and one
    pipeline send (K6 and K7 against the segmented plain scan), unmasked
    and from a carried state; K10 on one granule of a stereo and a mono
    stream (the lane ``valid [1, 0]``) with the streaming decoder's
    state."""
    if not _STREAM_CASES:
        _STREAM_CASES.update(kc.stream_cases(dev))
    kernel, plain = _STREAM_CASES[case]
    kc.compare(case.split("/")[0], kernel, plain)


def test_streaming_launch_rules(dev):
    """K7's encode refuses an odd sample count; K10 refuses a
    ``[1, 2, 1024]`` FIFO off a 16-byte boundary."""
    rules = kc.stream_rules(dev)
    assert set(rules) == {"g722_odd_samples", "mp3_fifo_alignment"}


def test_g722_encoder_carry_on_the_card(dev):
    """The encoder's odd-sample carry never hands K7 an odd count, and
    its codes equal the CPU encoder's."""
    from soundkit_tpu_torch.codecs.g722 import G722Encoder
    from soundkit_tpu_torch.ops import g722

    rng = np.random.default_rng(3)
    pcm = (rng.standard_normal(4001) * 3000).astype(np.int16)
    card, host = G722Encoder("cuda"), G722Encoder("cpu")
    before = g722.g722_encode_scan.launches
    pos, got, want = 0, b"", b""
    for n in (1, 1, 127, 313, 0, 3, 2000):
        got += card.encode_i16(pcm[pos: pos + n])
        want += host.encode_i16(pcm[pos: pos + n])
        pos += n
    got += card.flush()
    want += host.flush()
    assert got == want and g722.g722_encode_scan.launches > before


@pytest.mark.parametrize("codec", ["g711_mulaw", "g711_alaw", "g722", "g726_16", "g726_24",
                                   "g726_32", "g726_40"])
def test_streaming_telephony_decoders_on_the_card(dev, codec):
    """Each streaming decoder on the card equals its CPU plain path bit
    for bit over chunks of 1, 127 and 313 bytes."""
    from soundkit_tpu_torch.tools import telephony_fixtures as tfx

    data = tfx.load_clips(codec)[0][:900]
    card, host = (kc.telephony_codec(codec, False, d) for d in ("cuda", "cpu"))
    pos = 0
    for n in (1, 127, 313, 1, 313):
        np.testing.assert_array_equal(card.decode_i16(data[pos: pos + n]),
                                      host.decode_i16(data[pos: pos + n]))
        pos += n


@pytest.mark.parametrize("codec", ["g711_mulaw", "g711_alaw", "g722", "g726_16", "g726_24",
                                   "g726_32", "g726_40"])
def test_telephony_first_send_on_the_card(dev, codec):
    """A stream that the streaming encoder makes on the card in chunks of
    one send: its first chunk's codes against a plain encode of the same
    PCM, and the streaming decoder's PCM for its first send against a
    plain decode, at the pipeline's lengths."""
    from soundkit_tpu_torch.tools import telephony_fixtures as tfx

    pcm = np.concatenate(tfx.pcm_clips(16000 if codec == "g722" else 8000))[:20000]
    data = kc.telephony_stream(codec, pcm, dev)
    assert len(data) >= kc.STREAM_SEND
    for name, (card, plain) in kc.telephony_send_pairs(codec, pcm, data, dev).items():
        kc.compare(name.split("/")[0], card, plain)


def test_streaming_mp3_decoder_on_the_card(dev):
    """K10 once a granule, chained on the stream; PCM within 1 LSB and
    the state within K10's bound of the CPU plain path."""
    from soundkit_tpu_torch.codecs.mp3 import Mp3Decoder, f32_to_i16
    from soundkit_tpu_torch.ops import mp3_synth
    from soundkit_tpu_torch.tools import mp3_fixtures

    for clip in mp3_fixtures.load_clips():
        data = clip.stream()
        card, host = Mp3Decoder(device="cuda"), Mp3Decoder(device="cpu")
        before = mp3_synth.mp3_granule_packed.launches
        got = np.concatenate([card.decode_f32(data[i:i + 4096]) for i in range(0, len(data), 4096)])
        want = np.concatenate([host.decode_f32(data[i:i + 4096])
                               for i in range(0, len(data), 4096)])
        assert mp3_synth.mp3_granule_packed.launches - before == sum(clip.granules)
        assert got.shape == want.shape
        err = np.abs(f32_to_i16(got).astype(np.int32) - f32_to_i16(want))
        assert err.max() <= 1
        kc.compare("mp3_synth", lambda: tuple(t.cpu() for t in card._state),
                   lambda: tuple(host._state))


@pytest.mark.parametrize("fmt", ["wav", "flac", "mp3", "aac", "g722"])
def test_stream_decoder_on_the_card_equals_the_cpu(dev, fmt):
    """The pipeline on the card gives the CPU pipeline's outputs (MP3
    within 1 LSB), no error on a clean stream."""
    from pathlib import Path

    from soundkit_tpu_torch.core.audio_types import AudioData, PcmData
    from soundkit_tpu_torch.core.wav import generate_wav_buffer
    from soundkit_tpu_torch.pipeline.decode_pipeline import G722Adapter, StreamDecoder
    from soundkit_tpu_torch.pipeline.output_options import DecodeOptions
    from soundkit_tpu_torch.tools import telephony_fixtures as tfx

    data_dir = Path(__file__).resolve().parent / "data" / "torch_port"
    pcm = (np.sin(np.arange(20000) * 0.02) * 9000).astype(np.int16)
    data = {"wav": lambda: generate_wav_buffer(PcmData.i16([pcm, pcm[::-1]]), 22050),
            "flac": lambda: (data_dir / "flac" / "stereo24.flac").read_bytes(),
            "mp3": lambda: (data_dir / "mp3" / "stereo48.mp3").read_bytes(),
            "aac": lambda: (data_dir / "drums.aac").read_bytes()[:30000],
            "g722": lambda: tfx.load_clips("g722")[2][:3000]}[fmt]()

    def run(device):
        core = StreamDecoder(DecodeOptions(), G722Adapter(device), device) if fmt == "g722" \
            else StreamDecoder(device=device)
        outs = []
        for i in range(0, len(data), 4096):
            outs += core.process(data[i:i + 4096])
        outs += core.process(b"")
        assert outs and all(isinstance(o, AudioData) for o in outs)
        return outs

    card, host = run("cuda"), run("cpu")
    assert [(o.sampling_rate, o.channel_count, o.bits_per_sample, len(o.data)) for o in card] == \
        [(o.sampling_rate, o.channel_count, o.bits_per_sample, len(o.data)) for o in host]
    a = np.frombuffer(b"".join(o.data for o in card), np.uint8)
    b = np.frombuffer(b"".join(o.data for o in host), np.uint8)
    if fmt == "mp3":
        a, b = a.view("<i2").astype(np.int32), b.view("<i2")
        assert np.abs(a - b).max() <= 1
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["aifc_ulaw", "aifc_alaw"])
def test_aiff_c_g711_on_the_card_equals_the_cpu(dev, name):
    """An AIFF-C file's µ-law / A-law through K3 on the card (one [1, N]
    launch at its end, through the pipeline's detection) gives the CPU's
    bytes, and its clip's part the JAX package's decode in the index."""
    from soundkit_tpu_torch.core.audio_types import AudioData
    from soundkit_tpu_torch.ops import companding
    from soundkit_tpu_torch.pipeline.decode_pipeline import StreamDecoder
    from soundkit_tpu_torch.tools import host_codec_fixtures as hcf

    data, seconds = hcf.long_stream(name, 30.0)

    def run(device):
        core = StreamDecoder(device=device)
        outs = [o for i in range(0, len(data), 4096) for o in core.process(data[i:i + 4096])]
        outs += core.process(b"")
        assert outs and all(isinstance(o, AudioData) for o in outs)
        return b"".join(o.data for o in outs)

    before = companding.g711_decode.launches
    card = run("cuda")
    assert companding.g711_decode.launches - before == 1
    host = run("cpu")
    assert card == host and len(card) == round(seconds * 8000) * 2 * 2
    e = hcf.load_index()[name]
    assert hcf.sha256(card[:e["pcm_bytes"]]) == e["sha256"]
