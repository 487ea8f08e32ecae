"""Each CUDA kernel against its plain PyTorch version on the card, with
the inputs and bounds of ``soundkit_tpu_torch.tools.kernel_check``
(the ones ``chip_smoke.py`` applies at B = 1024), at small shapes.

Needs an NVIDIA GPU (sm_90a) and nvcc; skipped without one. It imports
no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
"""
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


@pytest.mark.parametrize("B,T,hop,target", [(5, 9, 960, 3000), (3, 40, 960, 36000),
                                            (2, 7, 333, 1500), (4, 4, 2048, 9000)])
def test_overlap_add_kernel_bit_exact(dev, B, T, hop, target):
    frames, win = kc.stretch_ola_inputs(B + T, B, T, dev)
    kc.compare("overlap_add", *kc.stretch_ola_pair(frames, win, hop, target))


@pytest.mark.parametrize("span", [50.0, 1e5, 1e6])
def test_phase_lock_kernel_nearest_identical(dev, span):
    """K17's nearest identical to the plain version's, ties and flat runs
    included, and its spectrum within 3 ulps of the rotation's argument,
    with synthesis phases up to ``span`` rad."""
    kc.phase_lock_check(*kc.phase_lock_inputs(int(span) % 97, 37, 1025, dev, span=span))
    kc.phase_lock_check(*kc.phase_lock_inputs(3, 5, 33, dev, span=span))


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
