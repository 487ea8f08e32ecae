"""The shared kernel-vs-plain harness (``soundkit_tpu_torch.tools.kernel_check``)
on the CPU, where both sides of every case run the plain version: each
case builds and agrees, and a result beyond its bound is refused."""
import numpy as np
import pytest
import torch

from soundkit_tpu_torch.tools import kernel_check as kc
from torch_port_helpers import picked_aus, v4_wire

CPU = torch.device("cpu")


@pytest.mark.parametrize("name,make", [
    ("spectral_decode", lambda: kc.spectral_case(torch.from_numpy(v4_wire(picked_aus())), 42)),
    ("spectral_decode", lambda: kc.spectral_random_case(5, CPU, seed=3)),
    ("tns_filter", lambda: kc.tns_case(3, 2, CPU, seed=2, kind="regions")),
    ("tns_filter", lambda: kc.tns_case(3, 2, CPU, seed=2, kind="overlap")),
    *[("tns_filter", lambda kind=kind: kc.tns_case(2, 2, CPU, seed=4, kind=kind))
      for kind in ("long", "short8", "adjacent", "regap", "order0", "tail")],
    ("imdct_window", lambda: kc.imdct_case(6, False, CPU, seed=1)),
    ("imdct_window", lambda: kc.imdct_case(24, True, CPU, seed=2)),
    ("dequant_imdct_window", lambda: kc.dequant_imdct_case(6, CPU, seed=3)),
    ("g711_decode", lambda: kc.g711_case(9, 64, CPU, seed=4)),
    ("g726_scan", lambda: kc.g726_case(9, 40, 3, False, CPU, seed=5)),
    ("g726_scan", lambda: kc.g726_case(9, 40, 5, True, CPU, seed=6)),
    ("g726_scan", lambda: kc.g726_case(9, 40, 2, False, CPU, seed=5, carried=True)),
    ("g726_scan", lambda: kc.g726_case(9, 40, 4, True, CPU, seed=6, carried=True)),
    ("g722_scan", lambda: kc.g722_case(9, 40, False, CPU, seed=7)),
    ("g722_scan", lambda: kc.g722_case(9, 40, True, CPU, seed=8)),
    ("g722_scan", lambda: kc.g722_case(9, 40, False, CPU, seed=7, carried=True)),
    ("g722_scan", lambda: kc.g722_case(9, 40, True, CPU, seed=8, carried=True)),
    ("flac_rice_plane", lambda: kc.flac_rice_case(kc.flac_fixture_wire(5, 2, CPU))),
    ("flac_rice_plane", lambda: kc.flac_rice_random_case(CPU, seed=3)),
    ("flac_frame", lambda: kc.flac_lpc_case(kc.flac_fixture_wire(5, 1, CPU))),
    ("flac_frame", lambda: kc.flac_lpc_random_case(CPU, seed=4)),
    ("mp3_synth", lambda: kc.mp3_synth_random_case(CPU, seed=5)),
    ("mp3_synth", lambda: kc.mp3_synth_random_case(CPU, seed=6, streams=5, channels=1)),
    ("mp3_synth", lambda: kc.mp3_synth_pair(*kc.mp3_fixture_inputs(6, CPU))),
    ("celt_postfilter", lambda: kc.celt_postfilter_random_case(CPU, seed=5)),
    ("celt_postfilter", lambda: kc.celt_postfilter_random_case(CPU, seed=6, streams=5, channels=1)),
    ("celt_postfilter", lambda: kc.celt_postfilter_pair(kc.celt_fixture_inputs(6, CPU))),
    ("celt_postfilter", lambda: kc.celt_postfilter_pair(kc.celt_fixture_inputs(5, CPU, wire="i16"))),
    *[("silk_synth", lambda bw=bw: kc.silk_synth_random_case(CPU, 7, bw, streams=5))
      for bw in (0, 1, 2)],
    ("silk_synth", lambda: kc.silk_synth_random_case(CPU, 8, 2, streams=4, channels=1)),
    ("silk_synth", lambda: kc.silk_synth_pair(2, kc.silk_fixture_inputs(6, CPU, warm=2))),
    ("polyphase_fir", lambda: kc.resample_case(44100, 8000, 3, CPU, seed=1)),
    ("polyphase_fir", lambda: kc.resample_case(8000, 44100, 2, CPU, seed=2, stateful=True)),
    ("polyphase_fir", lambda: kc.resample_case(3000, 2000, 2, CPU, seed=3, cycles=40)),
    ("overlap_add", lambda: kc.stretch_ola_pair(*kc.stretch_ola_inputs(4, 2, 7, CPU), 960, 5000)),
])
def test_cases_agree_on_cpu(name, make):
    kernel, plain = make()
    res = kc.compare(name, kernel, plain)
    assert res == {"max_abs_err": 0.0, "rel_err": 0.0}
    out = plain()
    assert torch.count_nonzero(out[0] if isinstance(out, tuple) else out) > 0


def test_carried_g726_case_starts_from_a_scanned_state():
    """A carried K6 case starts from the state a first scan left, not the
    initial one: predictor taps and step sizes have moved."""
    for encode in (False, True):
        _, plain = kc.g726_case(4, 8, 4, encode, CPU, seed=1, carried=True)
        state = next(c.cell_contents for n, c in zip(plain.__code__.co_freevars, plain.__closure__)
                     if n == "state")
        init = kc.adpcm.g726_init_state(4, "cpu")
        views = kc.adpcm.G726_LAYOUT.views(state)
        assert (views.b != 0).any() and (views.yl != init[:, 0]).all()


@pytest.mark.parametrize("encode", [False, True])
def test_carried_g722_case_starts_from_a_scanned_state(encode):
    """A carried K7 case starts from the state a first scan left: the QMF
    line is filled, both bands' zero taps and step sizes have moved."""
    _, plain = kc.g722_case(4, 8, encode, CPU, seed=1, carried=True)
    state = next(c.cell_contents for n, c in zip(plain.__code__.co_freevars, plain.__closure__)
                 if n == "state")
    init = kc.g722.G722_LAYOUT.views(kc.g722.g722_init_state(4, "cpu"))
    views = kc.g722.G722_LAYOUT.views(state)
    assert (views.x != 0).any(dim=1).all() and (views.b != 0).any()
    assert (views.det != init.det).all() and (views.nb != 0).all()


@pytest.mark.parametrize("name,bump", [
    ("spectral_decode", 1),
    ("imdct_window", 1e-3),
    ("tns_filter", float("nan")),
    ("celt_postfilter", 1e-3),
    ("silk_synth", 1e-6),
    ("silk_round", 1e-3),
])
def test_compare_refuses_a_result_beyond_its_bound(name, bump):
    ref = torch.arange(1, 9, dtype=torch.int32 if name == "spectral_decode" else torch.float32)
    bad = ref.clone()
    bad[3] += bump
    with pytest.raises(kc.KernelMismatch, match=name):
        kc.compare(name, lambda: bad, lambda: ref)


def test_flac_fixture_wire_feeds_both_flac_cases():
    """The wire has the sixteen tensors of ``flac_frames_segs`` in order,
    K8's case reads the first nine and K9's the rest over K8's plane."""
    wire = kc.flac_fixture_wire(6, 2, CPU)
    assert len(wire) == 16 and wire[0].shape[0] == 12 and wire[15].dtype == torch.bool
    assert wire[15].sum() == 12 and int(wire[4].max()) == 144
    plane = kc.flac_rice_case(wire)[1]()
    assert plane.shape == (12, 2, 4608)
    out = kc.flac_lpc_case(wire)[1]()
    assert out.shape == plane.shape and not torch.equal(out, plane)


def test_flac_wild_inputs_differ_only_in_what_no_walk_emits():
    """``wild`` adds Rice parameters past 31 and negative bit offsets (K8),
    shifts and wasted bits past 63 (K9), and changes no other field."""
    tame, wild = kc.flac_rice_random_inputs(4), kc.flac_rice_random_inputs(4, wild=True)
    assert int(tame[3].max()) <= 31 and int(tame[2].min()) >= 0
    assert int(wild[3].max()) >= 32 and int(wild[2].min()) < 0
    assert all(torch.equal(a, b) for i, (a, b) in enumerate(zip(tame, wild)) if i not in (2, 3))
    tame, wild = kc.flac_lpc_random_inputs(4), kc.flac_lpc_random_inputs(4, wild=True)
    assert max(int(tame[3].max()), int(tame[4].max())) <= 31
    assert int(wild[3].max()) >= 64 and int(wild[4].max()) >= 64
    assert all(torch.equal(a, b) for i, (a, b) in enumerate(zip(tame, wild)) if i not in (3, 4))


@pytest.mark.parametrize("name", ["flac_rice_plane", "flac_frame"])
def test_compare_refuses_an_off_by_one_in_a_flac_result(name):
    ref = torch.arange(-8, 8, dtype=torch.int32).reshape(2, 2, 4)
    bad = ref.clone()
    bad[1, 0, 2] += 1
    with pytest.raises(kc.KernelMismatch, match=name):
        kc.compare(name, lambda: bad, lambda: ref)
    assert kc.compare(name, lambda: ref, lambda: ref)["max_abs_err"] == 0.0


@pytest.mark.parametrize("name,element", [
    ("g711_decode", None), ("g726_scan", 0), ("g726_scan", 1), ("g722_scan", 1),
])
def test_compare_refuses_an_off_by_one_in_a_telephony_result(name, element):
    """Bit-exact bound: one unit off in the output or in the carried
    state (element 1 of a scan's result) is refused."""
    ref = (torch.arange(-8, 8, dtype=torch.int16), torch.arange(24, dtype=torch.int32)[None])
    if element is None:  # K3 returns one tensor
        ref = ref[0]
        bad = ref.clone()
        bad[3] += 1
    else:
        bad = tuple(t.clone() for t in ref)
        bad[element][..., 3] += 1
    with pytest.raises(kc.KernelMismatch, match=name):
        kc.compare(name, lambda: bad, lambda: ref)
    assert kc.compare(name, lambda: ref, lambda: ref)["max_abs_err"] == 0.0


@pytest.mark.parametrize("bits,encode", [(None, False), (None, True), (2, False), (3, True),
                                         (5, False), (4, True)])
def test_segmented_scan_pair_equals_the_scan_in_order(bits, encode):
    """The segmented plain side (segments of 16 codes, the last short)
    gives the plain scan's output over all 100 codes in order, and the
    states at the segment ends that the scan in order passes through."""
    rng = np.random.default_rng(4)
    per = 2 if bits is None and encode else 1
    if bits is None:
        xs = kc._g722_inputs(1, 100, encode, rng)
        state = kc.g722.g722_init_state(1, CPU)
    else:
        xs = kc._g726_inputs(1, 100, bits, encode, rng)
        state = kc.adpcm.g726_init_state(1, CPU)
    scan, plain = kc._scan_pair(bits, encode)
    kernel, segmented = kc.segmented_scan_pair(scan, plain, xs, state, per, seg=16)
    assert kc.compare("g726_scan", kernel, segmented) == {"max_abs_err": 0.0, "rel_err": 0.0}
    out, ends = segmented()
    want = plain(xs, state, None)
    assert torch.equal(out, want[0]) and ends.shape[0] == 7 and torch.equal(ends[-1:], want[1])
    assert torch.equal(ends[2:3], plain(xs[:, :48 * per], state, None)[1])


@pytest.mark.parametrize("fault", ["output", "boundary", "final"])
def test_segmented_scan_pair_refuses_a_fault(fault):
    """A code off in the output, a state off at one segment's start, or
    a final state off: each is refused."""
    rng = np.random.default_rng(5)
    xs = kc._g726_inputs(1, 70, 4, False, rng)
    state = kc.adpcm.g726_init_state(1, CPU)
    scan, plain = kc._scan_pair(4, False)

    def faulty(x, s):
        out, new = scan(x, s)
        if (fault == "boundary" and x.shape[1] == 32) or (fault == "final" and x.shape[1] == 70):
            new = new.clone()
            new[0, 3] += 1
        if fault == "output" and x.shape[1] == 70:
            out = out.clone()
            out[0, 40] += 1
        return out, new

    kernel, segmented = kc.segmented_scan_pair(faulty, plain, xs, state, seg=16)
    with pytest.raises(kc.KernelMismatch, match="g726_scan"):
        kc.compare("g726_scan", kernel, segmented)


def test_stream_cases_agree_on_cpu(monkeypatch):
    """Every B = 1 case of the streaming path, at short lengths, a 64-byte
    send and 16-code segments: named by kernel, scan, way and codes, each
    scan from a carried state, and each agreeing."""
    monkeypatch.setattr(kc, "STREAM_LENGTHS", (1, 7))
    monkeypatch.setattr(kc, "STREAM_SEND", 64)
    monkeypatch.setattr(kc, "SEGMENT", 16)
    monkeypatch.setattr(kc, "CARRY_STEPS", 8)
    cases = kc.stream_cases(CPU)
    assert {"g722_scan/decode/64", "g722_scan/encode/64", "g726_scan/2/decode/256",
            "g726_scan/3/decode/170", "g726_scan/5/encode/64", "g711_decode/64",
            "mp3_synth/mono16"} <= set(cases)
    assert len(cases) == 3 + 2 * 5 * 3 + 2
    for name, (kernel, plain) in cases.items():
        assert kc.compare(name.split("/")[0], kernel, plain)["max_abs_err"] == 0.0 or (
            name.startswith("mp3_synth"))
    start = kc.carried_state(3, True, CPU, 5)
    assert not torch.equal(start, kc.adpcm.g726_init_state(1, CPU))


@pytest.mark.parametrize("codec", ["g711_mulaw", "g711_alaw", "g722", "g726_16", "g726_24",
                                   "g726_32", "g726_40"])
def test_telephony_send_pairs_agree_on_cpu(monkeypatch, codec):
    """At a 64-byte send and 16-code segments: the first send of a stream
    that the streaming encoder made, encoded and decoded, against plain
    scans of the same PCM and codes."""
    from soundkit_tpu_torch.tools import telephony_fixtures as tfx

    monkeypatch.setattr(kc, "STREAM_SEND", 64)
    monkeypatch.setattr(kc, "SEGMENT", 16)
    pcm = np.concatenate(tfx.pcm_clips(16000 if codec == "g722" else 8000))[:600]
    data = kc.telephony_stream(codec, pcm, CPU)
    pairs = kc.telephony_send_pairs(codec, pcm, data, CPU)
    assert len(pairs) == (1 if codec.startswith("g711") else 2)
    for name, (card, plain) in pairs.items():
        assert kc.compare(name.split("/")[0], card, plain)["max_abs_err"] == 0.0
        assert card()[0].numel() > 0


def test_mp3_fixture_inputs_are_the_decoders_next_granule():
    """K10's path case is the decoder's next wire row: the plain K10 on
    it gives the decoder's PCM and state for that round."""
    from soundkit_tpu_torch.models.mp3_batch_model import BatchedMp3Decoder
    from soundkit_tpu_torch.tools import mp3_fixtures

    granules, overlap, fifo = kc.mp3_fixture_inputs(7, CPU, warm=2)
    _, plain = kc.mp3_synth_pair(granules, overlap, fifo)
    pcm, ov, ff = plain()
    model = BatchedMp3Decoder(7, device="cpu")
    for i, data in enumerate(mp3_fixtures.lane_streams(mp3_fixtures.load_clips(), 7)):
        model.push(i, data)
    want = model.decode_batches(3)[2]
    assert torch.equal(pcm[0].reshape(7, 2, 576), torch.from_numpy(want))
    assert torch.equal(ov.reshape(7, 2, 32, 18), model._overlap)
    assert torch.equal(ff.reshape(7, 2, 1024), model._fifo)


def test_mp3_synth_work_counts_the_path_each_subband_takes():
    """Wire bytes (a lane's lines where it or, under M/S, its valid
    partner takes them), the prologue's operations (requantize, M/S,
    active butterflies with the boundaries clamped to 0..31) and the
    synthesis of the path each subband takes, on valid lanes."""
    import numpy as np

    zeros = np.zeros((3, 2, 576), np.int16)
    fields = dict(quant=zeros, expq=zeros, ms=np.array([1, 1, 0]),
                  valid=np.array([[1, 1], [1, 0], [0, 1]]), bt=np.array([[0, 2], [2, 0], [1, 3]]),
                  mixed=np.array([[0, 0], [1, 0], [0, 0]]), nal=np.array([[31, 0], [1, 31], [5, 40]]))
    rows = torch.from_numpy(kc.mp3_wire_rows([fields]))
    nbytes, flops = kc.mp3_synth_work(rows, torch.zeros((3, 2, 32, 18)))
    valid_lanes, line_lanes, ms_lanes = 4, 5, 4
    assert nbytes == 3 * 3 + 6 * (576 * 4 + 2 * 1600 * 4) + valid_lanes * 9 + line_lanes * 2304 \
        + 3452 * 4
    long_sb, short_sb = 32 + 2 + 32, 32 + 30
    per_lane = 576 + 2 * 18 * 64 * 32 + 2 * 576 * 16
    assert flops == line_lanes * 576 * 4 + ms_lanes * 576 * 2 + (31 + 0 + 1 + 31) * 48 \
        + long_sb * (2 * 36 * 18 + 36) + short_sb * (2 * 3 * 12 * 6 + 60) + valid_lanes * per_lane


def test_celt_fixture_inputs_are_the_decoders_next_round():
    """K11's path case is the decoder's next round: the plain K11 on its
    IMDCT output gives the decoder's PCM and state for that round."""
    from soundkit_tpu_torch.models.opus_batch import BatchedCeltDecoder
    from soundkit_tpu_torch.tools import opus_fixtures

    inputs = kc.celt_fixture_inputs(6, CPU, warm=2)
    pcm, ola, hist, emph = kc.celt_postfilter_pair(inputs)[1]()
    model = BatchedCeltDecoder(6, 2, device="cpu")
    for i, data in enumerate(opus_fixtures.lane_raw(opus_fixtures.load_clips(), 6)):
        model.push(i, data)
    want, _ = model.decode_ready(max_packets=3, device_out=True)
    assert torch.equal(pcm, want[2])
    for got, state in ((ola, model._ola), (hist, model._hist), (emph, model._emph)):
        assert torch.equal(got, state)


def test_celt_random_inputs_cover_the_edges():
    """Every third stream's periods come from the edge set (15, 1022,
    1024 and the widths where a comb step changes), the gains carry all
    three tapsets and zero stages, and some streams are invalid."""
    from soundkit_tpu_torch.codecs.opus_tables import tables

    full, comb, valid, ola, hist, emph = kc.celt_postfilter_random_inputs(2, streams=60)
    periods = comb[:, [0, 1, 8, 9]]
    assert set(periods[::3].flatten().tolist()) <= set(kc.CELT_EDGE_PERIODS)
    assert {15.0, 1024.0} <= set(periods.flatten().tolist())
    assert int(periods.min()) >= 15 and int(periods.max()) <= 1024
    taps = torch.from_numpy(tables()["celt_postfilter_taps"].astype("float32"))
    stages = comb[:, [2, 5, 10, 13]].reshape(-1)
    ratios = (comb[:, [3, 6, 11, 14]].reshape(-1) / stages)[stages != 0]
    assert {round(float(r), 4) for r in ratios} == {round(float(t[1] / t[0]), 4) for t in taps}
    assert (stages == 0).any() and 0 < int(valid.sum()) < 60


def test_celt_work_counts_bytes_and_active_taps():
    """Bytes: the flag, a valid stream's comb row, each channel's line in
    and out, of its history only the part the comb taps or the new
    history reach; an invalid stream's state in and out and its zero PCM.
    Operations: the active taps of each stage, the overlap-add, the
    de-emphasis and the scale."""
    B, C = 3, 2
    full = torch.zeros((B, C, 1080))
    comb = torch.zeros((B, 16))
    comb[:, [0, 1, 8, 9]] = 100.0    # stream 0: the new history's 240 samples reach further
    comb[1, 0] = 700.0               # stream 1: stage A reaches 702 back,
    comb[1, 9] = 1500.0              # stage B (clamped to 1024) 1026 from sample 120
    comb[0, 2] = comb[0, 13] = 0.5   # stream 0: stage A's first tap and stage B's second
    comb[1, 5:8] = 0.1               # stream 1: stage A's second tap
    valid = torch.tensor([True, True, False])
    state = (torch.zeros((B, C, 120)), torch.zeros((B, C, 1200)), torch.zeros((B, C)))
    nbytes, flops = kc.celt_postfilter_work((full, comb, valid, *state))
    line = (120 + 1200 + 1) * 4
    valid_line = 1080 * 4 + (120 + 1) * 4 + 960 * 4 + line
    assert nbytes == B + 2 * 64 + C * (2 * valid_line + (240 + 906) * 4) \
        + C * (2 * line + 960 * 4)
    base = 120 + 960 * 3
    assert flops == C * ((120 * 10 + 840 * 9 + base) + (120 * 9 + base))


def test_silk_fixture_inputs_are_the_decoders_next_round():
    """K12's path case is the SILK decoder's next round: the plain
    synthesis of it equals the round's synthesis inside ``silk_round``
    (its output history after the decoder's round)."""
    from soundkit_tpu_torch.ops import silk_synth

    inputs = kc.silk_fixture_inputs(6, CPU, warm=2)
    assert inputs[0].shape == (6, 2, 320) and inputs[8].shape == (6, 2, 322)
    dst, tail = silk_synth.silk_synth_plain(2, *inputs)
    assert dst.shape == (6, 2, 642) and tail.shape == (6, 2, 16)
    assert torch.isfinite(dst).all() and dst.abs().max() > 0.01
    assert inputs[8].abs().max() > 0  # a carried history after two rounds


def test_silk_random_inputs_cover_the_edges():
    exc, gains, coef, hl, vo, lags, ltp, ltpscale, hist, tail = kc.silk_synth_random_inputs(
        2, 0, streams=60, channels=1)
    assert not exc[0].any() and not gains[0].any()        # lane 0 all zero
    assert not exc[:, 1].any() and not hl[:, 1].any()      # C = 1: the side rows zero
    live = gains[:, 0, 0] != 0
    assert (lags[live] == 16).any() and (lags[live] == 144).any()
    assert vo[live, 0].any() and (vo[live, 0] == 0).any() and hl[live, 0].any()
    assert (~live).sum() > 3


def test_silk_work_counts_rows_and_voiced_spans():
    inputs = list(kc.silk_synth_random_inputs(3, 2, streams=4))
    inputs[4][:] = 0
    nbytes, flops = kc.silk_synth_work(2, inputs)
    assert flops == 8 * 320 * 33
    assert nbytes == 8 * (320 * 4 + 16 + 128 + 8 + 16 + 80 + 4 + 322 * 4 + 64 + 642 * 4 + 64)
    inputs[4][0, 0] = 1
    inputs[3][0, 0] = 0
    inputs[5][0, 0] = torch.tensor([100, 100, 100, 100], dtype=torch.int32)
    _, flops1 = kc.silk_synth_work(2, inputs)
    # one voiced row: the LTP (11 a sample), the spans 102, 22, 0, 0 at 34 each, the
    # divisions, the scaled positions 80 + 160 + 240
    assert flops1 - flops == 320 * 11 + (102 + 22) * 34 + 8 + 80 + 160 + 240


def test_integer_issue_rate_is_hoppers_64_lanes_a_clock():
    """An H100 SM issues 64 32-bit integer operations a clock (NVIDIA's
    throughput table for compute capability 9.0), so K14's 7.5 G integer
    operations take 0.4484 ms at 1.98 GHz on 132 SMs, and bound it when
    they outweigh its bytes and float64 work."""
    assert kc.INT_ISSUE_RATE == 132 * 64 * 1.98e9
    b = kc.flac_analyze_bound({"bytes": 167_772_160, "fp64": 2e9, "int_ops": 7.5e9})
    assert b["int_ms"] == pytest.approx(0.448376, abs=1e-6)
    assert b["bound_ms"] == b["int_ms"] and b["bound_by"] == "operations"


def test_resample_chunked_equals_one_shot_on_cpu():
    for a, c in ((44100, 441 * 4), (8000, 80 * 7), (3000, 3 * 101)):
        b = {44100: 8000, 8000: 44100, 3000: 2000}[a]
        chunked, one = kc.resample_chunked(kc.resample_rows(a, 2, 3 * c, CPU), a, b, c)
        assert torch.equal(chunked, one)


def test_phase_lock_check_holds_nearest_and_the_spectrum(monkeypatch):
    mag, phase, syn = kc.phase_lock_inputs(5, 7, 1025, CPU)
    r = kc.phase_lock_check(mag, phase, syn)
    assert {k: r[k] for k in ("max_abs_err", "rel_err", "max_ulps")} == \
        {"max_abs_err": 0.0, "rel_err": 0.0, "max_ulps": 0.0}
    assert 0.0 < r["max_f64_err"] <= kc.PHASE_LOCK_F64_BOUND
    plain = kc.phase_lock.phase_lock_plain
    monkeypatch.setattr(kc.phase_lock, "phase_lock", lambda *a, **k: (
        lambda s, n: (s * (1 + 1e-5), n))(*plain(*a, **k)))
    with pytest.raises(kc.KernelMismatch, match="phase_lock: spectrum"):
        kc.phase_lock_check(mag, phase, syn)
    monkeypatch.setattr(kc.phase_lock, "phase_lock", lambda *a, **k: (
        lambda s, n: (s, torch.roll(n, 1, -1)))(*plain(*a, **k)))
    with pytest.raises(kc.KernelMismatch, match="nearest differs"):
        kc.phase_lock_check(mag, phase, syn)


def test_dsp_work_counts():
    """K15: 2 x 256 flops an output and the rows, history, output and bank
    bytes; K16: only the frame samples that cover the crop window J in
    [1024, 1024 + target), the window and the output; K17: 20 bytes a
    bin."""
    assert kc.resample_work(1024, 28224, 5120, 80, stateful=True) == (
        4 * (1024 * 28224 + 1024 * 5120 + 256 * 80 + 80 + 1024 * 255), 512 * 1024 * 5120)
    # hop 960, J < 166399: frame 0 from J = 1024, frame 1 from 1024, frames
    # 2-171 whole, frame 172 up to 166399, frame 173 too, none after
    assert kc.stretch_ola_work(1024, 348, 2048, 960, 165375) == \
        4 * (1024 * (1024 + 1984 + 170 * 2048 + 1279 + 319) + 2048 + 1024 * 165375)
    # hop 2500 > F (gaps) and a line that ends at 12048, past the crop's 10024
    assert kc.stretch_ola_work(2, 5, 2048, 2500, 9000) == \
        4 * (2 * (1024 + 3 * 2048 + 24) + 2048 + 2 * 9000)
    assert kc.phase_lock_work(1024 * 348, 1025) == 1024 * 348 * 1025 * 20
