"""The committed AAC fixtures (tests/data/torch_port) and the port's
standalone host parser."""
import numpy as np

from soundkit_tpu.codecs.aac_lc_native import (
    NativeAacParser,
    _v4_views,
    prepare_frame_batch_grouped,
    prepare_v4_batch_packed,
)
from soundkit_tpu_torch.native import AacHostParser
from soundkit_tpu_torch.tools.aac_fixtures import CLIPS, lane_streams, load_clips

from torch_port_helpers import SR_INDEX_48K, clip_aus, host_parser, picked_aus


def test_fixture_aus_are_v4_clean_and_cover_the_decode_paths():
    """Every AU alone fits the v4 wire, and the pool carries EIGHT_SHORT
    frames, M/S, intensity, PNS bands and TNS filters."""
    parser = host_parser()
    totals = dict(short=0, ms=0, intensity=0, pns=0, tns=0)
    for name, aus in zip(CLIPS, clip_aus()):
        assert len(aus) >= 172, name  # 1024 / 6 distinct start offsets
        for au in aus:
            assert not prepare_v4_batch_packed(parser, [au])[2], name
        buf, _, overflow = prepare_v4_batch_packed(parser, aus)
        assert not overflow
        v = _v4_views(buf, len(aus))
        B = len(aus)
        assert v["chan_valid"].reshape(B, 2).all(), name  # stereo
        totals["short"] += int((v["seq"].reshape(B, 2)[:, 0] == 2).sum())
        totals["ms"] += int((v["msis_ms"].reshape(B, -1) != 0).any(1).sum())
        totals["intensity"] += int((v["msis_sign"].reshape(B, -1) != 0).any(1).sum())
        totals["pns"] += int((((v["pns"] >> 12) & 1023) > 0).sum())
        reg = v["regions"].reshape(B, 2, 8, 3)
        totals["tns"] += int(((v["order"].reshape(B, 2, 8) > 0) & (reg[..., 1] > reg[..., 0])).sum())
    assert totals["short"] >= 20 and totals["ms"] >= 100 and totals["intensity"] >= 10
    assert totals["pns"] >= 100 and totals["tns"] >= 3, totals


def test_host_parser_matches_native_parser():
    """The standalone parser build gives the JAX package's parser's
    v4 wire byte for byte, and the same full wire. Both parsers are
    fresh: a full-wire parse advances a parser's PNS noise state."""
    aus = picked_aus()
    ours, theirs = AacHostParser(SR_INDEX_48K), NativeAacParser(SR_INDEX_48K)
    a, _, _ = prepare_v4_batch_packed(ours, aus)
    b, _, _ = prepare_v4_batch_packed(theirs, aus)
    np.testing.assert_array_equal(a, b)
    lane_sr = [SR_INDEX_48K] * len(aus)
    fa = prepare_frame_batch_grouped({SR_INDEX_48K: ours}, lane_sr, aus)
    fb = prepare_frame_batch_grouped({SR_INDEX_48K: theirs}, lane_sr, aus)
    for field in ("quant", "scale", "ms_mask", "int_factor", "perm", "filt_id", "lpc",
                  "seq", "shape", "chan_valid"):
        np.testing.assert_array_equal(getattr(fa, field), getattr(fb, field), err_msg=field)


def test_smoke_lanes_are_distinct_streams():
    lanes = lane_streams(load_clips(), 1024, 2)
    assert len(set(lanes)) == 1024
