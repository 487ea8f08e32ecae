"""In-repo multichannel AAC-LC fixtures for the port's tests and
``chip_smoke.py``, committed under ``tests/data/torch_port/aac_mc/``.

Five ADTS clips of about 1 s at 48 kHz, one for each channel
configuration 3-7 (:data:`CLIPS`), made by the JAX package's
FFmpeg-linked ``AacEncoder`` at 128 kbit/s a channel. Each input channel
carries a tone of its own, under noise bursts in its first 0.4 s, so that the encoder codes
perceptual noise substitution (PNS) bands; the LFE a 60 Hz tone. The
encoder writes configurations 4, 5 and 6 as the specification lists
them. Its 3- and 8-channel streams are outside it, so two clips are
spliced from others at the element boundaries the owned parser reports
(:func:`element_spans`, :func:`splice`):

- ``cfg3``: the SCE and CPE of the 4.0 stream, under configuration 3;
- ``cfg7``: the 7.1 stream (configuration 0, a program config element in
  its first access unit) without that unit, under configuration 7.

:data:`REFUSED` are the encoder's own streams outside the specification,
which both packages refuse: 2.1 (configuration 3 over CPE LFE), 6.1
(configuration 7 over CPE SCE SCE CPE SCE) and 7.1 with its PCE.
:data:`CONTAINERS` carry ``cfg6``'s access units in an MP4 (``m4a_51``,
``host_codec_fixtures.mux_mp4``) and a LOAS/LATM stream (``latm_51``,
``demux/latm.mux_loas``), built at run time (:func:`build`).

``index.json`` holds each clip's file, SHA-256, configuration, element
list, source and frames, the length and SHA-256 of the float32 PCM that
the JAX package's libavcodec decode gives for it, and the figures of the
PNS-aware comparison measured when the fixtures were made.
``reference_pcm.npz`` holds, for each clip, the int16 PCM of the JAX
package's own ``AacLcDecoder`` + ``AacLcSynth`` on its units in
libavcodec's channel order (``pcm_<clip>``), the PNS flags of each frame
and output channel (``pns_<clip>``: a band of type 13 in that channel's
element), and, for :data:`SMOKE`, libavcodec's float32 PCM
(``libavcodec_<clip>``), for ``chip_smoke.py``, where no JAX runs.

The clips are made on the test side (``tests/torch_port_helpers.py``;
needs the JAX package and its libavcodec), from the repository's root::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_helpers.py aac_mc
"""
from __future__ import annotations

import hashlib
import json
import math
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

FIXTURE_DIR = Path(__file__).resolve().parents[2] / "tests" / "data" / "torch_port" / "aac_mc"
#: the decodable clips and their channel configurations
CLIPS = {"cfg3": 3, "cfg4": 4, "cfg5": 5, "cfg6": 6, "cfg7": 7}
#: the encoder's streams that both packages refuse
REFUSED = ("enc_21", "enc_61", "enc_71_pce")
#: ``SMOKE``'s units in an MP4 and in a LOAS/LATM stream
CONTAINERS = ("m4a_51", "latm_51")
#: the 5.1 clip ``chip_smoke.py`` lengthens, its libavcodec PCM committed whole
SMOKE = "cfg6"
RATE = 48000
SR_INDEX = 3


def load_index(directory: Path = FIXTURE_DIR) -> Dict[str, dict]:
    return json.loads((directory / "index.json").read_text())


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def clip_bytes(name: str, directory: Path = FIXTURE_DIR) -> bytes:
    return (directory / load_index(directory)[name]["file"]).read_bytes()


def reference(name: str, what: str, directory: Path = FIXTURE_DIR) -> np.ndarray:
    """``reference_pcm.npz``'s ``<what>_<name>`` (``pcm``, ``pns`` or
    ``libavcodec``)."""
    with np.load(directory / "reference_pcm.npz") as z:
        return z[f"{what}_{name}"]


def asc(config: int, sr_index: int = SR_INDEX) -> bytes:
    """The two-byte AAC-LC AudioSpecificConfig of ``config``."""
    return bytes([(2 << 3) | (sr_index >> 1), ((sr_index & 1) << 7) | (config << 3)])


def adts(aus: Sequence[bytes], config: int, sr_index: int = SR_INDEX) -> bytes:
    """``aus`` as ADTS frames of channel configuration ``config``."""
    from soundkit_tpu_torch.codecs.encoders import adts_header

    return b"".join(adts_header(len(au), sr_index, config) + au for au in aus)


def units(name: str, directory: Path = FIXTURE_DIR) -> Tuple[bytes, List[bytes]]:
    """(AudioSpecificConfig, raw access units) of a clip, or of the clip a
    container case carries."""
    from soundkit_tpu_torch.codecs.aac_lc import AdtsStream

    st = AdtsStream()
    aus = st.push(clip_bytes(SMOKE if name in CONTAINERS else name, directory))
    return asc(st.channel_config, st.sr_index), aus


def build(name: str, aus: Sequence[bytes] = None) -> bytes:
    """The bytes of a clip, or of a container case (over ``aus``, the
    case's units by default)."""
    if name not in CONTAINERS:
        return clip_bytes(name) if aus is None else adts(aus, CLIPS[name])
    config, own = units(name)
    aus = own if aus is None else list(aus)
    from soundkit_tpu_torch.demux.latm import parse_audio_specific_config

    info = parse_audio_specific_config(config)
    if name == "m4a_51":
        from soundkit_tpu_torch.tools.host_codec_fixtures import mux_mp4

        return mux_mp4("aac", config, aus, info.sample_rate, info.channels, 1024)
    from soundkit_tpu_torch.demux.latm import mux_loas

    return mux_loas(aus, info)


def long_stream(name: str, seconds: float) -> Tuple[bytes, float]:
    """(bytes, seconds of audio): a clip or container case made at least
    ``seconds`` long, its units repeated in its own framing."""
    _, aus = units(name)
    longer = list(aus) * max(1, math.ceil(seconds * RATE / (1024 * len(aus))))
    return build(name, longer), len(longer) * 1024 / RATE


# ---------------------------------------------------------------------------
# splicing
# ---------------------------------------------------------------------------

def element_spans(au: bytes, sr_index: int = SR_INDEX) -> List[Tuple[str, int, int]]:
    """(kind, first bit, end bit) of each channel element of ``au`` (SCE,
    CPE, LFE), walked as ``AacLcDecoder.decode_au`` walks it; fill and
    data stream elements are skipped."""
    from soundkit_tpu_torch.codecs.aac_lc import AacError, AacLcDecoder, BitReader

    dec = AacLcDecoder(sr_index)
    br = BitReader(au)
    spans = []
    while br.bits_left >= 3:
        start = br.pos
        ide = br.get(3)
        if ide == 7:
            break
        if ide in (0, 3):
            br.get(4)
            dec._decode_ics(br, False, None)
            spans.append(("SCE" if ide == 0 else "LFE", start, br.pos))
        elif ide == 1:
            dec._decode_cpe(br)
            spans.append(("CPE", start, br.pos))
        elif ide == 4:
            dec._skip_dse(br)
        elif ide == 6:
            dec._skip_fil(br)
        else:
            raise AacError(f"element {ide} cannot be spliced")
    return spans


def splice(au: bytes, keep: Sequence[int], sr_index: int = SR_INDEX) -> bytes:
    """An access unit of ``au``'s channel elements ``keep`` (indices into
    :func:`element_spans`), in that order, then END, zero-padded to a
    byte."""
    bits = "".join(f"{b:08b}" for b in au)
    spans = element_spans(au, sr_index)
    out = "".join(bits[spans[i][1]:spans[i][2]] for i in keep) + "111"
    out += "0" * (-len(out) % 8)
    return int(out, 2).to_bytes(len(out) // 8, "big")


# ---------------------------------------------------------------------------
# the PNS-aware comparison
# ---------------------------------------------------------------------------

NOISE_BT = 13


def frame_channels(aus: Sequence[bytes], config: int, sr_index: int = SR_INDEX) -> list:
    """For each access unit, (ICS, M/S mask, partner ICS) of each output
    channel in libavcodec's order, the last two None outside a CPE."""
    from soundkit_tpu_torch.codecs.aac_layout import LIBAVCODEC_ORDER
    from soundkit_tpu_torch.codecs.aac_lc import AacLcDecoder

    dec = AacLcDecoder(sr_index)
    out = []
    for au in aus:
        row = []
        for el in dec.decode_au(au).elements:
            if el.kind == "CPE":
                row += [(el.ics[0], el.ms_mask, el.ics[1]), (el.ics[1], el.ms_mask, el.ics[0])]
            else:
                row.append((el.ics[0], None, None))
        out.append([row[i] for i in LIBAVCODEC_ORDER[config]])
    return out


def pns_flags(frames: list) -> np.ndarray:
    """[frames, channels] bool: a band of type 13 in that channel's ICS."""
    return np.array([[bool((ics.band_type == NOISE_BT).any()) for ics, _, _ in row]
                     for row in frames])


def _db(signal: float, noise: float) -> float:
    return float(10 * np.log10(signal / max(noise, 1e-300)))


def pns_free_snr(got: np.ndarray, ref: np.ndarray, pns: np.ndarray) -> dict:
    """SNR of ``got`` against ``ref`` ([channels, samples], aligned at
    sample 0, 1024 a frame) over the PNS-free channel-frames: those whose
    frame and predecessor carry no PNS band in that channel (``pns`` from
    :func:`pns_flags`), where two decoders' noise generators cannot differ.
    ``snr_db`` a channel (None where it has no such frame), ``worst_db``
    the least of any such channel-frame with signal, and their count a
    channel."""
    snr, counts, worst = [], [], math.inf
    for c in range(ref.shape[0]):
        sig = err = 0.0
        count = 0
        for f in range(pns.shape[0]):
            if pns[f, c] or (f and pns[f - 1, c]):
                continue
            a, b = got[c, 1024 * f:1024 * (f + 1)], ref[c, 1024 * f:1024 * (f + 1)]
            s, e = float(np.sum(b * b)), float(np.sum((a - b) ** 2))
            sig, err, count = sig + s, err + e, count + 1
            if s > 0:
                worst = min(worst, _db(s, e))
        snr.append(_db(sig, err) if sig > 0 else None)
        counts.append(count)
    return {"snr_db": snr, "worst_db": worst if sum(counts) else None, "channel_frames": counts}


def pns_fault_db(width: int) -> float:
    """The owned decoder's PNS band energy against the specification's, in
    dB, for a band of ``width`` lines: the owned synthesis gives each line
    the band's scale, 2^((nrg - 100) / 4), where ISO/IEC 14496-3 (4.6.13)
    gives the whole band the energy 2^(nrg / 2): ``width`` * 2^-50."""
    return float(10 * np.log10(width) - 500 * np.log10(2))


def pns_band_energies(got: np.ndarray, ref: np.ndarray, frames: list) -> np.ndarray:
    """[bands, 3]: for each PNS band of a long frame between long frames
    (its channel's frames before and after also ONLY_LONG), the energy of
    ``got`` in that band against ``ref``'s in dB, from a forward MDCT of
    each output with the frame's own window (the 2048 samples from the
    frame's start: a frame's block ends a frame later), the band's
    width, and 1 where no TNS filter, M/S or intensity touches the band
    (there the energy is the PNS scale's alone)."""
    from soundkit_tpu_torch.ops.aac_dsp import half_window, imdct_matrix

    mdct = imdct_matrix(1024).T
    rows = []
    for c in range(ref.shape[0]):
        for f in range(1, len(frames) - 1):
            ics, ms, partner = frames[f][c]
            if any(frames[g][c][0].window_sequence != 0 for g in (f - 1, f, f + 1)):
                continue
            if not (ics.band_type == NOISE_BT).any() or ref.shape[1] < 1024 * f + 2048:
                continue
            w = np.concatenate([half_window(frames[f - 1][c][0].window_shape, 1024),
                                half_window(ics.window_shape, 1024)[::-1]])
            seg = slice(1024 * f, 1024 * f + 2048)
            xg, xr = mdct @ (w * got[c, seg]), mdct @ (w * ref[c, seg])
            tns = any(t.order for t in ics.tns[0]) if ics.tns else False
            for s in np.flatnonzero(ics.band_type[0] == NOISE_BT):
                lo, hi = int(ics.swb_offset[s]), int(ics.swb_offset[s + 1])
                coupled = partner is not None and (
                    (ms is not None and s < ms.shape[1] and ms[0, s])
                    or (s < partner.band_type.shape[1] and partner.band_type[0, s] in (14, 15)))
                rows.append((_db(float(np.sum(xg[lo:hi] ** 2)), float(np.sum(xr[lo:hi] ** 2))),
                             hi - lo, float(not (tns or coupled))))
    return np.array(rows, dtype=np.float64).reshape(-1, 3)


def pns_energy_summary(bands: np.ndarray) -> dict:
    """Figures of :func:`pns_band_energies`: the bands, the median and
    range of the energy against the reference, and, over the bands no
    TNS, M/S or intensity touches, the largest distance from
    :func:`pns_fault_db`."""
    if not len(bands):
        return {"bands": 0}
    clean = bands[bands[:, 2] == 1]
    dev = np.abs(clean[:, 0] - [pns_fault_db(int(n)) for n in clean[:, 1]])
    return {"bands": int(len(bands)), "db_median": float(np.median(bands[:, 0])),
            "db_min": float(bands[:, 0].min()), "db_max": float(bands[:, 0].max()),
            "clean_bands": int(len(clean)),
            "clean_off_fault_db_max": float(dev.max()) if len(dev) else None}
