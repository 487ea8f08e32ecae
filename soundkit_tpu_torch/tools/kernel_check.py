"""Each CUDA kernel of the port against its plain PyTorch version.

The inputs and the bounds that ``chip_smoke.py`` and
``tests/test_torch_cuda_kernels.py`` hold the kernels to, in one place.
Each ``*_case`` function builds seeded inputs on a CUDA device and
returns ``(kernel, plain)``, two callables without arguments that run
the kernel's wrapper and its plain version on the same tensors;
:func:`compare` runs both once and raises :class:`KernelMismatch`
beyond the bound. The bounds are on ``max|kernel - plain| / max|plain|``:

- K4 ``spectral_decode``: bit-exact;
- K5 ``tns_filter``: 1e-4 (a 20-tap all-pole recursion over 1024 lines);
- K1 ``imdct_window`` and K2 ``dequant_imdct_window``: 1e-5 (3xTF32
  with float32 sums; a plain TF32 product would land near 1e-3);
- K3 ``g711_decode``, K6 ``g726_scan`` and K7 ``g722_scan``: bit-exact,
  the output and, for the scans, the final state (integer paths);
- K8 ``flac_rice_plane`` and K9 ``flac_frame``: bit-exact (lossless);
- K10 ``mp3_synth`` (``mp3_granule_packed``): 1e-5, on the PCM of every
  chained granule and on the final overlap and FIFO (float32 FMAs in
  another order than the plain version's products and sums, ``powf``
  and ``exp2f`` against torch's ``pow`` and ``exp2``);
- K11 ``celt_postfilter``: 1e-5, on the PCM and on each carried state
  (the comb's products and sums round one by one in the plain version's
  order; the de-emphasis sums in another order than its [8, 8] product),
  and a stream with ``valid`` 0 passes its state through bit for bit
  (:func:`celt_invalid_passthrough`);
- K12 ``silk_synth``: bit-exact, the output line and the new LPC tail
  (every product and sum rounded alone in the plain version's order);
  the SILK round around it (``silk_round``: K12, the unmix and the
  resample products) 1e-5, the products summed by cuBLAS in another
  order than the CPU's;
- K13 ``vorbis_overlap``: bit-exact, the PCM and the new lap (every
  product and sum rounded alone in the plain version's order).
- K14 ``flac_analyze``: identical plan rows (the float64 autocorrelation
  sums run in another order than the plain version's; a plan could move
  only at a rounding tie of a coefficient or on a power of two of max|a|).
- K15 ``polyphase_fir``: 1e-5 (256 fused multiply-adds in the order q = 0
  .. 255 against cuDNN's float32 convolution over the embedded bank, in
  its own order); chunked against one-shot, bit-exact
  (:func:`resample_chunked`).
- K16 ``overlap_add``: bit-exact (every product and sum rounded alone in
  the scan's order, the divide IEEE).
- K17 ``phase_lock``: ``nearest`` identical, and the spectrum within
  ``3 ulp(max(|syn'|, 1)) mag`` of the plain version's, elementwise
  (:func:`phase_lock_check`): two ulps of the rotation's argument for the
  card's ``sincosf`` against torch's ``cos`` and ``sin``, one for the
  product with the magnitude.

A case may return a tuple of tensors (a scan's output and its state);
every element is held to the bound.
"""
from __future__ import annotations

import numpy as np
import torch

from soundkit_tpu_torch import _build
from soundkit_tpu_torch.ops import aac_batch as ab
from soundkit_tpu_torch.ops import aac_entropy as ae
from soundkit_tpu_torch.ops import (adpcm, celt_postfilter, companding, flac_analyze,
                                    flac_enc_batch, flac_lpc, flac_rice, g722, imdct, mp3_synth,
                                    phase_lock, silk_synth, stretch_ola, vorbis_overlap)
from soundkit_tpu_torch.ops import resample as rs
from soundkit_tpu_torch.utils.device import launch_check

REL_BOUND = {
    "spectral_decode": 0.0,
    "tns_filter": 1e-4,
    "imdct_window": 1e-5,
    "dequant_imdct_window": 1e-5,
    "g711_decode": 0.0,
    "g726_scan": 0.0,
    "g722_scan": 0.0,
    "flac_rice_plane": 0.0,
    "flac_frame": 0.0,
    "mp3_synth": 1e-5,
    "celt_postfilter": 1e-5,
    "silk_synth": 0.0,
    "silk_round": 1e-5,
    "vorbis_overlap": 0.0,
    "flac_analyze": 0.0,
    "polyphase_fir": 1e-5,
    "overlap_add": 0.0,
}


class KernelMismatch(AssertionError):
    pass


def compare(name: str, kernel, plain) -> dict:
    """Run ``kernel`` and ``plain`` once each; ``max_abs_err`` and
    ``rel_err`` of the kernel's result, or :class:`KernelMismatch`."""
    got, ref = kernel(), plain()
    gots = got if isinstance(got, tuple) else (got,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    if gots[0].is_cuda:
        torch.cuda.synchronize()
    err, rel, ok = 0.0, 0.0, len(gots) == len(refs)
    for g, r in zip(gots, refs):
        ok &= g.shape == r.shape and g.dtype == r.dtype
        if not ok:
            break
        e = (g.double() - r.double()).abs().max().item() if g.numel() else 0.0
        err = max(err, e)
        rel = max(rel, e / max(r.double().abs().max().item() if r.numel() else 0.0, 1e-30))
        ok &= bool(torch.isfinite(g).all()) and (
            torch.equal(g, r) if REL_BOUND[name] == 0.0 else rel <= REL_BOUND[name])
    if not ok:
        raise KernelMismatch(f"{name}: max|d| {err} = {rel:.3e} of max|ref| "
                             f"(bound {REL_BOUND[name]})")
    return {"max_abs_err": err, "rel_err": rel}


def _spectral_pair(args):
    """K4's (kernel, plain) on ``args``."""
    return (lambda: ae.spectral_decode(*args)), (lambda: ae.spectral_decode_plain(*args))


def spectral_codewords(runs: torch.Tensor, n_runs: torch.Tensor) -> torch.Tensor:
    """Codewords each K4 lane decodes: a run of ``ncw`` codewords takes
    ``max(ncw, 1)`` steps (the reference decodes one even when ncw is 0)."""
    used = torch.arange(runs.shape[1], device=runs.device)[None] < n_runs[:, None]
    return torch.where(used, ((runs >> 4) & 63).clamp(min=1), 0).sum(1)


def spectral_case(wire: torch.Tensor, B: int):
    """K4 on the spectra of a packed v4 wire of ``B`` AUs (2B channel lanes)."""
    f = ab.unpack_v4_wire(wire, B)
    args = (f["au"], f["spec_bit"].reshape(-1).to(torch.int32),
            f["runs"].reshape(2 * B, -1).to(torch.int32),
            f["n_runs"].reshape(-1).to(torch.int32))
    return _spectral_pair(args)


def spectral_random_inputs(B: int, seed: int, run_cols: int = ab.V4_RUNS):
    """Seeded K4 inputs on the CPU: (au u8 [B, 1024], bitpos, runs,
    n_runs int32) for 2B lanes, far from any encoder's output: random AU
    bytes with stretches of 0xFF (long escape prefixes, up to the
    24-ones cap), bit offsets anywhere in the row (windows wrap past its
    end), and random run programs of at most ~400 codewords a lane:
    codebooks 0..15 (0 and 12-15 clamped; codebook 11 weighted up for
    its escapes), codeword counts 0..63, output bases mostly in order
    but some past line 1023, garbage in the unused run columns, and a
    lane with no run. Every 16-bit prefix of the 11 codebooks is valid
    (the codes are complete), so no lookup meets a zero entry."""
    rng = np.random.default_rng(seed)
    lanes = 2 * B
    au = rng.integers(0, 256, (B, ab.V4_AU_CAP), dtype=np.uint8)
    for b in range(0, B, 3):
        start = rng.integers(0, ab.V4_AU_CAP - 8)
        au[b, start:start + rng.integers(1, 8)] = 0xFF
    bitpos = rng.integers(0, ab.V4_AU_CAP * 8, lanes).astype(np.int32)
    runs = rng.integers(0, 1 << 31, (lanes, run_cols), dtype=np.int64)
    n_runs = np.zeros(lanes, np.int32)
    cb_weights = np.array([1, *[3] * 10, 8, 1, 1, 1, 1], float)
    for lane in range(lanes):
        budget = rng.integers(1, 401)
        base = 0
        r = 0
        while budget > 0 and r < run_cols:
            cb = rng.choice(16, p=cb_weights / cb_weights.sum())
            ncw = int(min(rng.integers(0, 64) if rng.random() < 0.2 else rng.integers(0, 12), budget))
            out = rng.integers(0, 4096) if rng.random() < 0.05 else base
            runs[lane, r] = cb | ncw << 4 | out << 10
            base = min(out + max(ncw, 1) * (4 if 1 <= cb <= 4 else 2), 4095)
            budget -= max(ncw, 1)
            r += 1
        n_runs[lane] = r
    n_runs[lanes // 3] = 0
    bitpos[0] = ab.V4_AU_CAP * 8 - 5  # the first window wraps
    return (torch.from_numpy(au), torch.from_numpy(bitpos),
            torch.from_numpy(runs.astype(np.int32)), torch.from_numpy(n_runs))


def spectral_random_case(B: int, device, seed: int):
    """K4 on :func:`spectral_random_inputs`."""
    args = tuple(t.to(device) for t in spectral_random_inputs(B, seed))
    return _spectral_pair(args)


# TNS layouts of :func:`tns_case`; the first is the timed one
TNS_KINDS = ("long", "regions", "overlap", "short8", "adjacent", "regap", "order0", "tail")


def _tns_regions(kind: str, B: int, C: int, rng) -> np.ndarray:
    """(start, end, direction) per filter [B, C, 8, 3] for a TNS layout."""
    regions = np.zeros((B, C, 8, 3), np.int16)

    def put(f, start, end):
        regions[:, :, f, 0] = start
        regions[:, :, f, 1] = end

    if kind == "long":  # one long-window filter over ~900 lines
        start = rng.integers(0, 124, (B, C))
        put(0, start, start + rng.integers(880, 901, (B, C)))
    elif kind in ("regions", "overlap", "order0"):  # three short regions
        for f in range(3):
            start = rng.integers(0, 900, (B, C)) if kind == "overlap" \
                else f * 340 + rng.integers(0, 200, (B, C))
            put(f, start, start + rng.integers(1, 124, (B, C)))
    elif kind == "short8":  # eight short windows, one filter each
        for f in range(8):
            put(f, 128 * f, 128 * (f + 1))
    elif kind == "adjacent":  # three filters back to back, no gap
        end = rng.integers(0, 200, (B, C))
        for f in range(3):
            start, end = end, end + rng.integers(1, 275, (B, C))
            put(f, start, end)
    elif kind == "regap":  # filter 1 is relabelled 0 by tns_inputs
        end0 = rng.integers(1, 500, (B, C))
        put(0, end0 - rng.integers(1, 100, (B, C)).clip(max=end0), end0)
        start1 = end0 + rng.integers(1, 40, (B, C))
        put(1, start1, start1 + rng.integers(1, 400, (B, C)))
    elif kind == "tail":  # a region ending at line 1023
        put(0, 100, 100 + rng.integers(1, 200, (B, C)))
        put(1, 1024 - rng.integers(1, 600, (B, C)), 1024)
    else:
        raise ValueError(f"unknown TNS layout {kind!r}")
    regions[..., 2] = rng.integers(0, 2, (B, C, 8))
    return regions


def tns_inputs(B: int, C: int, device, seed: int, kind: str = "long"):
    """(coef, perm, filt_id, lpc) of :func:`tns_case`."""
    rng = np.random.default_rng(seed)
    regions = _tns_regions(kind, B, C, rng)
    perm, filt = ab.perm_filt_from_regions(torch.from_numpy(regions).to(device))
    if kind == "regap":
        filt = torch.where(filt == 1, 0, filt)
    # AAC-LC's order limits (12 long, 7 short windows), but for the three
    # short regions, which keep the full 20 taps
    top = {"order0": 0, "short8": 7, "regions": 20, "overlap": 20}.get(kind, 12)
    order = rng.integers(0, top + 1, (B, C, 8))
    lpc = ab.tns_refl_to_lpc(
        torch.from_numpy(rng.integers(-4, 5, (B, C, 8, 20)).astype(np.int8)).to(device),
        torch.full((B, C, 8), 4, dtype=torch.uint8, device=device),
        torch.from_numpy(order.astype(np.uint8)).to(device),
    ).contiguous()
    coef = torch.from_numpy((rng.standard_normal((B, C, 1024)) * 100).astype(np.float32)).to(device)
    return coef, perm, filt, lpc


def tns_case(B: int, C: int, device, seed: int, kind: str = "long"):
    """K5 on a TNS layout of :data:`TNS_KINDS` with stable LPC: orders
    up to AAC-LC's limits, 12 for long and 7 for short windows (0 for
    ``order0``), and up to 20 for ``regions`` and ``overlap``. Random
    20-tap filters over hundreds of lines amplify the rounding of any
    change of summation order past the bound; LC streams carry none.
    Layouts: ``long`` one ~900-line region;
    ``regions`` three disjoint regions of 1-123 lines, as the parser
    emits them; ``overlap`` three that may overlap, so that ``perm`` is
    not an involution; ``short8`` eight 128-line windows; ``adjacent``
    three filters back to back; ``regap`` one filter id again after a
    gap of unfiltered lines; ``tail`` a region ending at line 1023."""
    coef, perm, filt, lpc = tns_inputs(B, C, device, seed, kind)
    return ((lambda: ab.tns_filter(coef, perm, filt, lpc)),
            (lambda: ab.tns_filter_plain(coef, perm, filt, lpc)))


def _synthesis(rows: int, short: bool, device, gen):
    m_long, bank_long, m_short, bank_short = ab.synthesis_banks(torch.device(device))
    basis, bank = (m_short, bank_short) if short else (m_long, bank_long)
    win = torch.randint(0, bank.shape[0], (rows,), generator=gen, dtype=torch.int32).to(device)
    return basis, bank, win


def _imdct_inputs(rows: int, short: bool, device, seed: int):
    gen = torch.Generator().manual_seed(seed)
    basis, bank, win = _synthesis(rows, short, device, gen)
    coef = (torch.randn((rows, basis.m_t.shape[0]), generator=gen) * 1000.0).to(device)
    return coef, basis, bank, win


def imdct_case(rows: int, short: bool, device, seed: int):
    """K1 over ``rows`` rows of the long (K = 1024) or short (K = 128)
    synthesis, with the real IMDCT matrix and window bank."""
    coef, basis, bank, win = _imdct_inputs(rows, short, device, seed)
    return ((lambda: imdct.imdct_window(coef, basis, bank, win)),
            (lambda: imdct.imdct_window_plain(coef, basis.m_t, bank, win)))


def imdct_library(rows: int, short: bool, device, seed: int):
    """The one library call that computes K1's product (without the
    window) on :func:`imdct_case`'s inputs: ``torch.matmul``, a yardstick
    only."""
    coef, basis, _bank, _win = _imdct_inputs(rows, short, device, seed)
    return lambda: torch.matmul(coef, basis.m_t)


def dequant_imdct_case(rows: int, device, seed: int):
    """K2 over ``rows`` long rows: half the lines zero, |q| <= 64,
    scale factors 60..140 around the global gain 100."""
    gen = torch.Generator().manual_seed(seed)
    basis, bank, win = _synthesis(rows, False, device, gen)
    q = torch.randint(-64, 65, (rows, 1024), generator=gen, dtype=torch.int32)
    q = torch.where(torch.rand((rows, 1024), generator=gen) < 0.5, 0, q).to(device)
    sf = torch.randint(60, 141, (rows, 1024), generator=gen).to(device)
    scale = torch.exp2(0.25 * (sf.to(torch.float32) - 100.0))
    return ((lambda: imdct.dequant_imdct_window(q, scale, basis, bank, win)),
            (lambda: imdct.dequant_imdct_window_plain(q, scale, basis.m_t, bank, win)))


# ---------------------------------------------------------------------------
# telephony (K3, K6, K7)
# ---------------------------------------------------------------------------

def _ragged_valid(B: int, n: int, rng) -> torch.Tensor:
    """Per-step mask [B, n]: most lanes full, one in eight stops early,
    one in eight has holes, lane 1 is empty."""
    v = np.ones((B, n), bool)
    stops = np.arange(B) % 8 == 3
    v[stops] = np.arange(n)[None] < rng.integers(0, n, (int(stops.sum()), 1))
    holes = np.arange(B) % 8 == 6
    v[holes] = rng.random((int(holes.sum()), n)) < 0.7
    v[1 % B] = False
    return torch.from_numpy(v)


def _synthetic_pcm(B: int, n: int, rng) -> torch.Tensor:
    """int16 [B, n]: tones at many levels over noise; one lane in eight
    clips at full scale, one in eight sits within a few LSB of zero."""
    t = np.arange(n)
    x = np.sin(2 * np.pi * t[None] * rng.uniform(0.002, 0.45, (B, 1))) * rng.uniform(50, 30000, (B, 1))
    x += rng.standard_normal((B, n)) * rng.uniform(0, 3000, (B, 1))
    x[np.arange(B) % 8 == 2] *= 8
    quiet = np.arange(B) % 8 == 5
    x[quiet] = rng.integers(-4, 5, (int(quiet.sum()), n))
    return torch.from_numpy(np.clip(x, -32768, 32767).astype(np.int16))


def g711_case(B: int, N: int, device, seed: int, offset: int = 0, ragged: bool = True):
    """K3 over random codes, a random law per lane and, if ``ragged``,
    counts per lane (0, N and values between), else none. The codes are a
    view ``offset`` bytes into a larger buffer, as the telephony wire
    hands them over: read in place, rows wherever they fall."""
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy(rng.integers(0, 256, offset + B * N).astype(np.uint8)).to(device)
    codes = buf[offset:].view(B, N)
    law = torch.from_numpy(rng.integers(0, 2, B).astype(np.int32)).to(device)
    counts = None
    if ragged:
        counts = rng.integers(0, N + 1, B).astype(np.int32)
        counts[::5] = N
        counts[1::7] = 0
        counts = torch.from_numpy(counts).to(device)
    return ((lambda: companding.g711_decode(codes, law, counts)),
            (lambda: companding.g711_decode_plain(codes, law, counts)))


def g711_library_case(B: int, N: int, device, seed: int):
    """One PyTorch call that computes K3's function: the [2, 256] int16
    code table indexed by (law, code), on :func:`g711_case`'s codes and
    laws (the index tensors made beforehand: a uint8 tensor indexes as a
    mask), against K3 on the same codes without counts. One call cannot
    also zero the samples past a ragged lane's count. Returns (library,
    kernel)."""
    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.integers(0, 256, B * N).astype(np.uint8)).to(device).view(B, N)
    law = torch.from_numpy(rng.integers(0, 2, B).astype(np.int32)).to(device)
    every = torch.arange(256, dtype=torch.int32)
    table = torch.stack([companding.decode_mulaw(every), companding.decode_alaw(every)]).to(
        torch.int16).to(device)
    law_idx, code_idx = law.long()[:, None], codes.long()
    return (lambda: table[law_idx, code_idx]), (lambda: companding.g711_decode(codes, law))


def g711_launch_floor(B: int, N: int, device):
    """A callable that launches an empty kernel on the grid K3 takes for
    ``[B, N]`` codes: timed beside K3, it says how much of K3's time is
    the launch."""
    def launch():
        stream = torch.cuda.current_stream(device).cuda_stream
        launch_check("g711_launch_floor", _build.kernels().skt_g711_launch_floor(B, N, stream))
    return launch


# steps of the first scan whose final state a carried K6 or K7 case starts from
CARRY_STEPS = 160


def _g726_inputs(B: int, N: int, bits: int, encode: bool, rng) -> torch.Tensor:
    if encode:
        return _synthetic_pcm(B, N, rng)
    return torch.from_numpy(rng.integers(0, 1 << bits, (B, N)).astype(np.uint8))


def g726_case(B: int, N: int, bits: int, encode: bool, device, seed: int,
              carried: bool = False):
    """K6 at ``bits`` per code: decode of random codes or encode of
    :func:`_synthetic_pcm`, ragged mask, from the initial state or, if
    ``carried``, from the state that a first scan (the plain version,
    :data:`CARRY_STEPS` steps, no mask) left."""
    rng = np.random.default_rng(seed)
    valid = _ragged_valid(B, N, rng).to(device)
    state = adpcm.g726_init_state(B, device)
    xs = _g726_inputs(B, N, bits, encode, rng).to(device)
    kernel, plain = ((adpcm.g726_encode_scan, adpcm.g726_encode_scan_plain) if encode
                     else (adpcm.g726_decode_scan, adpcm.g726_decode_scan_plain))
    if carried:
        state = plain(_g726_inputs(B, CARRY_STEPS, bits, encode, rng).to(device), state, bits)[1]
    return (lambda: kernel(xs, state, bits, valid)), (lambda: plain(xs, state, bits, valid))


def _g722_inputs(B: int, N: int, encode: bool, rng) -> torch.Tensor:
    if encode:
        return _synthetic_pcm(B, 2 * N, rng)
    return torch.from_numpy(rng.integers(0, 256, (B, N)).astype(np.uint8))


def g722_case(B: int, N: int, encode: bool, device, seed: int, carried: bool = False):
    """K7 over N codes: decode of random codes or encode of 2N samples
    of :func:`_synthetic_pcm`, ragged mask, from the initial state or, if
    ``carried``, from the state that a first scan (the plain version,
    :data:`CARRY_STEPS` steps, no mask) left."""
    rng = np.random.default_rng(seed)
    valid = _ragged_valid(B, N, rng).to(device)
    state = g722.g722_init_state(B, device)
    xs = _g722_inputs(B, N, encode, rng).to(device)
    kernel, plain = ((g722.g722_encode_scan, g722.g722_encode_scan_plain) if encode
                     else (g722.g722_decode_scan, g722.g722_decode_scan_plain))
    if carried:
        state = plain(_g722_inputs(B, CARRY_STEPS, encode, rng).to(device), state)[1]
    return (lambda: kernel(xs, state, valid)), (lambda: plain(xs, state, valid))


# ---------------------------------------------------------------------------
# FLAC (K8, K9)
# ---------------------------------------------------------------------------

# positions of a FLAC wire's tensors (``FlacWire.segs``): K8 reads the
# first nine, K9 the plane K8 wrote and the rest
_RICE_ARGS = slice(0, 9)
_LPC_ARGS = slice(9, 16)


def flac_fixture_wire(num_lanes: int, rounds: int, device, stride: int = 4608):
    """The wire of ``rounds`` lockstep rounds over ``num_lanes`` ragged
    lanes of the FLAC fixtures, as the batched decoder exports it, as
    tensors on ``device`` (the arguments of ``flac_frames_segs`` up to
    ``lane_valid``)."""
    from soundkit_tpu_torch.models.flac_batch import BatchedFlacDecoder
    from soundkit_tpu_torch.tools import flac_fixtures as ff

    model = BatchedFlacDecoder(num_lanes, stride, device=device)
    for i, data in enumerate(ff.lane_streams(ff.load_clips(), num_lanes, rounds)):
        model.push(i, data)
    wire = model.export_wire(rounds)
    if len(wire.parts[0]):
        raise ValueError("a fixture frame left the segment wire")
    return tuple(model._to_device(wire.segs))


def flac_rice_case(wire, stride: int = 4608):
    """K8 on a FLAC wire (``flac_fixture_wire`` or ``flac_rice_random_inputs``)."""
    args = (*wire[_RICE_ARGS], stride)
    return ((lambda: flac_rice.flac_rice_plane(*args)),
            (lambda: flac_rice.flac_rice_plane_plain(*args)))


def flac_lpc_case(wire, stride: int = 4608):
    """K9 on the residual plane of a FLAC wire (the plain K8's) and the
    wire's LPC fields."""
    plane = flac_rice.flac_rice_plane_plain(*wire[_RICE_ARGS], stride)
    args = (plane, *wire[_LPC_ARGS])
    return (lambda: flac_lpc.flac_frame(*args)), (lambda: flac_lpc.flac_frame_plain(*args))


def flac_rice_random_inputs(seed: int, rows: int = 5, n_words: int = 96, n_segs: int = 70,
                            stride: int = 320, wild: bool = False):
    """Seeded K8 inputs on the CPU, far from any encoder's output, as the
    first nine arguments of ``flac_rice_plane``:
    random frame words with stretches of zeros (quotients past 24 and 48
    zeros) and, on some rows, a zero tail (quotients that never end);
    segments in disjoint ranges of the plane, the last ones past its end;
    Rice parameters 0..31 and fixed widths 0..32; counts 0..144; bit
    offsets anywhere in the row, so that windows run past its end. With
    ``wild``, also what no walk emits, as the reference computes it: Rice
    parameters 32..40 and negative bit offsets."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, (rows, n_words), dtype=np.uint64).astype(np.uint32)
    for r in range(rows):
        for _ in range(4):
            a = rng.integers(0, n_words - 3)
            words[r, a:a + rng.integers(1, 4)] = 0
            words[r, a] &= np.uint32(rng.integers(0, 1 << 16))
    words[::2, -2:] = 0
    total = rows * 2 * stride
    lane = rng.integers(0, rows, n_segs)
    bitoff = rng.integers(0, n_words * 32, n_segs)
    bitoff[::9] = 32 * rng.integers(0, n_words, len(bitoff[::9]))  # on a word boundary
    k = rng.choice(32, n_segs, p=np.r_[[6] * 8, [2] * 23, [1]] / 95)
    fixed = rng.random(n_segs) < 0.3
    k[fixed] = -rng.integers(0, 33, int(fixed.sum())) - 1
    n = np.minimum(rng.integers(0, 145, n_segs), rng.integers(0, 145, n_segs))
    n[::11] = 0
    dest = np.cumsum(n + rng.integers(1, 6, n_segs)) - n  # disjoint, in order
    # stretched until the last tenth falls past the plane's end
    dest = np.floor(dest * max(1.0, 1.1 * total / (dest[-1] + n[-1]))).astype(np.int64)
    warm = rng.integers(-1 << 20, 1 << 20, (rows, 2, 32))
    cflag = (rng.random((rows, 2)) < 0.25).astype(np.int32)
    cval = rng.integers(-1 << 15, 1 << 15, (rows, 2))
    if wild:
        k[5::13] = rng.integers(32, 41, len(k[5::13]))
        bitoff[7::13] = -rng.integers(1, 100, len(bitoff[7::13]))
    arrays = (words.view(np.int32), lane, bitoff, k, n, dest, warm, cflag, cval)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)) for a in arrays)


def flac_lpc_random_inputs(seed: int, lanes: int = 37, T: int = 96, wild: bool = False):
    """Seeded K9 inputs on the CPU, the arguments of ``flac_frame``:
    residuals over the whole int32 range on some rows and 16-bit-sized on
    others, orders 0..32 with coefficients of up to 15 bits (a few rows
    with taps past their order), shifts 0..31, wasted bits 0..8 and 31,
    every assignment, block sizes from 0 to past ``T``, invalid lanes.
    With ``wild``, also what no walk emits, as the reference computes it:
    shifts and wasted bits of 64 and more."""
    rng = np.random.default_rng(seed)
    resw = rng.integers(-1 << 31, 1 << 31, (lanes, 2, T))
    small = rng.random((lanes, 2)) < 0.6
    resw[small] = rng.integers(-1 << 15, 1 << 15, (int(small.sum()), T))
    order = rng.integers(0, 33, (lanes, 2))
    order[::7] = 32
    order[3::7] = 0
    coef = rng.integers(-1 << 14, 1 << 14, (lanes, 2, 32))
    past = np.arange(32)[None, None] >= order[..., None]
    past[::5] = False  # these rows keep taps past their order
    coef[past] = 0
    shift = rng.integers(0, 32, (lanes, 2))
    wasted = rng.integers(0, 9, (lanes, 2))
    wasted[::6, 1] = 31
    if wild:
        shift[2::9] += 64
        wasted[4::9, 0] += 64
    assign = rng.choice([0, 1, 8, 9, 10, 5], lanes)
    bs = rng.integers(0, T + 20, lanes)
    bs[::4] = T
    valid = rng.random(lanes) < 0.85
    ints = (resw, coef, order, shift, wasted, assign, bs)
    return (*(torch.from_numpy(a.astype(np.int32)) for a in ints), torch.from_numpy(valid))


def flac_rice_long_inputs(seed: int, stride: int = 1280):
    """:func:`flac_rice_random_inputs` on 8 rows of 256 words with every
    third segment 600 codes long (longer than a walk's segments, so that
    a decoder that works in chunks takes several), the segments laid out
    again disjoint and in order, the last ones past the plane's end."""
    args = list(flac_rice_random_inputs(seed, rows=8, n_words=256, n_segs=40, stride=stride))
    n = args[4].numpy().astype(np.int64)
    n[::3] = 600
    dest = np.cumsum(n + 3) - n
    total = 8 * 2 * stride
    dest = np.floor(dest * max(1.0, 1.05 * total / (dest[-1] + n[-1]))).astype(np.int64)
    args[4] = torch.from_numpy(n.astype(np.int32))
    args[5] = torch.from_numpy(dest.astype(np.int32))
    return tuple(args)


def flac_lpc_switch_inputs(lanes: int = 40, T: int = 96):
    """K9 inputs whose samples leave int32 in mid-block, each row at
    another sample: from a start near +-2**20, a prediction that grows
    the row's value by a factor ``coef[0] / 256`` a sample (shift 8)
    drawn so that row i crosses 2**31 near sample ``max(i % T, 2)``; the
    rest of the row goes on in 64 bits. Half the rows carry one more tap
    of 1 at a random depth up to 15 (every ring that stays in registers:
    4, 8 and 16 taps). Every lane valid, every
    channel assignment (0, 1, 8, 9, 10), block size ``T``."""
    rng = np.random.default_rng(lanes * 1000 + T)
    rows = lanes * 2
    cross = np.maximum(np.arange(rows) % T, 2)
    start = rng.integers(1 << 20, 1 << 21, rows) * rng.choice([-1, 1], rows)
    resw = rng.integers(-8, 8, (rows, T))
    resw[:, 0] = start
    coef = np.zeros((rows, 32), np.int64)
    coef[:, 0] = np.ceil(256 * 2.0 ** (11 / cross)) + 1
    extra = rng.random(rows) < 0.5
    coef[extra, rng.integers(1, 16, int(extra.sum()))] = 1
    order = np.ones(rows, np.int64)
    shift = np.full(rows, 8)
    wasted = rng.integers(0, 3, rows)
    assign = rng.choice([0, 1, 8, 9, 10], lanes)
    ints = (resw.reshape(lanes, 2, T), coef.reshape(lanes, 2, 32), order.reshape(lanes, 2),
            shift.reshape(lanes, 2), wasted.reshape(lanes, 2), assign, np.full(lanes, T))
    return (*(torch.from_numpy(a.astype(np.int32)) for a in ints),
            torch.ones(lanes, dtype=torch.bool))


def flac_rice_random_case(device, seed: int, stride: int = 320, **shape):
    """K8 on :func:`flac_rice_random_inputs`."""
    args = [t.to(device) for t in flac_rice_random_inputs(seed, stride=stride, **shape)]
    args += [stride]
    return ((lambda: flac_rice.flac_rice_plane(*args)),
            (lambda: flac_rice.flac_rice_plane_plain(*args)))


def flac_lpc_random_case(device, seed: int, **shape):
    """K9 on :func:`flac_lpc_random_inputs`."""
    args = [t.to(device) for t in flac_lpc_random_inputs(seed, **shape)]
    return (lambda: flac_lpc.flac_frame(*args)), (lambda: flac_lpc.flac_frame_plain(*args))


# ---------------------------------------------------------------------------
# MP3 (K10)
# ---------------------------------------------------------------------------

def mp3_synth_pair(rows, overlap, fifo):
    """K10 and its plain version over chained granules: ``rows`` is a
    sequence of packed wire rows (uint8 [stride] each), and each side
    carries its own overlap [B, C, 32, 18] and FIFO [B, C, 1024] from
    ``overlap``, ``fifo``. Each callable returns (pcm [G, B, C, 576], the
    last overlap, the last FIFO)."""
    def chain(step):
        def run():
            ov, ff, pcms = overlap, fifo, []
            for row in rows:
                pcm, ov, ff = step(row, ov, ff)
                pcms.append(pcm)
            # one granule (the path case, which is timed) as a view, so
            # that the callable launches K10 alone
            pcm = pcms[0].unsqueeze(0) if len(pcms) == 1 else torch.stack(pcms)
            return pcm, ov, ff
        return run

    return chain(mp3_synth.mp3_granule_packed), chain(mp3_synth.mp3_granule_packed_plain)


MP3_WILD_NAL = (-3, 0, 1, 17, 31, 40)


def mp3_wire_rows(fields) -> np.ndarray:
    """Packed wire rows [G, stride] (uint8) of ``fields``, one dict of
    numpy arrays a row under the names and shapes of
    :func:`ops.mp3_synth.mp3_wire_layout`."""
    B = fields[0]["ms"].shape[0]
    layout, stride = mp3_synth.mp3_wire_layout(B)
    wire = np.zeros((len(fields), stride), np.uint8)
    for row, vals in zip(wire, fields):
        for name, off, dt, shp in layout:
            raw = np.ascontiguousarray(np.asarray(vals[name]).astype(dt).reshape(shp))
            row[off: off + raw.nbytes] = raw.view(np.uint8).reshape(-1)
    return wire


def mp3_random_fields(rng, B: int) -> dict:
    """One granule's wire fields for ``B`` streams x 2 channels, drawn
    wider than a parser emits: int16 quant (mostly small, 1 % up to
    +-8206, the largest with linbits 13, the tail of each lane silent),
    quarter-exponents from a lane gain in -70..-31 down by up to 4 x 7
    (inside the parser's range, and close enough from lane to lane that
    a bound on the largest value holds every lane) with the sentinel
    -32768 on ~15 % of the lines,
    block types 0-3 and on a quarter of the lanes -7..8, the mixed flag
    on ~35 %, alias boundaries by the parser's rule (0 pure short, 1
    mixed short, else 31) and on a third of the lanes from
    ``MP3_WILD_NAL``, M/S on half the streams, ~a fifth of the lanes
    invalid, and every fifth stream a valid M/S channel 0 whose partner
    is invalid."""
    quant = rng.integers(-12, 13, (B, 2, 576)) * (rng.random((B, 2, 576)) < 0.6)
    big = rng.random((B, 2, 576)) < 0.01
    quant[big] = rng.integers(-8206, 8207, int(big.sum()))
    quant[np.arange(576) >= rng.integers(200, 577, (B, 2, 1))] = 0
    expq = rng.integers(-70, -30, (B, 2, 1)) - 4 * rng.integers(0, 8, (B, 2, 576))
    expq[rng.random((B, 2, 576)) < 0.15] = -32768
    bt = rng.integers(0, 4, (B, 2))
    wild = rng.random((B, 2)) < 0.25
    bt[wild] = rng.integers(-7, 9, int(wild.sum()))
    mixed = rng.random((B, 2)) < 0.35
    nal = np.where((bt == 2) & ~mixed, 0, np.where(bt == 2, 1, 31))
    drawn = rng.random((B, 2)) < 1 / 3
    nal[drawn] = rng.choice(MP3_WILD_NAL, int(drawn.sum()))
    ms = rng.random(B) < 0.5
    valid = rng.random((B, 2)) < 0.8
    ms[::5] = True
    valid[::5] = (True, False)
    return dict(bt=bt, nal=nal, quant=quant, expq=expq, mixed=mixed, ms=ms, valid=valid)


def mp3_synth_random_inputs(seed: int, streams: int = 37, channels: int = 2, granules: int = 4):
    """Seeded K10 inputs on the CPU: ``granules`` packed wire rows of
    :func:`mp3_random_fields` over ``streams`` streams (uint8 [granules,
    stride]) and a non-zero starting overlap and FIFO for ``channels``
    channels."""
    rng = np.random.default_rng(seed)
    wire = mp3_wire_rows([mp3_random_fields(rng, streams) for _ in range(granules)])
    shape = (streams, channels)
    overlap = torch.from_numpy((rng.standard_normal((*shape, 32, 18)) * 0.2).astype(np.float32))
    fifo = torch.from_numpy((rng.standard_normal((*shape, 1024)) * 0.2).astype(np.float32))
    return torch.from_numpy(wire), overlap, fifo


def mp3_synth_random_case(device, seed: int, **shape):
    """K10 on :func:`mp3_synth_random_inputs`, chained."""
    rows, overlap, fifo = mp3_synth_random_inputs(seed, **shape)
    return mp3_synth_pair(rows.to(device), overlap.to(device), fifo.to(device))


def mp3_fixture_inputs(num_lanes: int, device, warm: int = 3, channels: int = 2):
    """K10's inputs on the MP3 path: ``num_lanes`` ragged lanes of the
    MP3 fixtures through a batched decoder on ``device`` for ``warm``
    granules, then the next round's packed wire row, with the decoder's
    carried state. Returns ([row], overlap, fifo) for
    :func:`mp3_synth_pair`."""
    from soundkit_tpu_torch.models.mp3_batch_model import BatchedMp3Decoder
    from soundkit_tpu_torch.tools import mp3_fixtures

    model = BatchedMp3Decoder(num_lanes, channels, device=device)
    for i, data in enumerate(mp3_fixtures.lane_streams(mp3_fixtures.load_clips(), num_lanes)):
        model.push(i, data)
    model.decode_batches(warm)
    row = torch.from_numpy(model._pop_rounds(1)[0]).to(device)
    return [row], model._overlap, model._fifo


def mp3_synth_work(rows, overlap) -> tuple:
    """(bytes, float32 operations) that K10's function needs for the
    wire ``rows`` (of :func:`mp3_synth_pair`) at the state shape of
    ``overlap``. Bytes: every stream reads its M/S and validity flags,
    every lane reads and writes its overlap and FIFO and writes its PCM;
    a valid lane reads its block type, alias boundaries and mixed flag,
    and a lane's int16 quant and quarter-exponents are read where its
    own synthesis or, under M/S, its valid partner's takes them; and the
    table once. Operations, each counted once, for what the lanes need:
    4 a line read (the scale's exp2, the power, two products), 2 a line
    under M/S (a sum and a product), 6 an active alias butterfly; then,
    on valid lanes, the path each subband takes (a long subband 36 x 18
    products and sums and 36 window products, a short one 3 x 12 x 6 and
    36 + 24 window products and sums), the overlap-add, the matrixing (18
    x 64 x 32) and the windowed sums (576 x 16)."""
    B, C = overlap.shape[0], overlap.shape[1]
    nbytes = flops = 0
    for row in rows:
        f = mp3_synth.unpack_mp3_wire(row.cpu(), B)
        v = f["valid"][:, :C] != 0
        ms = (f["ms"] != 0) & (C == 2)
        lines = v | (ms[:, None] & v.flip(1)) if C == 2 else v
        n_valid, n_lines = int(v.sum()), int(lines.sum())
        nbytes += B * (1 + C) + B * C * (576 * 4 + 2 * (576 + 1024) * 4) + n_valid * 9 \
            + n_lines * 576 * 4
        n_ms = int((lines & ms[:, None]).sum()) if C == 2 else 0
        nal = f["nal"][:, :C].long().clamp(0, 31)[v]
        flops += n_lines * 576 * 4 + n_ms * 576 * 2 + int(nal.sum()) * 8 * 6
        bt, mixed = f["bt"][:, :C][v], f["mixed"][:, :C][v] != 0
        short_lane = (bt == 2).long()
        low_long = (mixed & (bt == 2)).long()  # subbands 0-1 of a mixed short lane
        n_short = (32 * short_lane - 2 * low_long).sum().item()
        n_long = 32 * n_valid - n_short
        flops += n_long * (2 * 36 * 18 + 36) + n_short * (2 * 3 * 12 * 6 + 36 + 24)
        flops += n_valid * (576 + 2 * 18 * 64 * 32 + 2 * 576 * 16)
    return nbytes + mp3_synth.kernel_tables(torch.device("cpu")).numel() * 4, flops


# ---------------------------------------------------------------------------
# CELT (K11)
# ---------------------------------------------------------------------------

def celt_postfilter_pair(inputs):
    """K11 and its plain version on ``inputs`` = (full, comb, valid, ola,
    hist, emph), each returning (pcm, new_ola, new_hist, new_emph)."""
    return (lambda: celt_postfilter.celt_postfilter(*inputs),
            lambda: celt_postfilter.celt_postfilter_plain(*inputs))


def celt_invalid_passthrough(result, inputs) -> None:
    """Raise :class:`KernelMismatch` unless every stream with ``valid`` 0
    has zero PCM and its ``ola``, ``hist`` and ``emph`` bit for bit in
    ``result`` (K11's (pcm, new_ola, new_hist, new_emph) on ``inputs``)."""
    _, _, valid, ola, hist, emph = inputs
    pcm, new_ola, new_hist, new_emph = result
    off = ~valid
    if not (torch.equal(pcm[off], torch.zeros_like(pcm[off])) and torch.equal(new_ola[off], ola[off])
            and torch.equal(new_hist[off], hist[off]) and torch.equal(new_emph[off], emph[off])):
        raise KernelMismatch("celt_postfilter: an invalid stream's PCM or state changed")


CELT_EDGE_PERIODS = (15, 16, 17, 33, 34, 35, 1022, 1023, 1024)


def celt_postfilter_random_inputs(seed: int, streams: int = 37, channels: int = 2):
    """Seeded K11 inputs on the CPU: IMDCT output and a carried state of
    the size a CELT stream's signal has (celt_sig units, up to ~3e4);
    periods drawn from 15..1022 with every third stream's four periods
    from ``CELT_EDGE_PERIODS`` (both ends of the range, and where a step
    of the kernel widens from 13 to 32 samples); per stage, gains of 0 to
    0.75 times one of the three tapsets (``pack_comb_params``' premultiplied
    form), zero on a quarter of the stages; ~a fifth of the streams
    invalid."""
    from soundkit_tpu_torch.codecs.opus_tables import tables

    rng = np.random.default_rng(seed)
    B, C = streams, channels
    taps = tables()["celt_postfilter_taps"].astype(np.float64)
    comb = np.zeros((B, 16), np.float32)
    comb[:, [0, 1, 8, 9]] = rng.integers(15, 1023, (B, 4))
    edge = np.arange(B) % 3 == 0
    comb[np.ix_(edge, [0, 1, 8, 9])] = rng.choice(CELT_EDGE_PERIODS, (int(edge.sum()), 4))
    for col in (2, 5, 10, 13):
        g = rng.uniform(0, 0.75, B) * (rng.random(B) >= 0.25)
        comb[:, col: col + 3] = g[:, None] * taps[rng.integers(0, 3, B)]
    valid = rng.random(B) >= 0.2

    def f32(*shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    return (f32(B, C, 1080, scale=3000.0), torch.from_numpy(comb), torch.from_numpy(valid),
            f32(B, C, 120, scale=3000.0), f32(B, C, 1200, scale=3000.0), f32(B, C, scale=3000.0))


def celt_postfilter_random_case(device, seed: int, **shape):
    """K11 on :func:`celt_postfilter_random_inputs`."""
    inputs = tuple(t.to(device) for t in celt_postfilter_random_inputs(seed, **shape))
    return celt_postfilter_pair(inputs)


def celt_fixture_inputs(num_lanes: int, device, warm: int = 3, channels: int = 2,
                        wire: str = "f32"):
    """K11's inputs on the CELT path: ``num_lanes`` ragged lanes of the
    Opus fixtures (at ``channels`` 1, of the mono clip only) through a
    batched decoder on ``device`` for ``warm``
    rounds, then the next round's IMDCT output, comb parameters and
    validity, with the decoder's carried state: (full, comb, valid, ola,
    hist, emph) for :func:`celt_postfilter_pair`."""
    from soundkit_tpu_torch.models.opus_batch import BatchedCeltDecoder, _band_of_bin
    from soundkit_tpu_torch.ops import celt_batch as cb
    from soundkit_tpu_torch.tools import opus_fixtures

    clips = opus_fixtures.load_clips()
    # lanes whose clip fits the channel count (at C = 1, the mono clip's)
    lanes = [data for i, data in enumerate(opus_fixtures.lane_raw(clips, 4 * num_lanes))
             if clips[i % len(clips)].channels <= channels][:num_lanes]
    model = BatchedCeltDecoder(num_lanes, channels, wire=wire, device=device)
    for i, data in enumerate(lanes):
        model.push(i, data)
    model.decode_ready(max_packets=warm)
    freq, scales, comb, sflag, valid, W = model._walk(1)
    f = torch.from_numpy(freq[0]).to(device)
    if scales is not None:
        bidx = torch.from_numpy(_band_of_bin(W).astype(np.int64)).to(device)
        f = cb.dequant_wire(f, torch.from_numpy(scales[0]).to(device), bidx)
    full = cb.celt_imdct(cb.pad_wire(f), torch.from_numpy(sflag[0]).to(device))
    return (full, torch.from_numpy(comb[0]).to(device), torch.from_numpy(valid[0]).to(device),
            model._ola, model._hist, model._emph)


def celt_postfilter_work(inputs) -> tuple:
    """(bytes, float32 operations) that K11's function needs on
    ``inputs`` (of :func:`celt_postfilter_pair`). Bytes: every stream
    reads its validity flag; a valid stream reads its comb parameters,
    and each of its channels reads its IMDCT output (1080), overlap (120),
    de-emphasis memory and the part of its history that the comb taps or
    the new history reach, and writes its PCM (960), new overlap, new
    history (1200) and memory; an invalid stream's channels read their
    overlap, history and memory and write them and zero PCM. The history
    read is the last max(240, Ta + 2, Tb + 2 - 120) samples, with Ta and
    Tb the larger clamped period of stage A (from sample 0) and of stage B
    (from sample 120): the comb's first sample of a stage reads T + 2 back,
    and the new history keeps the old one's last 240.
    Operations on a valid channel: 120 for the overlap-add; for each
    sample, each of its two comb taps whose gains are not all zero takes
    7 (the 5-tap sum) and 2 (its crossfade weight and the add), plus 1
    for ``1 - f`` where the first tap is active; the de-emphasis as the
    one-pole recurrence, 2 a sample, and the scale to PCM, 1 a sample."""
    full, comb, valid, _, _, _ = (t.cpu() for t in inputs)
    B, C = full.shape[0], full.shape[1]
    v = valid.bool()
    n_valid, n_invalid = int(v.sum()), B - int(v.sum())
    periods = comb[:, [0, 1, 8, 9]].to(torch.int32).clamp(celt_postfilter.T_MIN,
                                                          celt_postfilter.T_MAX).long()
    reach = torch.maximum(periods[:, :2].amax(1) + 2, periods[:, 2:].amax(1) + 2 - 120)
    hist_read = int(reach[v].clamp(240, 1200).sum())
    state = (120 + 1200 + 1) * 4
    nbytes = B + n_valid * 64 + n_valid * C * (1080 * 4 + (120 + 1) * 4 + 960 * 4 + state) \
        + C * hist_read * 4 + n_invalid * C * (state + 960 * 4 + state)
    on = [(comb[:, s: s + 3] != 0).any(1) for s in (2, 5, 10, 13)]  # ga, gb, gc, gd active
    per_lane = (120 * ((on[0].long() * 10) + on[1].long() * 9)
                + 840 * ((on[2].long() * 10) + on[3].long() * 9) + 120 + celt_postfilter.N * 3)
    flops = int((per_lane[v] * C).sum())
    return nbytes, flops


# ---------------------------------------------------------------------------
# SILK (K12)
# ---------------------------------------------------------------------------

SILK_ARGS = ("exc", "gains", "coef", "hl", "vo", "lags", "ltp", "ltpscale")


def silk_synth_pair(bw: int, inputs):
    """K12 and its plain version at bandwidth ``bw`` on ``inputs`` = (exc,
    gains, coef, has_leadin, voiced, lags, ltp, ltpscale, out_hist,
    lpch_tail), each returning (dst, new lpch_tail)."""
    return (lambda: silk_synth.silk_synth(bw, *inputs),
            lambda: silk_synth.silk_synth_plain(bw, *inputs))


def silk_synth_random_inputs(seed: int, bw: int, streams: int = 37, channels: int = 2):
    """Seeded K12 inputs on the CPU for ``streams`` lanes x 2 rows, the
    sizes the SILK walk exports: excitation ~3e-4 in Q23 steps, gains
    2-40, stable LPC (pole radii 0.3-0.9), LTP taps of a voiced
    row (their magnitudes summing to at most 0.9), lags over the bandwidth's whole range with its two ends, voiced
    and unvoiced rows, with and without lead-in, history in [-1, 1].
    ``channels`` 1: every second row zero (a mono lane's uncoded side
    channel); ~a fifth of the lanes invalid (their rows all zero, as the
    walk leaves them), and lane 0 all zero."""
    rng = np.random.default_rng(seed)
    B = streams
    sfl, order = silk_synth.SFL[bw], silk_synth.ORDER[bw]
    exc = np.round(rng.standard_normal((B, 2, 320)) * 3e-4 * 2 ** 23) / 2 ** 23
    gains = rng.uniform(2, 40, (B, 2, 4))
    # LPC of a stable all-pole filter: a product of second-order sections,
    # drawn again until the float32 coefficients keep every pole inside 0.95
    coef = np.zeros((B, 2, 2, 16))
    for b in range(B):
        for c in range(2):
            for s in range(2):
                while True:
                    poly = np.array([1.0])
                    for _ in range(order // 2):
                        r, th = rng.uniform(0.3, 0.9), rng.uniform(0.05, np.pi - 0.05)
                        poly = np.convolve(poly, [1.0, -2 * r * np.cos(th), r * r])
                    a = (-poly[1:]).astype(np.float32)
                    if np.abs(np.roots(np.concatenate([[1.0], -a.astype(np.float64)]))).max() < 0.95:
                        break
                coef[b, c, s, :order] = a
    lo, hi = (16, 24, 32)[bw], (144, 216, 288)[bw]
    lags = rng.integers(lo, hi + 1, (B, 2, 4))
    lags[1::5] = lo
    lags[2::5] = hi
    ltp = rng.uniform(-0.1, 0.4, (B, 2, 4, 5))
    # a stable long-term predictor, as SILK's codebooks give: taps of total magnitude < 1
    ltp *= 0.9 / np.maximum(np.abs(ltp).sum(-1, keepdims=True), 0.9)
    ltpscale = rng.uniform(0.25, 1.0, (B, 2))
    hl = rng.integers(0, 2, (B, 2))
    vo = rng.integers(0, 2, (B, 2))
    hist = np.clip(rng.standard_normal((B, 2, 322)) * 0.3, -1, 1)
    tail = rng.standard_normal((B, 2, 16)) * 0.3
    planes = [exc, gains, coef, hl, vo, lags, ltp, ltpscale, hist, tail]
    off = rng.random(B) < 0.2
    off[0] = True
    for a in planes:
        a[off] = 0
        if channels == 1:
            a[:, 1] = 0
    dts = (np.float32, np.float32, np.float32, np.int32, np.int32, np.int32, np.float32,
           np.float32, np.float32, np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dt)) for a, dt in zip(planes, dts))


def silk_synth_random_case(device, seed: int, bw: int, **shape):
    """K12 on :func:`silk_synth_random_inputs`."""
    inputs = tuple(t.to(device) for t in silk_synth_random_inputs(seed, bw, **shape))
    return silk_synth_pair(bw, inputs)


def silk_fixture_inputs(num_lanes: int, device, warm: int = 3, bw: int = 2, names=None):
    """K12's inputs on the SILK path: ``num_lanes`` ragged lanes of the
    SILK voice fixtures ``names`` (by default those of bandwidth ``bw``;
    at WB the mono and the stereo clip) through a batched decoder on
    ``device`` for ``warm`` rounds, then the next round's walk export for
    every lane, with the decoder's carried state of bandwidth ``bw`` (as
    the path's launch at ``bw`` takes them)."""
    from soundkit_tpu_torch.models.opus_batch import BatchedSilkDeviceDecoder
    from soundkit_tpu_torch.tools import opus_fixtures

    names = names or {0: ("silk_nb",), 1: ("silk_mb",), 2: ("silk_wb", "silk_wb_stereo")}[bw]
    by_name = {c.name: c for c in opus_fixtures.load_clips(names=opus_fixtures.VOICE_CLIPS)}
    clips = [by_name[n] for n in names]
    model = BatchedSilkDeviceDecoder(num_lanes, 2, device=device)
    for b in range(num_lanes):
        for frame, fbw, coded in opus_fixtures.lane_frames(clips, b):
            model.push_packet(b, frame, fbw, coded)
    model.decode_ready(max_packets=warm)
    p, ok, bws = model._walk_round()
    d = model._to_device(p, ok, bws)
    out_hist, lpch_tail, _ = model._group_state(bw)
    return tuple(d[k] for k in SILK_ARGS) + (out_hist, lpch_tail)


def silk_synth_work(bw: int, inputs) -> tuple:
    """(bytes, float32 operations) that K12's function needs on
    ``inputs``. Bytes, a row: its frame's excitation (4 sfl samples), the
    gains, both coefficient sets, the flags, lags, LTP taps and scale, the
    history (322) and the LPC tail (16) read; the output line (322 + 4 sfl)
    and the new tail written. Operations, a row: the LPC, 2 order + 1 a
    sample; on a voiced row the LTP, 10 a sample and the add, and for
    each subframe the re-whitened span (its lag + 2 + its out_end
    positions: 2 order + 2 each, and the two divisions) and the positions
    the gain ratio scales (1 each)."""
    sfl, order = silk_synth.SFL[bw], silk_synth.ORDER[bw]
    flen = 4 * sfl
    _, _, _, hl, vo, lags, _, _, _, _ = (t.cpu() for t in inputs)
    rows = vo.numel()
    nbytes = rows * (flen * 4 + 16 + 128 + 8 + 16 + 80 + 4 + 322 * 4 + 64
                     + (322 + flen) * 4 + 64)
    flops = rows * flen * (2 * order + 1)
    voiced = vo.bool()
    lag = lags.long().clamp(silk_synth.LAG_MIN, silk_synth.LAG_MAX)
    lead = hl.bool()
    n_voiced = int(voiced.sum())
    flops += n_voiced * flen * 11
    for i in range(4):
        end = -i * sfl if i < 2 else torch.where(lead, -(i - 2) * sfl, -i * sfl)
        span = (lag[..., i] + 2 + end).clamp(min=0)
        flops += int(span[voiced].sum()) * (2 * order + 2) + 2 * n_voiced
        if i:
            flops += int((-torch.as_tensor(end).expand_as(span))[voiced].sum())
    return nbytes, flops


def silk_round_random_args(seed: int, bw: int, B: int = 37):
    """``silk_round``'s arguments on the CPU for a stereo group of B lanes:
    :func:`silk_synth_random_inputs`' frame (every lane valid, both
    channels coded, every lane unmixed, the first four fresh), stereo
    weights, a gain and a carried state."""
    rng = np.random.default_rng(seed)
    exc, gains, coef, hl, vo, lags, ltp, ltpscale, hist, tail = silk_synth_random_inputs(
        seed, bw, streams=B)
    from soundkit_tpu_torch.ops import silk_batch

    T = silk_batch._resample_plan(bw)[2]
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    fresh = np.zeros(B, np.float32)
    fresh[:4] = 1
    return (exc, gains, coef, hl, vo, lags, ltp, ltpscale,
            torch.ones((B, 2), dtype=torch.int32), torch.ones(B, dtype=torch.int32),
            torch.from_numpy((rng.random(B) < 0.1).astype(np.int32)),
            f32(rng.uniform(-0.5, 0.5, (B, 4))), f32(rng.uniform(0.5, 1.5, B)),
            torch.ones(B, dtype=torch.bool), f32(fresh), hist, tail,
            f32(rng.standard_normal((B, 2, T)) * 0.2))


# ---------------------------------------------------------------------------
# Vorbis (K13)
# ---------------------------------------------------------------------------

def vorbis_overlap_pair(inputs):
    """K13 and its plain version on ``inputs`` = (pcm1, pcm0, bank, flags,
    carry), each returning (out, new_carry)."""
    return (lambda: vorbis_overlap.vorbis_overlap(*inputs),
            lambda: vorbis_overlap.vorbis_overlap_plain(*inputs))


def vorbis_overlap_random_inputs(seed: int, streams: int = 37, channels: int = 2, n0: int = 256,
                                 n1: int = 2048):
    """Seeded K13 inputs on the CPU: IMDCT outputs and a lap of the size a
    Vorbis stream's have (~0.3); lane i takes the (previous, current)
    block-size case i mod 4 (long-long, long-short, short-long,
    short-short), random window flags, ~a fifth of the lanes invalid."""
    from soundkit_tpu_torch.ops.vorbis_batch import window_bank

    rng = np.random.default_rng(seed)
    B, C = streams, channels
    case = np.arange(B) % 4
    cflag = (case < 2).astype(np.int32)
    n_flag = (case % 2 == 0).astype(np.int32)
    pf, nf = rng.integers(0, 2, (2, B)).astype(np.int32)
    valid = (rng.random(B) >= 0.2).astype(np.int32)
    flags = np.stack([n_flag, pf, nf, valid, cflag])

    def f32(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * 0.3).astype(np.float32))

    return (f32(B, C, n1), f32(B, C, n0), torch.from_numpy(window_bank(n0, n1)),
            torch.from_numpy(flags), f32(B, C, n1 // 2))


def vorbis_overlap_random_case(device, seed: int, **shape):
    """K13 on :func:`vorbis_overlap_random_inputs`."""
    inputs = tuple(t.to(device) for t in vorbis_overlap_random_inputs(seed, **shape))
    return vorbis_overlap_pair(inputs)


def vorbis_fixture_inputs(num_lanes: int, device, warm: int = 3, n_pages: int = 2):
    """K13's inputs on the Vorbis path: ``num_lanes`` ragged lanes of the
    two stereo 44.1 kHz fixtures (their first ``n_pages`` audio pages)
    through a batched decoder on ``device`` for ``warm`` rounds, then the
    next round's IMDCT outputs and flags, with the decoder's lap: (pcm1,
    pcm0, bank, flags, carry) for :func:`vorbis_overlap_pair`."""
    from soundkit_tpu_torch.models.vorbis_batch import BatchedVorbisDecoder
    from soundkit_tpu_torch.ops import vorbis_batch as vb
    from soundkit_tpu_torch.tools import vorbis_fixtures

    clips = vorbis_fixtures.load_clips(names=vorbis_fixtures.STEREO)
    model = BatchedVorbisDecoder(num_lanes, device=device)
    for i, data in enumerate(vorbis_fixtures.lane_streams(clips, num_lanes, n_pages)):
        model.push(i, data)
    model.decode_batches(warm)
    spec, flags, _ = model._pack_round()
    n0, n1, _ = model._topology
    pcm1, pcm0 = vb.vorbis_imdct(torch.from_numpy(spec).to(device), n0, n1)
    return (pcm1, pcm0, vb.device_tables(n0, n1, pcm1.device)[2],
            torch.from_numpy(flags).to(device), model._carry)


def vorbis_overlap_work(inputs) -> tuple:
    """(bytes, float32 operations) that K13's function needs on
    ``inputs`` (of :func:`vorbis_overlap_pair`). Bytes: the flags; the
    window rows the valid lanes use, once each; every channel reads its
    lap (n1/2) and writes its PCM and new lap (n1/2 each); a valid
    channel also reads the samples of its block's IMDCT output that reach
    either (all n of a block but the first (n1 - n0)/4 of a long block
    after a short one, which its window zeroes; counted by the same index
    arithmetic as the kernel's). Operations on a valid channel: a product
    and a sum for each of its n1/2 output samples and n/2 lap samples."""
    pcm1, pcm0, bank, flags, _ = inputs
    B, C, n1 = pcm1.shape
    n0 = pcm0.shape[-1]
    h1 = n1 // 2
    f = flags.cpu().numpy()
    n_flag, pf, nf, valid, cflag = f
    sL = (n1 - n0) // 4
    reads = {}
    for prev_long in (0, 1):
        for cur_long in (0, 1):
            n = n1 if cur_long else n0
            s = 0 if prev_long == cur_long else (sL if prev_long else -sL)
            d = (n1 if prev_long else n0) // 4 + n // 4
            idx = np.concatenate([np.arange(h1) - s, d + np.arange(n // 2) - s])
            reads[prev_long, cur_long] = int(np.unique(idx[(idx >= 0) & (idx < n)]).size)
    v = valid != 0
    widx = np.where(n_flag == 1, pf * 2 + nf, 4)[v]
    nbytes = f.nbytes + np.unique(widx).size * n1 * 4 + B * C * 3 * h1 * 4
    nbytes += sum(C * reads[int(a == 1), int(b == 1)] * 4 for a, b in zip(cflag[v], n_flag[v]))
    n_blk = np.where(n_flag[v] == 1, n1, n0)
    flops = int(C * (2 * h1 + n_blk).sum())
    return int(nbytes), flops


# ---------------------------------------------------------------------------
# FLAC encode analysis (K14)
# ---------------------------------------------------------------------------

#: the H100 SXM's float64 rate outside the tensor cores (NVIDIA's data sheet)
FP64_RATE = 34e12
#: integer operations a second at the SMs' issue rate: 132 SMs x 64 lanes a clock
#: at the 1.98 GHz boost clock (NVIDIA's arithmetic-instruction throughput table
#: for compute capability 9.0: 64 results a clock an SM for 32-bit integer
#: multiply-add, shift and compare, half the 128 of float32)
INT_ISSUE_RATE = 132 * 64 * 1.98e9


def flac_analyze_pair(x, n_valid: int, bits: int, channels: int = 2):
    """K14 and its plain version on the wire ``x`` [L, 2, N], each
    returning the [L, 23] int32 plan rows."""
    return (lambda: flac_analyze.flac_analyze(x, n_valid, bits, channels),
            lambda: flac_enc_batch.flac_plans_pack(
                *flac_enc_batch.flac_analyze_plain(x, n_valid, bits, channels)[:5]))


def flac_enc_path_inputs(lanes, n: int, device, channels: int = 2, rate: int = 44100,
                         bits: int = 16) -> torch.Tensor:
    """K14's wire on the batched encoder's path: each of ``lanes`` ([C, m]
    int PCM) pushes its first ``n`` samples into a ``BatchedFlacEncoder``
    on ``device``, and the wire of the first ``encode_pending`` comes
    back, on ``device`` (every full block of every lane, in rows)."""
    from soundkit_tpu_torch.models.flac_encode_batch import BatchedFlacEncoder

    enc = BatchedFlacEncoder(len(lanes), rate, channels, bits, device=device)
    for i, x in enumerate(lanes):
        enc.push(i, x[:, :n])
    jobs, spans = enc._take_pending()
    return torch.from_numpy(enc._wire(jobs, enc.block_size, spans)).to(device)


def flac_analyze_inputs(seed: int, rows: int = 37, n: int = 4096, bits: int = 16,
                        channels: int = 2) -> torch.Tensor:
    """Seeded K14 wires on the CPU, [rows, 2, n] int16 at <= 16 bits, else
    int32: row i takes kind i mod 6 (left and right correlated with a
    small side; independent channels; L == R; low-passed noise; white
    noise; a signal of a few LSB), each with its own tones and level up to
    full scale. Mono rows keep channel 1 zero."""
    rng = np.random.default_rng(seed)
    top = (1 << (bits - 1)) - 1
    t = np.arange(n)
    x = np.zeros((rows, 2, n), np.int64)
    for i in range(rows):
        amp = top * rng.uniform(0.05, 0.9)
        tone = amp * np.sin(t * rng.uniform(0.002, 0.3) + rng.uniform(0, 6.3))
        noise = rng.normal(0, 1, (2, n))
        kind = i % 6
        if kind == 0:
            left, right = tone + noise[0] * amp * 0.01, 0.9 * tone + noise[1] * amp * 0.02
        elif kind == 1:
            left, right = tone, amp * 0.5 * np.sin(t * rng.uniform(0.002, 0.3)) + noise[1] * 30
        elif kind == 2:
            left = right = tone + noise[0] * amp * 0.05
        elif kind == 3:
            lp = np.convolve(noise[0], np.ones(16) / 4, "same")
            left, right = lp * amp * 0.2, np.roll(lp, 3) * amp * 0.2
        elif kind == 4:
            left, right = noise * amp * 0.3
        else:
            left, right = noise * rng.uniform(0.5, 4)
        x[i, 0], x[i, 1] = left.round(), right.round()
    x = np.clip(x, -top - 1, top)
    if channels == 1:
        x[:, 1] = 0
    return torch.from_numpy(x.astype(np.int16 if bits <= 16 else np.int32))


def flac_analyze_edge_cases(bits: int = 24):
    """(name, x, n_valid, channels) K14 cases at the edges: silence, a
    constant block (CONSTANT subframes), full-scale noise, rows
    alternating between +max and -max with R = -L (a side channel of
    bits + 1), the shortest block FLAC writes (16), n_valid < N with
    junk past it, a block longer than one of K14's tiles, and the mono
    form of each."""
    rng = np.random.default_rng(bits)
    top = (1 << (bits - 1)) - 1
    dt = np.int16 if bits <= 16 else np.int32
    rows, n = 6, 4096
    cases = []
    alt = np.where(np.arange(n) % 2 == 0, top, -top)
    edges = {
        "silence": np.zeros((rows, 2, n), np.int64),
        "constant": np.broadcast_to(rng.integers(-top, top, (rows, 2, 1)), (rows, 2, n)),
        "full_scale_noise": rng.integers(-top - 1, top + 1, (rows, 2, n)),
        "alternating_max": np.broadcast_to(np.stack([alt, -alt]), (rows, 2, n)),
    }
    for name, x in edges.items():
        cases.append((name, x, n))
    cases.append(("n16", flac_analyze_inputs(bits + 1, rows, 16, bits).numpy(), 16))
    short = flac_analyze_inputs(bits + 2, rows, n, bits).numpy()
    cases.append(("n_valid_1000", short, 1000))
    cases.append(("n_valid_17", short, 17))
    cases.append(("multi_tile", flac_analyze_inputs(bits + 3, 3, 9000, bits).numpy(), 8999))
    out = []
    for name, x, n_valid in cases:
        for channels in (2, 1):
            y = np.array(x, dtype=dt, order="C")
            if channels == 1:
                y[:, 1] = 0
            out.append((f"{name}_c{channels}", torch.from_numpy(y), n_valid, channels))
    return out


def flac_analyze_full_scale(seed: int, rows: int = 6, n: int = 4096, bits: int = 24,
                            channels: int = 2) -> torch.Tensor:
    """K14 rows at full scale, every sample +-(2^(bits-1) - 1): even rows
    of random signs, odd rows alternating with R = -L (a side channel of
    bits + 1 whose fourth difference reaches 32 times full scale, so a
    thread's sums of |d_4| come within a few samples of 2^32 at 24 bits).
    int16 at <= 16 bits, else int32; mono rows keep channel 1 zero."""
    rng = np.random.default_rng(seed)
    top = (1 << (bits - 1)) - 1
    x = rng.choice(np.array([-top, top]), (rows, 2, n))
    alt = np.where(np.arange(n) % 2 == 0, top, -top)
    x[1::2] = np.stack([alt, -alt])
    if channels == 1:
        x[:, 1] = 0
    return torch.from_numpy(x.astype(np.int16 if bits <= 16 else np.int32))


def flac_analyze_work(x, n_valid: int, channels: int = 2) -> dict:
    """What K14's function needs on the wire ``x`` [L, 2, N]: the bytes it
    moves (each row's ``n_valid`` samples of the channels it reads, once,
    and the plan rows written), its float64 operations and its integer
    operations (an int64 operation counted as one), per row:

    - float64: the window once (4 a sample); per candidate and valid
      sample the windowed value (1) and nine lags of the autocorrelation,
      a product and a sum each (18); per candidate the Levinson recursion
      (144) and the quantization (24);
    - integer: the side and mid channels (3 a sample, stereo); per
      candidate and valid sample four fixed differences (4), five sums of
      |d| (10), the chosen order's zigzag and sum (4) and its u >> k and
      sum (2); the LPC prediction (8 products, 8 sums), shift and
      difference (2), zigzag and sum (4) and u >> k and sum (2).

    Returns dict(bytes, fp64, int_ops)."""
    L, _, N = x.shape
    nc = 4 if channels == 2 else 1
    n = int(n_valid)
    nbytes = L * channels * n * x.element_size() + L * flac_enc_batch.PLAN_COLS * 4
    fp64 = 4 * n + L * nc * (19 * n + 144 + 24)
    int_ops = L * ((3 * n if channels == 2 else 0) + nc * (20 * n + 24 * n))
    return dict(bytes=int(nbytes), fp64=int(fp64), int_ops=int(int_ops))


def flac_analyze_bound(work: dict) -> dict:
    """The least time the H100 could take for ``work`` (of
    :func:`flac_analyze_work`): the larger of its bytes at 3.35 TB/s, its
    float64 operations at ``FP64_RATE`` and its integer operations at
    ``INT_ISSUE_RATE``; ``bound_by`` is "bytes" or "operations"."""
    t_bytes = 1e3 * work["bytes"] / 3.35e12
    t_fp64 = 1e3 * work["fp64"] / FP64_RATE
    t_int = 1e3 * work["int_ops"] / INT_ISSUE_RATE
    t = max(t_bytes, t_fp64, t_int)
    return dict(bound_ms=t, bound_by="bytes" if t == t_bytes else "operations",
                bytes_ms=t_bytes, fp64_ms=t_fp64, int_ms=t_int)


# ---------------------------------------------------------------------------
# the resampler (K15) and the phase vocoder (K16, K17)
# ---------------------------------------------------------------------------

#: every ordered pair of ``core.audio_pipeline.COMMON_SAMPLE_RATES``, and the
#: pitch shift's 3000 -> 2000 (pitch_scale 1.5)
RESAMPLE_PAIRS = tuple((a, b) for a in (8000, 16000, 22050, 24000, 32000, 44100, 48000, 88200,
                                        96000)
                       for b in (8000, 16000, 22050, 24000, 32000, 44100, 48000, 88200, 96000)
                       if a != b) + ((3000, 2000),)


def resample_rows(seed: int, B: int, n: int, device) -> torch.Tensor:
    """Seeded unit-scale rows f32 [B, n] (a tone and noise) on ``device``."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 8000.0
    x = 0.5 * np.sin(2 * np.pi * rng.uniform(50, 3000, (B, 1)) * t) \
        + 0.3 * rng.standard_normal((B, n))
    return torch.from_numpy(x.astype(np.float32)).to(device)


def resample_pair(x, in_rate: int, out_rate: int, hist=None):
    """K15 and its plain version on ``x`` [B, n] (and ``hist``): the
    one-shot length ``ceil(n L / M)``."""
    L, M = rs.design_polyphase(in_rate, out_rate)[2:4]
    n_out = rs.out_len(x.shape[-1], L, M)
    return (lambda: rs.polyphase_fir(x, hist, in_rate, out_rate, n_out),
            lambda: rs.polyphase_fir_plain(x, hist, in_rate, out_rate, n_out))


def resample_case(in_rate: int, out_rate: int, B: int, device, seed: int = 0,
                  stateful: bool = False, cycles: int = 3):
    """K15's case at a rate pair: ``cycles`` x 3 M + 37 inputs a row
    (one-shot; ragged against the cycle) or 3 M x ``cycles`` with a seeded
    history (stateful)."""
    L, M = rs.design_polyphase(in_rate, out_rate)[2:4]
    n = 3 * M * cycles + (0 if stateful else 37)
    x = resample_rows(seed, B, n, device)
    hist = resample_rows(seed + 1, B, rs.SINC_LEN - 1, device) if stateful else None
    return resample_pair(x, in_rate, out_rate, hist)


def resample_chunked(x, in_rate: int, out_rate: int, chunk: int):
    """(``resample_stateful`` over ``x`` in chunks of ``chunk`` samples,
    concatenated; one-shot ``resample`` of ``x``), both on ``x``'s device,
    to be held equal bit for bit (``chunk L % M == 0``)."""
    hist = rs.resample_init_state(x.shape[0], x.device)
    outs = []
    for lo in range(0, x.shape[1], chunk):
        o, hist = rs.resample_stateful(x[:, lo:lo + chunk].contiguous(), hist, in_rate, out_rate)
        outs.append(o)
    return torch.cat(outs, dim=1), rs.resample(x, in_rate, out_rate)


def resample_work(B: int, n: int, n_out: int, L: int, stateful: bool = False) -> tuple:
    """(bytes, flops) of K15's function: the rows (and history) read once,
    the output written once, the bank once; 2 x 256 flops an output."""
    nbytes = 4 * (B * n + B * n_out + rs.SINC_LEN * L + L
                  + (B * (rs.SINC_LEN - 1) if stateful else 0))
    return nbytes, 2 * rs.SINC_LEN * B * n_out


def conv1d_library(x, in_rate: int, out_rate: int, hist=None):
    """One ``F.conv1d`` of stride M over the bank embedded in ``[L, 1, S +
    M - 1]`` (cuDNN, in IEEE float32) on the input the plain version pads
    (made beforehand): the library yardstick of K15."""
    from soundkit_tpu_torch.utils.device import ieee_fp32

    L, M = rs.design_polyphase(in_rate, out_rate)[2:4]
    xp = rs.conv_input(x, hist, in_rate, out_rate, rs.out_len(x.shape[1], L, M))
    w = rs._conv_weight(in_rate, out_rate, x.device)

    def run():
        with ieee_fp32():
            return torch.nn.functional.conv1d(xp, w, stride=M)
    return run


def stretch_ola_inputs(seed: int, B: int, T: int, device, F: int = 2048):
    """Seeded synthesis frames f32 [B, T, F] (unit-scale noise) and the
    Hann window f32 [F] on ``device``."""
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.standard_normal((B, T, F)).astype(np.float32)).to(device)
    win = torch.from_numpy(np.hanning(F).astype(np.float32)).to(device)
    return frames, win


def stretch_ola_pair(frames, win, hop: int, target: int):
    """K16 and its plain version."""
    return (lambda: stretch_ola.overlap_add(frames, win, hop, target),
            lambda: stretch_ola.overlap_add_plain(frames, win, hop, target))


def stretch_ola_work(B: int, T: int, F: int, hop: int, target: int) -> int:
    """Bytes of K16's function: the frames that cover the crop window read
    once, the window and the output."""
    last = min(T - 1, (F // 2 + target - 1) // hop)
    return 4 * (B * (last + 1) * F + F + B * target)


def fold_library(frames, win, hop: int, target: int):
    """``F.fold`` with kernel (1, F) and stride (1, hop) over the windowed
    frames, then the divide by the clamped norm and the crop: the library
    yardstick of K16 (the windowed frames and the norm made beforehand)."""
    B, T, F = frames.shape
    out_len = hop * (T - 1) + F
    cols = (frames * win).transpose(1, 2).contiguous()  # [B, F, T]
    norm = torch.nn.functional.fold((win * win)[None, :, None].expand(1, F, T).contiguous(),
                                    (1, out_len), (1, F), stride=(1, hop))[:, 0, 0]
    den = torch.clamp_min(norm, 1e-8)

    def run():
        line = torch.nn.functional.fold(cols, (1, out_len), (1, F), stride=(1, hop))[:, 0, 0]
        return (line / den)[:, F // 2:F // 2 + target]
    return run


def phase_lock_inputs(seed: int, rows: int, K: int, device, span: float = 1e5):
    """Seeded K17 inputs f32 [rows, K]: magnitudes on a grid of quarters
    (ties, flat runs, a constant row), analysis phases in (-pi, pi),
    synthesis phases up to ``span`` rad."""
    rng = np.random.default_rng(seed)
    mag = np.round(np.abs(rng.standard_normal((rows, K))) * 4) / 4
    mag[0, 10:20] = 1.0
    if rows > 1:
        mag[1] = 0.5
    phase = rng.uniform(-np.pi, np.pi, (rows, K))
    syn = rng.uniform(-span, span, (rows, K))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in (mag, phase, syn))


def phase_lock_check(mag, phase, syn) -> dict:
    """K17 against its plain version: ``nearest`` identical and the
    spectrum within ``3 ulp(max(|syn'|, 1)) mag`` elementwise, or
    :class:`KernelMismatch`. Returns ``max_abs_err``, ``rel_err`` (of the
    largest magnitude) and ``max_ulps`` (the largest error in ulps of the
    argument, times the magnitude)."""
    spec, near = phase_lock.phase_lock(mag, phase, syn, with_nearest=True)
    ref, ref_near = phase_lock.phase_lock_plain(mag, phase, syn, with_nearest=True)
    if spec.is_cuda:
        torch.cuda.synchronize()
    if not torch.equal(near, ref_near):
        raise KernelMismatch(f"phase_lock: nearest differs at "
                             f"{int((near != ref_near).sum())} bins")
    idx = ref_near.long()
    s = phase + (torch.take_along_dim(syn, idx, -1) - torch.take_along_dim(phase, idx, -1))
    ulp = torch.exp2(torch.floor(torch.log2(torch.clamp_min(s.abs(), 1.0))) - 23)
    err = (spec - ref).abs()
    ulps = err / torch.clamp_min(ulp * mag, 1e-30)
    worst = float(ulps.max()) if ulps.numel() else 0.0
    e = float(err.max()) if err.numel() else 0.0
    if not (bool(torch.isfinite(torch.view_as_real(spec)).all()) and worst <= 3.0):
        raise KernelMismatch(f"phase_lock: spectrum {worst:.2f} ulps of the argument off (bound 3)")
    return {"max_abs_err": e, "rel_err": e / max(float(mag.abs().max()), 1e-30),
            "max_ulps": worst}


def phase_lock_work(rows: int, K: int) -> int:
    """Bytes of K17's function: three f32 inputs read once, the complex64
    output written once."""
    return rows * K * (3 * 4 + 8)
