#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's two paths on ``cuda``: the AAC-LC flagship (v4
wire, 1024 distinct stereo 48 kHz streams from the committed fixtures
in ``tests/data/torch_port``) through
``soundkit_tpu_torch.models.aac_lc_batch.BatchedAacLcDecoder``, and the
batched telephony codecs (G.711 mu/A-law, G.722, G.726 at 16/24/32/40
kbit/s; 1024 distinct lanes per codec from the committed fixtures in
``tests/data/torch_port/telephony``, chunk 2048) through
``soundkit_tpu_torch.models.telephony_batch``. Phases:

a. build the CUDA kernels and the host parser from the checkout;
b. print the card (``nvidia-smi`` name and power limit), the kernels'
   launch shapes (K4's lanes a block and a warp, K6's threads a lane,
   K7's threads a band and steps a tile, K3's codes a thread and threads
   a block, from their sources), the versions and the host (name, CPU
   model, cores);
c. hold each kernel against its plain PyTorch version on the card at
   the main path's shapes (B = 1024), with the inputs and bounds of
   ``soundkit_tpu_torch.tools.kernel_check`` (K4 also on seeded random
   inputs at B = 1001; K5 on every TNS layout there; the ~900-line
   region is the timed one); time the kernel by replaying a CUDA graph
   of 20 launches (device time, no host issue gaps), the plain version
   with CUDA events around its calls, and, for
   K1, ``torch.matmul`` on the same inputs as the library yardstick;
   compute each kernel's bound (the larger of its bytes at 3.35 TB/s and
   its operations at 495 TFLOP/s TF32 or 67 TFLOP/s float32) from the
   case's shapes;
d. decode 46 lockstep batches through the decoder, with every launch
   counter reset just before, and check that all batches took the v4
   wire and every kernel of the path launched; hold three batches'
   PCM and carried state against the port's plain path on the CPU
   (same wire buffers); report aggregate x realtime at 48 kHz (host
   parse + h2d + device step per batch, synchronized per batch) and
   the per-layer split the decoder times (parse, h2d, device step);
e. telephony kernels: K3 (G.711 decode, mixed laws, ragged counts), K6
   (G.726 decode and encode at each rate) and K7 (G.722 decode and
   encode) against their plain versions on the card at the path's
   shapes (B = 1024, 2048 codes), bit-exact, timed by graph replay;
   each scan also from a carried state (512 codes: the plain scans are
   Python loops, most of this phase's time); beside K3,
   an empty kernel on K3's grid (``launch_floor_ms``: what the launch
   alone costs);
f. telephony compare: per codec, two full-width decoder steps and one
   encoder step on the card against the port's plain path on the CPU,
   from the same pushes: PCM, lengths, bytes and carried state equal;
g. telephony: per codec, every lane's stream through
   ``BatchedTelephonyDecoder(timed=True)`` until all lanes drain, then
   every lane's PCM through ``BatchedTelephonyEncoder``, launch counters
   reset just before; checks that the codec's kernel launched on every
   step, that the output is not silent and that every pushed code came
   out; one ``[telephony]`` line per codec (x realtime at the codec's
   rate, step times, the decoder's pack / h2d / step split);
h. print the kernels' JSON line (all seven kernels, K2 with no launch:
   it is not on a path), then the result line.

Any failed phase exits non-zero before the result line. Without a
CUDA device, or outside a checkout of the repository, it exits 1
without a result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# NVIDIA H100 SXM peaks (data sheet): HBM bytes/s, dense TF32 and float32 FLOP/s
HBM_RATE = 3.35e12
TF32_RATE = 495e12
FP32_RATE = 67e12
B = 1024
C = 2
RATE = 48000.0
N_BATCHES = 46
N_COMPARE = 3
TEL_CHUNK = 2048
TEL_COMPARE_STEPS = 2


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean time of ``fn`` over ``reps`` calls, by CUDA events on the
    stream (host issue gaps count)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one ``fn`` call: a CUDA graph of ``reps`` calls,
    replayed ``replays`` times between CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


def bound(nbytes: float, flops: float = 0.0, rate: float = FP32_RATE) -> dict:
    """The least time the card could take: bytes at HBM_RATE against
    operations at ``rate``, whichever is larger."""
    t_bytes, t_ops = 1e3 * nbytes / HBM_RATE, 1e3 * flops / rate
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def measure(tag: str, name: str, kernel, plain, nbytes: float, flops: float = 0.0,
            rate: float = FP32_RATE, plain_reps: int = 20, library=None) -> dict:
    """Hold ``kernel`` to ``plain`` and time both (and ``library``)."""
    from soundkit_tpu_torch.tools import kernel_check as kc

    r = kc.compare(name, kernel, plain)
    r["ms"] = graph_ms(kernel)
    r["plain_ms"] = cuda_ms(plain, plain_reps)
    r.update(bound(nbytes, flops, rate))
    r["library_ms"] = None if library is None else graph_ms(library)
    log(f"[kernels] {tag}: {r}")
    return r


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    from soundkit_tpu_torch import _build

    t0 = time.perf_counter()
    kpath = _build.kernel_library_path()
    t1 = time.perf_counter()
    ppath = _build.parser_library_path()
    t2 = time.perf_counter()
    _build.kernels()
    log(f"[build] kernels {kpath.relative_to(ROOT)} in {t1 - t0:.3f} s; "
        f"parser {ppath.relative_to(ROOT)} in {t2 - t1:.3f} s")
    blog = kpath.with_suffix(".log")
    if blog.exists():
        for line in blog.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("[build] " + line.strip())


def host_cpu() -> str:
    """The host's CPU as the first entry of ``/proc/cpuinfo`` names it
    (vendor, family, model, model name and clock; a sandboxed kernel
    may report the model name as unknown)."""
    import platform

    try:
        with open("/proc/cpuinfo") as f:
            first = f.read().split("\n\n")[0]
    except OSError as e:
        return f"{platform.processor() or 'unknown'} (/proc/cpuinfo: {e.strerror})"
    info = dict(line.split(":", 1) for line in first.splitlines() if ":" in line)
    info = {k.strip(): v.strip() for k, v in info.items()}
    keys = ("vendor_id", "cpu family", "model", "model name", "cpu MHz")
    return ", ".join(f"{k} {info[k]}" for k in keys if k in info) or "unknown"


def cu_constant(source: str, name: str) -> int:
    """The value of ``constexpr int <name>`` in ``csrc/<source>``."""
    import re

    m = re.search(rf"constexpr int {name} = (\d+);",
                  (ROOT / "soundkit_tpu_torch" / "csrc" / source).read_text())
    check(m is not None, f"csrc/{source} defines no {name}")
    return int(m.group(1))


def phase_card() -> str:
    import os
    import socket

    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip()
    log(card)
    log(f"[config] K4 lanes per block {cu_constant('aac_spectral.cu', 'LANES_PER_BLOCK')}, "
        f"lanes per warp {cu_constant('aac_spectral.cu', 'LANES_PER_WARP')}; "
        f"K6 threads per lane {cu_constant('g726.cu', 'G')}; "
        f"K7 threads per band {cu_constant('g722.cu', 'G')}, steps per tile "
        f"{cu_constant('g722.cu', 'TILE')}; K3 codes per thread {cu_constant('g711.cu', 'VEC')}, "
        f"threads per block {cu_constant('g711.cu', 'THREADS')}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}; host {socket.gethostname()} "
        f"cpu {host_cpu()} cores {os.cpu_count()} usable {len(os.sched_getaffinity(0))}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_kernels(wire0):
    """Each kernel against its plain version on the card, B = 1024."""
    import torch

    from soundkit_tpu_torch.tools import kernel_check as kc

    dev = torch.device("cuda", 0)
    rows = B * C
    wire = torch.from_numpy(wire0).to(dev)
    f = 4  # bytes of a float32 or int32
    res = {}
    res["spectral_decode"] = phase_spectral(wire)
    # K5: coef, perm, filt_id and out rows, the LPC taps; at most 40 FLOP a line
    tns_bytes = rows * 1024 * 4 * 4 + rows * 8 * 20 * f
    res["tns_filter"] = measure("tns_filter/long", "tns_filter", *kc.tns_case(B, C, dev, 5, kind="long"),
                                nbytes=tns_bytes, flops=40 * rows * 1024, plain_reps=2)
    cases = {}
    for kind in kc.TNS_KINDS[1:]:
        kernel, plain = kc.tns_case(B, C, dev, 6, kind=kind)
        r = kc.compare("tns_filter", kernel, plain)
        r["ms"] = graph_ms(kernel)
        log(f"[kernels] tns_filter/{kind}: {r}")
        cases[kind] = r
    res["tns_filter"]["cases"] = cases
    res["tns_filter"]["max_abs_err"] = max(r["max_abs_err"] for r in (res["tns_filter"], *cases.values()))
    res["tns_filter"]["rel_err"] = max(r["rel_err"] for r in (res["tns_filter"], *cases.values()))

    def synthesis(L, K, N):
        # A, the K-major basis, the window bank and indices, out; 3xTF32 products
        nbytes = L * K * f + N * K * f + (16 if N == 2048 else 32) * N * f + L * 4 + L * N * f
        return dict(nbytes=nbytes, flops=3 * 2 * L * K * N, rate=TF32_RATE)

    long = measure("imdct_window/long", "imdct_window", *kc.imdct_case(rows, False, dev, seed=1),
                   library=kc.imdct_library(rows, False, dev, seed=1), **synthesis(rows, 1024, 2048))
    short = measure("imdct_window/short", "imdct_window", *kc.imdct_case(rows * 8, True, dev, seed=2),
                    library=kc.imdct_library(rows * 8, True, dev, seed=2),
                    **synthesis(rows * 8, 128, 256))
    res["imdct_window"] = {
        "max_abs_err": max(long["max_abs_err"], short["max_abs_err"]),
        "rel_err": max(long["rel_err"], short["rel_err"]),
        **{k: long[k] + short[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": long["bound_by"], "long": long, "short": short,
        # the same products on plain FFMA, for comparison
        "bound_ms_ffma": sum(1e3 * 2 * L * K * N / FP32_RATE
                             for L, K, N in ((rows, 1024, 2048), (rows * 8, 128, 256))),
    }
    dq = synthesis(rows, 1024, 2048)
    dq["nbytes"] += rows * 1024 * 4  # quant and scale in place of coef
    res["dequant_imdct_window"] = measure(
        "dequant_imdct_window", "dequant_imdct_window", *kc.dequant_imdct_case(rows, dev, seed=3), **dq)
    return res


def phase_spectral(wire):
    """K4 on the fixture wire (the timed case) and on random inputs at
    B = 1001 (2002 lanes, no multiple of a block's lanes); both
    bit-exact."""
    import torch

    from soundkit_tpu_torch.ops import aac_batch as ab
    from soundkit_tpu_torch.ops import aac_entropy as ae
    from soundkit_tpu_torch.tools import kernel_check as kc

    dev = torch.device("cuda", 0)
    # AU bytes, bit offsets, run programs and counts (int32), the two-level table; quant out
    table = ae.build_spectral_lut2().nbytes
    kernel, plain = kc.spectral_case(wire, B)
    r = measure("spectral_decode", "spectral_decode", kernel, plain,
                nbytes=B * 1024 + 2 * B * 4 + 2 * B * 128 * 4 + 2 * B * 4 + table + 2 * B * 1024 * 4,
                plain_reps=2)
    f = ab.unpack_v4_wire(wire, B)
    r["longest_lane_codewords"] = int(kc.spectral_codewords(
        f["runs"].reshape(2 * B, -1), f["n_runs"].reshape(-1)).max())
    rand_B = 1001
    rand_args = kc.spectral_random_inputs(rand_B, seed=7)
    r["random_longest_lane_codewords"] = int(kc.spectral_codewords(rand_args[2], rand_args[3]).max())
    rk, rp = kc.spectral_random_case(rand_B, dev, seed=7)
    r["max_abs_err"] = max(r["max_abs_err"], kc.compare("spectral_decode", rk, rp)["max_abs_err"])
    r["random_ms"] = graph_ms(rk)
    log(f"[kernels] spectral_decode/random: B = {rand_B} {r['random_ms']} ms, bit-exact; longest "
        f"lane {r['longest_lane_codewords']} codewords (random {r['random_longest_lane_codewords']})")
    return r


def phase_compare(wires):
    """The card's slice against the port's plain path on the CPU, on
    the same wire buffers: quant exact, PCM and state >= 100 dB."""
    import torch

    from soundkit_tpu_torch.ops import aac_batch as ab
    from soundkit_tpu_torch.ops import aac_entropy as ae

    def run(device):
        saved, prev = ab.init_state(B, C, device)
        pcms, quants = [], []
        for w in wires:
            buf = torch.from_numpy(w).to(device)
            f = ab.unpack_v4_wire(buf, B)
            quants.append(ae.spectral_decode(
                f["au"], f["spec_bit"].reshape(-1).to(torch.int32),
                f["runs"].reshape(2 * B, -1).to(torch.int32),
                f["n_runs"].reshape(-1).to(torch.int32)).cpu())
            pcm, saved, prev = ab.decode_frame_v4_packed(buf, prev, saved)
            pcms.append(pcm.cpu())
        return torch.stack(pcms), torch.stack(quants), saved.cpu(), prev.cpu()

    t0 = time.perf_counter()
    g_pcm, g_q, g_saved, g_prev = run(torch.device("cuda", 0))
    t1 = time.perf_counter()
    c_pcm, c_q, c_saved, c_prev = run(torch.device("cpu"))
    t2 = time.perf_counter()
    check(torch.equal(g_q, c_q), "card vs CPU: quantized spectra differ")
    check(torch.equal(g_prev, c_prev), "card vs CPU: carried window shapes differ")

    def lane_snr(got, ref):
        # per stream over every frame and channel: [n, B, C, N] -> [B]
        got = got.double().transpose(0, 1).reshape(B, -1)
        ref = ref.double().transpose(0, 1).reshape(B, -1)
        sig = (ref ** 2).sum(1)
        err = ((got - ref) ** 2).sum(1)
        silent = sig == 0
        check(bool((err[silent] == 0).all()), "card vs CPU: output on a silent lane")
        snr = 10 * torch.log10(sig[~silent] / err[~silent].clamp_min(1e-300))
        return snr.min().item(), int((~silent).sum())

    snr_pcm, n_pcm = lane_snr(g_pcm, c_pcm)
    snr_state, n_state = lane_snr(g_saved[None], c_saved[None])
    log(f"[compare] {len(wires)} batches x {B} lanes: quant exact; min lane PCM SNR "
        f"{snr_pcm:.2f} dB over {n_pcm} lanes; min lane state SNR {snr_state:.2f} dB "
        f"over {n_state} lanes (card {t1 - t0:.3f} s incl. warm-up, CPU plain {t2 - t1:.3f} s)")
    check(snr_pcm >= 100.0 and snr_state >= 100.0, "card vs CPU: SNR below 100 dB")
    return dict(min_pcm_snr_db=snr_pcm, min_state_snr_db=snr_state)


def phase_slice(clips):
    """46 batches through the decoder; launch counters reset just before."""
    import torch

    from soundkit_tpu_torch.models.aac_lc_batch import BatchedAacLcDecoder
    from soundkit_tpu_torch.ops import aac_batch as ab
    from soundkit_tpu_torch.ops import aac_entropy as ae
    from soundkit_tpu_torch.ops import imdct
    from soundkit_tpu_torch.tools.aac_fixtures import lane_streams

    model = BatchedAacLcDecoder(B, C, device="cuda", timed=True)
    for i, data in enumerate(lane_streams(clips, B, N_BATCHES)):
        model.push(i, data)
    check(model.ready_frames == N_BATCHES, f"ready_frames {model.ready_frames}")

    wrappers = {"spectral_decode": ae.spectral_decode, "tns_filter": ab.tns_filter,
                "imdct_window": imdct.imdct_window,
                "dequant_imdct_window": imdct.dequant_imdct_window}
    for w in wrappers.values():
        w.launches = 0
    times = []
    all_finite = True
    for _ in range(N_BATCHES):
        t0 = time.perf_counter()
        pcm = model.decode_batches(1, device_out=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        all_finite &= bool(torch.isfinite(pcm).all())
    launches = {name: w.launches for name, w in wrappers.items()}

    check(tuple(pcm.shape) == (1, B, C, 1024), f"pcm shape {tuple(pcm.shape)}")
    check(all_finite, "non-finite PCM on the card")
    check(model.v4_batches == N_BATCHES and model.full_wire_batches == 0,
          f"v4 batches {model.v4_batches}, full-wire batches {model.full_wire_batches}")
    for name in ("spectral_decode", "tns_filter", "imdct_window"):
        check(launches[name] > 0, f"{name} was not launched on the main path")
    rms = pcm.double().pow(2).mean().sqrt().item()
    check(rms > 1e-4, f"last batch is silent (rms {rms})")

    audio_s = N_BATCHES * B * 1024 / RATE
    total = sum(times)
    srt = sorted(times)
    stages = model.stage_ms()
    res = dict(
        batches=N_BATCHES, v4_batches=model.v4_batches,
        full_wire_batches=model.full_wire_batches,
        xrealtime=audio_s / total, total_s=total,
        batch_ms_median=1e3 * srt[len(srt) // 2], batch_ms_first=1e3 * times[0],
        batch_ms_max=1e3 * srt[-1],
        parse_ms_median=stages["parse"], h2d_ms_median=stages["h2d"],
        step_ms_median=stages["step"], last_batch_rms=rms, launches=launches,
    )
    log(f"[slice] {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# telephony phases
# ---------------------------------------------------------------------------

def _merge_cases(res: dict, decode: list, encode: list) -> dict:
    """One kernel row from its decode and encode cases: times and bounds
    summed per direction (as the imdct row sums its two shapes), errors
    maxed."""
    return dict(
        max_abs_err=max(res[t]["max_abs_err"] for t in decode + encode),
        rel_err=max(res[t]["rel_err"] for t in decode + encode),
        ms=sum(res[t]["ms"] for t in decode), plain_ms=sum(res[t]["plain_ms"] for t in decode),
        bound_ms=sum(res[t]["bound_ms"] for t in decode), bound_by="bytes", library_ms=None,
        encode_ms=sum(res[t]["ms"] for t in encode),
        encode_plain_ms=sum(res[t]["plain_ms"] for t in encode),
        encode_bound_ms=sum(res[t]["bound_ms"] for t in encode),
        cases={t.split("/")[1]: {k: res[t][k] for k in ("ms", "plain_ms", "bound_ms")}
               for t in decode + encode},
    )


def phase_tel_kernels():
    """K3, K6 and K7 against their plain versions on the card at the
    telephony path's shapes (B = 1024, 2048 codes), bit-exact."""
    import torch

    from soundkit_tpu_torch.tools import kernel_check as kc

    dev = torch.device("cuda", 0)
    N = TEL_CHUNK
    cases = {"g711_decode/decode": kc.g711_case(B, N, dev, seed=11)}
    # bytes each case moves: codes (u8), PCM (int16), the per-step mask
    # (bool), the state in and out (int32 rows of 24 / 70); K3 reads its
    # law and count per lane
    nbytes = {"g711_decode/decode": B * N + 2 * B * 4 + B * N * 2}
    for enc in (False, True):
        for carried in (False, True):
            n = N // 4 if carried else N
            suffix = ("encode" if enc else "decode", "_carried" * carried)
            for bits in (2, 3, 4, 5):
                tag = f"g726_scan/{suffix[0]}_{8 * bits}{suffix[1]}"
                cases[tag] = kc.g726_case(B, n, bits, enc, dev, seed=20 + 2 * bits + enc,
                                          carried=carried)
                nbytes[tag] = B * n + B * n * 2 + B * n + 2 * B * 24 * 4
            tag = f"g722_scan/{suffix[0]}{suffix[1]}"
            cases[tag] = kc.g722_case(B, n, enc, dev, seed=30 + enc, carried=carried)
            nbytes[tag] = B * n + B * 2 * n * 2 + B * n + 2 * B * 70 * 4
    res = {}
    for tag, (kernel, plain) in cases.items():
        name = tag.split("/")[0]
        if name == "g711_decode":
            r = kc.compare(name, kernel, plain)
            r["plain_ms"] = cuda_ms(plain, 20)
        else:
            # the plain scans are Python loops of 2048 steps, host-bound:
            # time the one call that the comparison makes
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

            def timed_plain(plain=plain):
                events[0].record()
                out = plain()
                events[1].record()
                return out

            r = kc.compare(name, kernel, timed_plain)
            r["plain_ms"] = events[0].elapsed_time(events[1])
        r["ms"] = graph_ms(kernel) if name == "g711_decode" else graph_ms(kernel, reps=5, replays=2)
        r.update(bound(nbytes[tag]))
        r["library_ms"] = None
        if name == "g711_decode":
            r["launch_floor_ms"] = graph_ms(kc.g711_launch_floor(B, N, dev))
        log(f"[tel-kernels] {tag}: {r}")
        res[tag] = r

    def scan_row(name: str) -> dict:
        # times from the initial-state cases; the carried cases give their errors
        first = [t for t in res if t.startswith(name + "/") and not t.endswith("_carried")]
        return {
            **_merge_cases(res, [t for t in first if "decode" in t], [t for t in first if "encode" in t]),
            "carried": {t.split("/")[1]: res[t]["max_abs_err"] for t in res
                        if t.startswith(name + "/") and t.endswith("_carried")},
        }

    return {
        "g711_decode": {k: res["g711_decode/decode"][k]
                        for k in ("max_abs_err", "rel_err", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms", "launch_floor_ms")},
        "g726_scan": scan_row("g726_scan"),
        "g722_scan": scan_row("g722_scan"),
    }


def tel_compare_run(codec: str, device: str) -> dict:
    """The telephony path of one codec on ``device`` over the smoke
    lanes: ``TEL_COMPARE_STEPS`` decoder steps and one encoder step,
    everything returned as numpy. Runs in a worker process for the CPU."""
    import torch

    from soundkit_tpu_torch.models.telephony_batch import (
        BatchedTelephonyDecoder, BatchedTelephonyEncoder)
    from soundkit_tpu_torch.tools import telephony_fixtures as tf

    if device == "cpu":
        torch.set_num_threads(1)  # one worker per codec shares the host's cores
    t0 = time.perf_counter()
    dec = BatchedTelephonyDecoder(codec, B, TEL_CHUNK, device=device)
    for i, data in enumerate(tf.lane_streams(codec, B)):
        dec.push(i, data)
    steps = [dec.decode_step() for _ in range(TEL_COMPARE_STEPS)]
    enc = BatchedTelephonyEncoder(codec, B, TEL_CHUNK, device=device)
    for i, pcm in enumerate(tf.lane_pcm(codec, B)):
        enc.push(i, pcm)
    wire = enc.encode_step()
    return dict(steps=steps, wire=wire,
                dec_state=None if dec.state is None else dec.state.cpu().numpy(),
                enc_state=None if enc.state is None else enc.state.cpu().numpy(),
                seconds=time.perf_counter() - t0)


def phase_tel_compare():
    """Per codec: two full-width decoder steps and one encoder step on
    the card against the port's plain path on the CPU, same pushes. The
    CPU runs go to one spawned worker process per codec, all at once."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from soundkit_tpu_torch.models.telephony_batch import CODECS

    out = {}
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=len(CODECS), mp_context=ctx) as pool:
        cpu_runs = {codec: pool.submit(tel_compare_run, codec, "cpu") for codec in CODECS}
        for codec in CODECS:
            card = tel_compare_run(codec, "cuda")
            cpu = cpu_runs[codec].result()
            for step, ((g_pcm, g_lens), (c_pcm, c_lens)) in enumerate(zip(card["steps"], cpu["steps"])):
                check(np.array_equal(g_pcm, c_pcm), f"{codec}: card vs CPU PCM differ at step {step}")
                check(np.array_equal(g_lens, c_lens), f"{codec}: lengths differ at step {step}")
                check(np.abs(g_pcm).max() > 0, f"{codec}: silent step {step}")
            check(card["wire"] == cpu["wire"], f"{codec}: card vs CPU encoded bytes differ")
            for key in ("dec_state", "enc_state"):
                check((card[key] is None and cpu[key] is None) or np.array_equal(card[key], cpu[key]),
                      f"{codec}: card vs CPU {key} differs")
            out[codec] = dict(samples=int(sum(lens.sum() for _, lens in card["steps"])),
                              wire_bytes=sum(map(len, card["wire"])),
                              card_s=card["seconds"], cpu_s=cpu["seconds"])
            log(f"[tel-compare] {codec}: {TEL_COMPARE_STEPS} decoder steps and 1 encoder step x {B} "
                f"lanes identical (PCM, lengths, bytes, state); card {card['seconds']:.3f} s, "
                f"CPU plain {cpu['seconds']:.3f} s in its worker")
    return out


def phase_telephony():
    """Every codec's lanes through the decoder until they drain, then
    through the encoder; launch counters reset just before."""
    import torch

    from soundkit_tpu_torch.models.telephony_batch import (
        CODECS, BatchedTelephonyDecoder, BatchedTelephonyEncoder)
    from soundkit_tpu_torch.ops import adpcm, companding, g722
    from soundkit_tpu_torch.tools import telephony_fixtures as tf

    wrappers = {"g711_decode": companding.g711_decode,
                "g726_decode_scan": adpcm.g726_decode_scan,
                "g726_encode_scan": adpcm.g726_encode_scan,
                "g722_decode_scan": g722.g722_decode_scan,
                "g722_encode_scan": g722.g722_encode_scan}
    for w in wrappers.values():
        w.launches = 0
    res = {}
    for codec in CODECS:
        family = codec.split("_")[0]
        dec_w = "g711_decode" if family == "g711" else f"{family}_decode_scan"
        enc_w = None if family == "g711" else f"{family}_encode_scan"
        rate = tf.sample_rate(codec)
        spb = tf.samples_per_byte(codec)

        streams = tf.lane_streams(codec, B)
        model = BatchedTelephonyDecoder(codec, B, TEL_CHUNK, device="cuda", timed=True)
        for i, data in enumerate(streams):
            model.push(i, data)
        codes = [round(len(s) * spb) // model.samples_per_code for s in streams]
        steps = -(-max(codes) // TEL_CHUNK)
        before = wrappers[dec_w].launches
        times, produced = [], 0
        peak = torch.zeros((), dtype=torch.int32, device="cuda")
        for _ in range(steps):
            t0 = time.perf_counter()
            pcm, lens = model.decode_step(device_out=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            produced += int(lens.sum())
            peak = torch.maximum(peak, pcm.abs().max().to(torch.int32))
        launched = wrappers[dec_w].launches - before
        check(launched == steps, f"{codec}: {dec_w} launched {launched} times in {steps} steps")
        check(produced == sum(codes) * model.samples_per_code,
              f"{codec}: produced {produced} samples of {sum(codes) * model.samples_per_code}")
        check(tuple(pcm.shape) == (B, TEL_CHUNK * model.samples_per_code), f"pcm {tuple(pcm.shape)}")
        check(int(peak) > 0, f"{codec}: silent decode")
        stages = model.stage_ms()

        pcms = tf.lane_pcm(codec, B)
        enc = BatchedTelephonyEncoder(codec, B, TEL_CHUNK, device="cuda")
        for i, p in enumerate(pcms):
            enc.push(i, p)
        enc_steps = -(-max(len(p) for p in pcms) // TEL_CHUNK)
        e_before = wrappers[enc_w].launches if enc_w else 0
        t0 = time.perf_counter()
        n_bytes = sum(sum(map(len, enc.encode_step())) for _ in range(enc_steps))
        enc_wall = time.perf_counter() - t0
        want_bytes = sum(round(len(p) / spb) for p in pcms)
        check(n_bytes == want_bytes, f"{codec}: encoded {n_bytes} bytes of {want_bytes}")
        if enc_w:
            e_launched = wrappers[enc_w].launches - e_before
            check(e_launched == enc_steps,
                  f"{codec}: {enc_w} launched {e_launched} times in {enc_steps} steps")

        wall = sum(times)
        srt = sorted(times)
        r = dict(codec=codec, lanes=B, chunk=TEL_CHUNK, steps=steps, rate=rate,
                 xrealtime=produced / rate / wall, total_s=wall,
                 step_ms_median=1e3 * srt[len(srt) // 2], step_ms_max=1e3 * srt[-1],
                 pack_ms_median=stages["pack"], h2d_ms_median=stages["h2d"],
                 device_step_ms_median=stages["step"], samples=produced,
                 enc_steps=enc_steps, enc_xrealtime=sum(map(len, pcms)) / rate / enc_wall,
                 enc_total_s=enc_wall, enc_bytes=n_bytes)
        log(f"[telephony] {json.dumps(r)}")
        res[codec] = r
    launches = {n: w.launches for n, w in wrappers.items()}
    for n, c in launches.items():
        check(c > 0, f"{n} was not launched on the telephony path")
    return res, launches


def main() -> int:
    if not (ROOT / "soundkit_tpu_torch").is_dir() or not (ROOT / "tests" / "data" / "torch_port").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    t_start = time.perf_counter()
    phase = "build"
    try:
        phase_build()
        phase = "card"
        card = phase_card()

        from soundkit_tpu_torch.native import AacHostParser
        from soundkit_tpu_torch.tools.aac_fixtures import batch_aus, clip_aus, load_clips

        clips = load_clips()
        aus = clip_aus(clips)
        parser = AacHostParser(3)  # 48 kHz
        wires = []
        for t in range(N_COMPARE):
            buf, overflow = parser.pack_v4(batch_aus(aus, B, t))
            check(not overflow, f"v4 overflow on smoke batch {t}")
            wires.append(buf)

        phase = "kernels"
        kres = phase_kernels(wires[0])
        phase = "compare"
        cres = phase_compare(wires)
        phase = "slice"
        sres = phase_slice(clips)
        phase = "tel-kernels"
        tkres = phase_tel_kernels()
        phase = "tel-compare"
        tcres = phase_tel_compare()
        phase = "telephony"
        tres, tlaunches = phase_telephony()
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke: phase {phase} failed", file=sys.stderr)
        return 1

    src = "soundkit_tpu_torch/csrc/"
    # (name, source, TPU function it replaces, on the AAC path)
    rows = [
        ("spectral_decode", "aac_spectral.cu", "soundkit_tpu/ops/aac_entropy.py:156", True),
        ("tns_filter", "tns.cu", "soundkit_tpu/ops/aac_batch.py:218", True),
        ("imdct_window", "imdct_window.cu", "soundkit_tpu/ops/pallas_kernels.py:98", True),
        ("dequant_imdct_window", "imdct_window.cu", "soundkit_tpu/ops/pallas_kernels.py:138", False),
    ]
    kernels = [
        dict(name=n, route="cuda", source=src + s, replaces=r, on_path=on_path,
             launches=sres["launches"][n], launches_per_step=sres["launches"][n] / N_BATCHES,
             **kres[n])
        for n, s, r, on_path in rows
    ]
    tel_rows = [
        ("g711_decode", "g711.cu", "soundkit_tpu/ops/pallas_kernels.py:62", ("g711_decode",)),
        ("g726_scan", "g726.cu", "soundkit_tpu/ops/adpcm.py:369",
         ("g726_decode_scan", "g726_encode_scan")),
        ("g722_scan", "g722.cu", "soundkit_tpu/ops/g722.py:284",
         ("g722_decode_scan", "g722_encode_scan")),
    ]
    # decoder steps of the kernel's codecs, and encoder steps where it encodes too
    steps = {n: sum(r["steps"] + (r["enc_steps"] if n != "g711_decode" else 0)
                    for codec, r in tres.items() if codec.startswith(n.split("_")[0]))
             for n, *_ in tel_rows}
    kernels += [
        dict(name=n, route="cuda", source=src + s, replaces=r, on_path=True,
             launches=sum(tlaunches[w] for w in ws),
             launches_per_step=sum(tlaunches[w] for w in ws) / steps[n],
             launches_by_wrapper={w: tlaunches[w] for w in ws}, **tkres[n])
        for n, s, r, ws in tel_rows
    ]
    log(json.dumps({"slice": sres, "compare": cres, "telephony": tres,
                    "telephony_compare": tcres, "wall_s": time.perf_counter() - t_start}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
