#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's AAC-LC flagship path (v4 wire, 1024 distinct stereo
48 kHz streams from the committed fixtures in ``tests/data/torch_port``)
through ``soundkit_tpu_torch.models.aac_lc_batch.BatchedAacLcDecoder``
on ``cuda``. Phases:

a. build the CUDA kernels and the host parser from the checkout;
b. print the card (``nvidia-smi`` name and power limit), the versions
   and the host (name, CPU model, cores);
c. hold each kernel against its plain PyTorch version on the card at
   the main path's shapes (B = 1024), with the inputs and bounds of
   ``soundkit_tpu_torch.tools.kernel_check``, and time both with CUDA
   events;
d. decode 46 lockstep batches through the decoder, with every launch
   counter reset just before, and check that all batches took the v4
   wire and every kernel of the path launched; hold three batches'
   PCM and carried state against the port's plain path on the CPU
   (same wire buffers); report aggregate x realtime at 48 kHz (host
   parse + h2d + device step per batch, synchronized per batch) and
   the per-layer split the decoder times (parse, h2d, device step);
e. print the kernels' JSON line, then the result line.

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
B = 1024
C = 2
RATE = 48000.0
N_BATCHES = 46
N_COMPARE = 3


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
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
    cases = {
        "spectral_decode": kc.spectral_case(torch.from_numpy(wire0).to(dev), B),
        "tns_filter": kc.tns_case(B, C, dev, seed=5),
        "imdct_window/long": kc.imdct_case(B * C, False, dev, seed=1),
        "imdct_window/short": kc.imdct_case(B * C * 8, True, dev, seed=2),
        "dequant_imdct_window": kc.dequant_imdct_case(B * C, dev, seed=3),
    }
    # the plain K4 and K5 are Python loops of ~1 s and ~0.2 s per call
    plain_reps = {"spectral_decode": 2, "tns_filter": 2}
    res = {}
    for tag, (kernel, plain) in cases.items():
        name = tag.split("/")[0]
        r = kc.compare(name, kernel, plain)
        r["ms"] = cuda_ms(kernel, 20)
        r["plain_ms"] = cuda_ms(plain, plain_reps.get(name, 20))
        log(f"[kernels] {tag}: {r}")
        res[tag] = r
    long, short = res.pop("imdct_window/long"), res.pop("imdct_window/short")
    res["imdct_window"] = dict(
        max_abs_err=max(long["max_abs_err"], short["max_abs_err"]),
        rel_err=max(long["rel_err"], short["rel_err"]),
        ms=long["ms"] + short["ms"], plain_ms=long["plain_ms"] + short["plain_ms"],
        ms_long=long["ms"], ms_short=short["ms"],
    )
    return res


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


def main() -> int:
    if not (ROOT / "soundkit_tpu_torch").is_dir() or not (ROOT / "soundkit_tpu").is_dir():
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
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke: phase {phase} failed", file=sys.stderr)
        return 1

    src = "soundkit_tpu_torch/csrc/"
    rows = [
        ("spectral_decode", src + "aac_spectral.cu", "soundkit_tpu/ops/aac_entropy.py:156"),
        ("tns_filter", src + "tns.cu", "soundkit_tpu/ops/aac_batch.py:218"),
        ("imdct_window", src + "imdct_window.cu", "soundkit_tpu/ops/pallas_kernels.py:98"),
    ]
    kernels = [
        dict(name=n, route="cuda", source=s, replaces=r,
             launches=sres["launches"][n], **kres[n])
        for n, s, r in rows
    ]
    off_path = dict(name="dequant_imdct_window", route="cuda", source=src + "imdct_window.cu",
                    replaces="soundkit_tpu/ops/pallas_kernels.py:138",
                    launches=sres["launches"]["dequant_imdct_window"],
                    **kres["dequant_imdct_window"])
    log(json.dumps({"off_path_kernels": [off_path]}))
    log(json.dumps({"slice": sres, "compare": cres, "wall_s": time.perf_counter() - t_start}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
