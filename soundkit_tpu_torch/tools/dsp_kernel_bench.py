"""Time K15, K16 and K17 on the card beside their first designs, K15 and
K16 over the launch plans they can take.

K15 (``ops.resample.launch_k15``) runs on the two shapes the paths give it
(the transcode chunk: 1024 x 28,224 samples and a history, 44.1 -> 8 kHz;
the pitch shift's resample: 1024 x 165,375, 3000 -> 2000) with the plan
``k15_plan`` chooses and every other plan it can give (1, 2, 4, 8
super-cycles a thread; as many slabs as fit; the bank read through L1 or
staged in shared memory),
each held bit for bit to the chosen plan's output and to the first design
(``tools/first_designs``). K17 runs on the phase vocoder's tensors for
1024 lanes of 2 s (tones and noise, ``kernel_check.resample_rows``),
against its first design (nearest identical). K16 runs on the irfft of
K17's spectrum there ([1024, 348, 2048], hop 960 -> [1024, 165375]) with
the vector width ``k16_vector`` chooses and the others (V = 4, 2, 1
outputs a thread), each bit for bit the first design's output.
Everything is timed by CUDA graph replay, the chosen plan in turns with
the first design (first design, kernel, kernel, first design), the other
plans twice. Prints one JSON line (also written to ``--out``), with the card's name and power
limit. From the repository's root, on a machine with the card::

    python -m soundkit_tpu_torch.tools.dsp_kernel_bench
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from soundkit_tpu_torch import _build
from soundkit_tpu_torch.ops import phase_lock, stretch_ola
from soundkit_tpu_torch.ops import resample as rs
from soundkit_tpu_torch.ops import stretch as st
from soundkit_tpu_torch.tools import first_designs as fd
from soundkit_tpu_torch.tools import kernel_check as kc
from soundkit_tpu_torch.tools.flac_analyze_bench import graph_ms

LANES = 1024
SHAPES = {"transcode": (44100, 8000, 49 * 576, True), "stretch": (3000, 2000, 165375, False)}


def k15_plans(in_rate: int, out_rate: int, n_out: int) -> list:
    """The chosen plan first, then every other distinct plan."""
    plans = [rs.k15_plan(in_rate, out_rate, n_out)]
    for ws in (0, 1):
        for rc in rs.CYCLES_PER_THREAD:
            for slabs in (None, 1, 2, 3, 4, 8, 16):
                try:
                    p = rs.k15_plan(in_rate, out_rate, n_out, rc=rc, slabs=slabs, ws=ws)
                except ValueError:
                    continue
                if p not in plans:
                    plans.append(p)
    return plans


def occupancy(plan) -> dict:
    occ = (ctypes.c_int * 3)()
    if _build.kernels().skt_resample_occupancy(plan.RC, plan.WS, plan.threads, plan.smem, occ):
        return {}
    return dict(registers=occ[0], local_bytes=occ[1], warps_per_sm=occ[2] * plan.threads // 32)


def bench_k15(dev, rounds: int) -> dict:
    out = {}
    for name, (a, b, n, with_hist) in SHAPES.items():
        L, M = rs.design_polyphase(a, b)[2:4]
        x = kc.resample_rows(10, LANES, n, dev)
        hist = kc.resample_rows(11, LANES, rs.SINC_LEN - 1, dev) if with_hist else None
        n_out = rs.out_len(n, L, M)
        first = lambda: fd.polyphase_fir(x, hist, a, b, n_out)  # noqa: E731
        ref = first()
        runs = []
        for i, plan in enumerate(k15_plans(a, b, n_out)):
            call = lambda p=plan: rs.launch_k15(x, hist, a, b, n_out, p)  # noqa: E731
            same = bool(torch.equal(call(), ref))
            if i:  # another plan: the kernel twice
                turns = [graph_ms(call), graph_ms(call)]
                runs.append(dict(plan=plan._asdict(), equal_to_first=same, turns_ms=turns,
                                 ms=sum(turns) / 2, **occupancy(plan)))
                continue
            turns = []
            for _ in range(rounds):
                turns += [graph_ms(first), graph_ms(call), graph_ms(call), graph_ms(first)]
            runs.append(dict(plan=plan._asdict(), equal_to_first=same, turns_ms=turns,
                             ms=sum(turns[1::4] + turns[2::4]) / (2 * rounds),
                             first_ms=sum(turns[0::4] + turns[3::4]) / (2 * rounds),
                             **occupancy(plan)))
        nbytes, flops = kc.resample_work(LANES, n, n_out, L, with_hist)
        out[name] = dict(rows=LANES, n=n, n_out=n_out, L=L, M=M, bound_ms=max(
            1e3 * nbytes / 3.35e12, 1e3 * flops / 67e12), plans=runs)
        del x, hist, ref
        torch.cuda.empty_cache()
    return out


def bench_k17(dev, rounds: int) -> dict:
    x = kc.resample_rows(12, LANES, 88200, dev)
    mag, phase, syn = st.vocoder_analysis(x, 1.875)[:3]
    del x
    check = kc.phase_lock_check(mag, phase, syn)
    near = phase_lock.phase_lock(mag, phase, syn, with_nearest=True)[1]
    same = bool(torch.equal(near, fd.phase_lock(mag, phase, syn, with_nearest=True)[1]))
    del near
    kernel = lambda: phase_lock.phase_lock(mag, phase, syn)  # noqa: E731
    first = lambda: fd.phase_lock(mag, phase, syn)  # noqa: E731
    turns = []
    for _ in range(rounds):
        turns += [graph_ms(first, 2, 3), graph_ms(kernel, 2, 3), graph_ms(kernel, 2, 3),
                  graph_ms(first, 2, 3)]
    rows, K = mag.numel() // mag.shape[-1], mag.shape[-1]
    occ = (ctypes.c_int * 4)()
    _build.kernels().skt_phase_lock_occupancy(K, occ)
    return dict(rows=rows, K=K, syn_abs_max=float(syn.abs().max()), nearest_equal_to_first=same,
                **check, turns_ms=turns, ms=sum(turns[1::4] + turns[2::4]) / (2 * rounds),
                first_ms=sum(turns[0::4] + turns[3::4]) / (2 * rounds),
                bound_ms=1e3 * kc.phase_lock_work(rows, K) / 3.35e12, registers=occ[0],
                local_bytes=occ[1], smem=occ[2], warps_per_sm=occ[3] * 8)


def bench_k16(dev, rounds: int) -> dict:
    x = kc.resample_rows(13, LANES, 88200, dev)
    mag, phase, syn, win, hop, target = st.vocoder_analysis(x, 1.875)
    del x
    spec = phase_lock.phase_lock(mag, phase, syn)
    del mag, phase, syn
    frames = torch.fft.irfft(spec, n=st.FRAME, dim=-1)
    del spec
    B, T, F = frames.shape
    first = lambda: fd.overlap_add(frames, win, hop, target)  # noqa: E731
    ref = first()
    chosen = stretch_ola.k16_vector(F, hop, F // 2, frames.data_ptr(), win.data_ptr())
    runs = []
    occ = (ctypes.c_int * 4)()
    for i, V in enumerate([chosen, *(v for v in (4, 2, 1) if v != chosen)]):
        call = lambda v=V: stretch_ola.launch_k16(frames, win, hop, target, v)  # noqa: E731
        same = bool(torch.equal(call(), ref))
        _build.kernels().skt_stretch_ola_occupancy(V, occ)
        info = dict(V=V, equal_to_first=same, registers=occ[0], local_bytes=occ[1],
                    smem=occ[2], warps_per_sm=occ[3] * 8)
        if i:
            turns = [graph_ms(call), graph_ms(call)]
            runs.append(dict(info, turns_ms=turns, ms=sum(turns) / 2))
            continue
        turns = []
        for _ in range(rounds):
            turns += [graph_ms(first), graph_ms(call), graph_ms(call), graph_ms(first)]
        runs.append(dict(info, turns_ms=turns, ms=sum(turns[1::4] + turns[2::4]) / (2 * rounds),
                         first_ms=sum(turns[0::4] + turns[3::4]) / (2 * rounds)))
    return dict(B=B, T=T, F=F, hop=hop, target=target,
                bound_ms=1e3 * kc.stretch_ola_work(B, T, F, hop, target) / 3.35e12, plans=runs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--only", choices=("k15", "k16", "k17"))
    ap.add_argument("--out", default="soundkit_tpu_torch/_build/bench/dsp_kernel_bench.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dsp_kernel_bench: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    _build.kernels()
    fd.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    res = dict(card=card)
    for name, bench in (("k15", bench_k15), ("k16", bench_k16), ("k17", bench_k17)):
        if args.only in (None, name):
            res[name] = bench(dev, args.rounds)
            torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    bad = [f"k15 {n}" for n, r in res.get("k15", {}).items()
           if not all(p["equal_to_first"] for p in r["plans"])]
    if not all(p["equal_to_first"] for p in res.get("k16", {}).get("plans", ())):
        bad.append("k16")
    if not res.get("k17", {}).get("nearest_equal_to_first", True):
        bad.append("k17")
    if bad:
        print(f"dsp_kernel_bench: differs from the first design in {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
