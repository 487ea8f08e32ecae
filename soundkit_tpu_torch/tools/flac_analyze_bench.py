"""Time builds of K14 (``csrc/flac_analyze.cu``) side by side on the card.

Each ``--source`` is a copy of the kernel's source (the repo's, or an
older one such as a parent commit's, unpacked with ``git show``); each
``--cut`` builds a copy of every source that stops after one stage of
the algorithm, so the stages' times can be told apart (``all`` is the
source as it is). The builds are compiled together (one ``nvcc`` a
build, ``-Xptxas -v``), loaded with ``ctypes`` and timed by CUDA graph
replay, in turns (forward, then backward, ``--rounds`` times), on the
rows of ``chip_smoke.py``'s ``[flac-enc]`` first ``encode_pending``
(1024 lanes of the stereo16 and const_wasted fixtures' PCM, 10,240 rows
of 4096 samples). The ``all`` builds' plan rows are held to the plain
version's. Prints one JSON line: per build, its time, its registers,
spills and shared memory from ``ptxas``, and the count of each SASS
opcode of its kernels (``cuobjdump``); the SASS itself goes to
``--out``. From the repository's root, on a machine with the card::

    python -m soundkit_tpu_torch.tools.flac_analyze_bench \\
        --source soundkit_tpu_torch/csrc/flac_analyze.cu --cut all
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import gzip
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from soundkit_tpu_torch import _build
from soundkit_tpu_torch.ops.flac_enc_batch import flac_analyze_plain, flac_plans_pack
from soundkit_tpu_torch.tools import flac_fixtures as ff
from soundkit_tpu_torch.tools import kernel_check as kc

LANES, SECONDS, RATE, PUSHES = 1024, 4, 44100, 4

#: the stage cuts of a K14 source: name -> alternatives (one a layout of the
#: kernel: one block a row, or persistent blocks walking rows), each a list of
#: (anchor, replacement), every anchor a regular expression matching once;
#: the first alternative whose anchors all match is applied. ``copy``: read
#: the samples and write the plan rows; ``A``: through pass A (fixed sums and
#: the autocorrelation); ``A+lev``: through the Levinson recursion and the
#: quantization; ``A+B``: all but pass C; ``A-nofix`` and ``A-noac``:
#: pass A without its fixed sums, or without its lag products.
_ROW_END = ("out[7 + sl * ORDER + j] = s.qlp[c][j];\n            }\n        }\n    }\n}")
CUTS = {
    "all": [[]],
    "copy": [
        [(r"stage\(s, xl, xr, tile0, n_valid, mono, true\);\n\s*__syncthreads\(\);\n",
          "stage(s, xl, xr, tile0, n_valid, mono, false);\n__syncthreads();\n"
          "if (tid < PLAN) plans[(size_t)row * PLAN + tid] = s.l[pi(tid)] + s.r[pi(3 * tid)];\n"
          "return;\n")],
        [(r"w\.load\(xl, xr, g0, n_valid, vec, mono\);\n(?=            for \(int c = 0; c < nc)",
          "w.load(xl, xr, g0, n_valid, vec, mono);\n{ int acc = 0;\n#pragma unroll\n"
          "for (int i = 0; i < HIST; i++) acc += w.L(i) ^ w.R(i);\n"
          "if (tid < PLAN) plans[(size_t)row * PLAN + tid] = acc; goto next_row; }\n"),
         (re.escape(_ROW_END), _ROW_END.replace("    }\n}", "    next_row:;\n    }\n}"))],
    ],
    "A": [
        [(r"\n    __syncthreads\(\);\n\n    // ---- one thread a candidate",
          "\n    __syncthreads();\n    if (tid < nc * NLAG) plans[(size_t)row * PLAN + tid % PLAN] ="
          " (int)s.ac[tid / NLAG][tid % NLAG] + (int)s.fabs_[tid / NLAG][tid % NFIX]"
          " + (int)s.fneg[tid / NLAG][tid % NFIX];\n    return;\n"
          "    // ---- one thread a candidate")],
        [(r"\n        // ---- one thread a candidate",
          "\n        if (tid < nc * NLAG) plans[(size_t)row * PLAN + tid % PLAN] ="
          " (int)s.ac[tid / NLAG][tid % NLAG] + (int)s.ired[tid / NLAG][0][tid % NFIX];\n"
          "        continue;\n        // ---- one thread a candidate")],
    ],
    "A-nofix": [
        [(r"\n        // ---- one thread a candidate",
          "\n        if (tid < nc * NLAG) plans[(size_t)row * PLAN + tid % PLAN] ="
          " (int)s.ac[tid / NLAG][tid % NLAG] + (int)s.ired[tid / NLAG][0][tid % NFIX];\n"
          "        continue;\n        // ---- one thread a candidate"),
         (r"if \(lim < SPT\) fixed_sums<true>\(v, first, lim, fa, fn\);\n\s*"
          r"else fixed_sums<false>\(v, first, lim, fa, fn\);", "")],
    ],
    "A-noac": [
        [(r"\n        // ---- one thread a candidate",
          "\n        if (tid < nc * NLAG) plans[(size_t)row * PLAN + tid % PLAN] ="
          " (int)s.ac[tid / NLAG][tid % NLAG] + (int)s.ired[tid / NLAG][0][tid % NFIX];\n"
          "        continue;\n        // ---- one thread a candidate"),
         (r"dacc\[lag\] = __dadd_rn\(dacc\[lag\], __dmul_rn\(xw\[m - lag\], xw\[m\]\)\);",
          "if (lag == 0) dacc[0] = __dadd_rn(dacc[0], xw[m]);")],
    ],
    "A+lev": [
        [(r"\n    __syncthreads\(\);\n    bool lpc_any = false;",
          "\n    __syncthreads();\n    if (tid < nc * ORDER) plans[(size_t)row * PLAN + tid % PLAN] ="
          " s.qlp[tid / ORDER][tid % ORDER] + s.fo[tid / ORDER] + s.fk[tid / ORDER]"
          " + s.ok[tid / ORDER] + s.shift[tid / ORDER];\n    return;\n"
          "    bool lpc_any = false;")],
        [(r"\n        // ---- pass B",
          "\n        if (tid < nc * ORDER) plans[(size_t)row * PLAN + tid % PLAN] ="
          " s.qlp[tid / ORDER][tid % ORDER] + s.fo[tid / ORDER] + s.ok[tid / ORDER]"
          " + s.shift[tid / ORDER];\n        continue;\n        // ---- pass B")],
    ],
    "A+B": [
        [(r"for \(int pass = 0; pass < 2; pass\+\+\)", "for (int pass = 0; pass < 1; pass++)")],
        [(r"uint32_t lsum = 0;\n(\s*)if \(g0 < n_valid\) \{", "uint32_t lsum = 0;\nif (g0 < 0) {")],
    ],
}


def cut_source(text: str, cut: str) -> str:
    for alternative in CUTS[cut]:
        if all(len(re.findall(anchor, text)) == 1 for anchor, _ in alternative):
            for anchor, repl in alternative:
                text = re.sub(anchor, lambda _m, r=repl: r, text)
            return text
    raise ValueError(f"cut {cut}: no alternative's anchors match the source once")


def path_rows(dev) -> torch.Tensor:
    """The wire of [flac-enc]'s first encode_pending: [10240, 2, 4096] int16."""
    clips = {c.name: c for c in ff.load_clips()}
    pcms = [ff.clip_pcm(clips[name], dev) for name in ("stereo16", "const_wasted")]
    lanes = ff.rotated_lanes(pcms, LANES, SECONDS * RATE)
    return kc.flac_enc_path_inputs(lanes, SECONDS * RATE // PUSHES, dev)


def graph_ms(fn, reps: int = 10, replays: int = 3) -> float:
    """Device time of one ``fn`` call: a CUDA graph of ``reps`` calls,
    replayed ``replays`` times between CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


def sass_opcodes(so: Path, dump: Path) -> dict:
    """Opcode counts of the SASS of every function in ``so`` (written to
    ``dump``, gzipped), or {} where ``cuobjdump`` is missing."""
    try:
        text = subprocess.run(["cuobjdump", "-sass", str(so)], capture_output=True, text=True,
                              timeout=120).stdout
    except (OSError, subprocess.TimeoutExpired):
        return {}
    dump.write_bytes(gzip.compress(text.encode()))
    ops = collections.Counter(m.group(1).split(".")[0] for m in
                              re.finditer(r"/\*[0-9a-f]{4,6}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                                          text))
    return dict(ops.most_common())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", required=True,
                    help="a K14 source, optionally as LABEL=PATH")
    ap.add_argument("--cut", action="append", choices=sorted(CUTS),
                    help="stage cuts to build of every source (default: all)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default="soundkit_tpu_torch/_build/bench",
                    help="directory for the SASS dumps and result.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flac_analyze_bench: no CUDA device", file=sys.stderr)
        return 1
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    x = path_rows(dev)
    rows, _, N = x.shape
    want = flac_plans_pack(*flac_analyze_plain(x, N, 16)[:5])
    nvcc = _build._compiler("nvcc", "/usr/local/cuda/bin/nvcc")
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    builds = []
    for spec in args.source:
        label, _, path = spec.rpartition("=")
        path = Path(path)
        label = label or path.stem
        for cut in args.cut or ["all"]:
            d = _build.BUILD_DIR / "bench" / f"{label}-{cut}"
            d.mkdir(parents=True, exist_ok=True)
            src = d / "flac_analyze.cu"
            src.write_text(cut_source(path.read_text(), cut))
            builds.append(dict(label=label, cut=cut, src=src, so=d / "k14.so"))
    cmds = [[nvcc, *flags, "-shared", "-o", str(b["so"]), str(b["src"])] for b in builds]
    for b, (cmd, rc, log) in zip(builds, _build._run_all(cmds)):
        if rc != 0:
            raise _build.BuildError(f"{' '.join(cmd)}:\n{log}")
        b["ptxas"] = _build.ptxas_info(log, "flac_analyze")
        lib = ctypes.CDLL(str(b["so"]))
        lib.skt_flac_analyze.argtypes = [ctypes.c_void_p, *[ctypes.c_int] * 6,
                                         ctypes.c_void_p, ctypes.c_void_p]
        plans = torch.empty((rows, 23), dtype=torch.int32, device=dev)

        def call(fn=lib.skt_flac_analyze, plans=plans):
            rc = fn(x.data_ptr(), 0, rows, N, N, 16, 2, plans.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"skt_flac_analyze returned {rc}")

        call()
        torch.cuda.synchronize()
        if b["cut"] == "all":
            b["identical"] = bool(torch.equal(plans, want))
        b["call"], b["ms"] = call, []
        b["sass_ops"] = sass_opcodes(b["so"], out / f"{b['label']}-{b['cut']}.sass.gz")
    for r in range(args.rounds):
        for b in (builds if r % 2 == 0 else builds[::-1]):
            b["ms"].append(graph_ms(b["call"]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    res = dict(card=card, rows=rows, n=N, builds=[
        {k: b[k] for k in ("label", "cut", "ms", "ptxas", "identical", "sass_ops") if k in b}
        for b in builds])
    (out / "result.json").write_text(json.dumps(res, indent=1))
    for b in res["builds"]:
        b["sass_ops"] = dict(list(b["sass_ops"].items())[:24])
    print(json.dumps(res))
    bad = [f"{b['label']}-{b['cut']}" for b in builds if b.get("identical") is False]
    if bad:
        print(f"flac_analyze_bench: plan rows differ from the plain version's in {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
