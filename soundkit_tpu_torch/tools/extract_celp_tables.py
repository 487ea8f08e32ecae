"""Extract the G.729 and AMR-NB tables from libavcodec's static archive
into ``soundkit_tpu_torch/data/g729_tables.npz`` and
``data/amrnb_tables.npz``, and generate the C++ header of each,
``native_src/generated/g729_tables.h`` and ``amrnb_tables.h``.

The owned decoders (``native_src/src/g729.cpp``, ``amrnb.cpp``) follow
libavcodec's, but their codebooks, interpolation filters and bit orders
are published data. A machine without network access keeps them in
``libavcodec.a`` as file-local symbols of ``g729dec.o``,
``g729postfilter.o``, ``amrnbdec.o``, ``acelp_vectors.o``,
``acelp_filters.o``, ``lsp.o`` and ``celp_math.o``. This tool globalizes
them with ``objcopy --globalize-symbol``, keeps only the objects'
read-only data sections (so that nothing of their code needs linking),
and links a g++ dumper against those objects that writes each symbol's
bytes. It needs the archive, ``ar``, ``objcopy``, ``objdump``, ``nm``
and ``g++``, and is run once, where they are, from the repository's
root::

    python -m soundkit_tpu_torch.tools.extract_celp_tables

The build on another machine reads only the committed ``.npz`` and
headers; ``tests/test_torch_celp.py`` holds each header to its ``.npz``
and, where the archive is found, each ``.npz`` to a fresh extraction.

A few tables have no symbol, because the compiler folded them into the
code. They are read where the compiler put them, each place named below:

- G.729's initial LSP vector ``lsp_init``: its first eight entries are
  ``g729dec.o``'s only 16-byte constant, its last two the 32-bit
  immediate that ``decoder_init`` stores beside them;
- the postfilter's ``formant_pp_factor_num_pow`` / ``_den_pow``
  (0.55**(i+1) and 0.7**(i+1) in Q15, as the ITU reference rounds them):
  the immediate factors of ``ff_g729_postfilter``'s first twenty
  multiplies, numerator powers first and in order, then the denominator
  powers in another order (they decrease, so they are sorted);
- AMR-NB's LSF prediction factors ``pred_fac`` (ten floats of
  ``amrnbdec.o``'s 4-byte constants), the 12.2 kbit/s mean LSF vector
  ``lsf_5_mean`` in Hz (ten doubles of its 8-byte constants, each a
  float widened) and the other modes' mean divided by 8000,
  ``lsf_3_mean_8000`` (the ten doubles that follow), at the offsets
  :data:`AMR_POOL_SLICES` names; the extraction checks that each run is
  what it should be (factors in (0, 1), means increasing);
- AMR-NB's ``highpass_gain * AMR_SAMPLE_SCALE``, ``highpass_scale``: the
  one float of the 4-byte constants the output filter is called with.
"""
from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

ARCHIVE = "/usr/lib/x86_64-linux-gnu/libavcodec.a"
PKG = Path(__file__).resolve().parents[1]
OUT = {"g729": PKG / "data" / "g729_tables.npz", "amrnb": PKG / "data" / "amrnb_tables.npz"}
HEADERS = {"g729": PKG / "native_src" / "generated" / "g729_tables.h",
           "amrnb": PKG / "native_src" / "generated" / "amrnb_tables.h"}

#: (object, symbol, dtype, shape) of every table read by name; a shape of
#: None is the symbol's whole size
G729_SYMBOLS: Tuple[Tuple[str, str, str, tuple], ...] = (
    ("g729dec.o", "cb_lsp_1st", "<i2", (128, 10)),
    ("g729dec.o", "cb_lsp_2nd", "<i2", (32, 10)),
    ("g729dec.o", "cb_ma_predictor", "<i2", (2, 4, 10)),
    ("g729dec.o", "cb_ma_predictor_sum", "<i2", (2, 10)),
    ("g729dec.o", "cb_ma_predictor_sum_inv", "<i2", (2, 10)),
    ("g729dec.o", "ma_prediction_coeff", "<i2", (4,)),
    ("g729dec.o", "cb_gain_1st_8k", "<i2", (8, 2)),
    ("g729dec.o", "cb_gain_2nd_8k", "<i2", (16, 2)),
    ("g729dec.o", "phase_filter", "<i2", (3, 40)),
    ("g729postfilter.o", "ff_g729_interp_filt_long", "<i2", (64,)),
    ("g729postfilter.o", "ff_g729_interp_filt_short", "<i2", (16,)),
    ("acelp_vectors.o", "ff_fc_4pulses_8bits_tracks_13", "u1", (16,)),
    ("acelp_vectors.o", "ff_fc_4pulses_8bits_track_4", "u1", (32,)),
    ("acelp_filters.o", "ff_acelp_interp_filter", "<i2", (61,)),
    ("lsp.o", "tab_cos", "<i2", (65,)),
    ("celp_math.o", "tab_log2", "<u2", (33,)),
)

AMR_MODES = ("4k75", "5k15", "5k9", "6k7", "7k4", "7k95", "10k2", "12k2")

AMR_SYMBOLS: Tuple[Tuple[str, str, str, tuple], ...] = (
    *(("amrnbdec.o", f"order_MODE_{m}", "u1", None) for m in AMR_MODES),
    ("amrnbdec.o", "lsf_3_1", "<i2", (256, 3)),
    ("amrnbdec.o", "lsf_3_1_MODE_7k95", "<i2", (512, 3)),
    ("amrnbdec.o", "lsf_3_2", "<i2", (512, 3)),
    ("amrnbdec.o", "lsf_3_3", "<i2", (512, 4)),
    ("amrnbdec.o", "lsf_3_3_MODE_5k15", "<i2", (128, 4)),
    ("amrnbdec.o", "lsf_5_1", "<i2", (128, 4)),
    ("amrnbdec.o", "lsf_5_2", "<i2", (256, 4)),
    ("amrnbdec.o", "lsf_5_3", "<i2", (256, 4)),
    ("amrnbdec.o", "lsf_5_4", "<i2", (256, 4)),
    ("amrnbdec.o", "lsf_5_5", "<i2", (64, 4)),
    ("amrnbdec.o", "gains_MODE_4k75", "<u2", (256, 4)),
    ("amrnbdec.o", "gains_high", "<u2", (128, 2)),
    ("amrnbdec.o", "gains_low", "<u2", (64, 2)),
    ("amrnbdec.o", "qua_gain_pit", "<u2", (16,)),
    ("amrnbdec.o", "qua_gain_code", "<u2", (32,)),
    ("amrnbdec.o", "ir_filter_medium", "<f4", (40,)),
    ("amrnbdec.o", "ir_filter_strong", "<f4", (40,)),
    ("amrnbdec.o", "ir_filter_strong_MODE_7k95", "<f4", (40,)),
    ("amrnbdec.o", "energy_mean", "<f4", (8,)),
    ("amrnbdec.o", "energy_pred_fac", "<f4", (4,)),
    ("amrnbdec.o", "lsp_avg_init", "<i2", (10,)),
    ("amrnbdec.o", "lsp_sub4_init", "i1", (10,)),
    ("amrnbdec.o", "base_five_table", "u1", (128, 3)),
    ("amrnbdec.o", "gray_decode", "u1", (8,)),
    ("amrnbdec.o", "track_position", "u1", (16,)),
    ("amrnbdec.o", "highpass_poles", "<f4", (2,)),
    ("amrnbdec.o", "highpass_zeros", "<f4", (2,)),
    ("amrnbdec.o", "frame_sizes_nb", "u1", (9,)),
    ("acelp_vectors.o", "ff_b60_sinc", "<f4", (61,)),
    ("acelp_vectors.o", "ff_pow_0_7", "<f4", (10,)),
    ("acelp_vectors.o", "ff_pow_0_75", "<f4", (10,)),
    ("acelp_vectors.o", "ff_pow_0_55", "<f4", (10,)),
    ("acelp_filters.o", "ff_acelp_interp_filter", "<i2", (61,)),
)

#: the folded AMR-NB tables: (name, section of amrnbdec.o, first element,
#: count, dtype of the section's elements)
AMR_POOL_SLICES = (
    ("pred_fac", ".rodata.cst4", 6, 10, "<f4"),
    ("lsf_5_mean", ".rodata.cst8", 8, 10, "<f8"),
    ("lsf_3_mean_8000", ".rodata.cst8", 18, 10, "<f8"),
    ("highpass_scale", ".rodata.cst4", 20, 1, "<f4"),
)

OBJECTS = ("g729dec.o", "g729postfilter.o", "amrnbdec.o", "acelp_vectors.o",
           "acelp_filters.o", "lsp.o", "celp_math.o")

DUMPER_HEAD = r"""
#include <cstdio>
#include <cstddef>

static void dump(const char* name, const void* data, size_t bytes) {
    char path[512];
    snprintf(path, sizeof path, "%s/%s.bin", OUTDIR, name);
    FILE* f = fopen(path, "wb");
    fwrite(data, 1, bytes, f);
    fclose(f);
}
"""


def _run(cmd: List[str], cwd: str) -> str:
    return subprocess.run(cmd, cwd=cwd, check=True, capture_output=True, text=True).stdout


def _section(obj: Path, name: str) -> bytes:
    out = obj.with_suffix(f".{name.strip('.').replace('.', '_')}.bin")
    subprocess.run(["objcopy", "-O", "binary", f"--only-section={name}", str(obj), str(out)],
                   check=True)
    return out.read_bytes()


def _sizes(obj: Path) -> Dict[str, int]:
    sizes = {}
    for line in _run(["nm", "-S", obj.name], str(obj.parent)).splitlines():
        parts = line.split()
        if len(parts) == 4:
            sizes[parts[3]] = int(parts[1], 16)
    return sizes


def _function(obj: Path, name: str) -> List[str]:
    """The disassembly lines of the function ``name`` in ``obj``."""
    lines = _run(["objdump", "-d", "--no-show-raw-insn", obj.name], str(obj.parent)).splitlines()
    out, inside = [], False
    for line in lines:
        if re.match(rf"^[0-9a-f]+ <{re.escape(name)}>:", line):
            inside = True
            continue
        if inside and re.match(r"^[0-9a-f]+ <", line):
            break
        if inside:
            out.append(line)
    return out


def _dump_symbols(tdp: Path, symbols) -> Dict[str, bytes]:
    """Each symbol's bytes, by a g++ dumper linked against the objects'
    read-only data with the symbols made global."""
    by_obj: Dict[str, List[str]] = {}
    for obj, name, _, _ in symbols:
        by_obj.setdefault(obj, []).append(name)
    data_objs, decls, calls = [], [], []
    for obj, names in by_obj.items():
        sizes = _sizes(tdp / obj)
        data = tdp / f"data_{obj}"
        keep = [a for s in (".rodata", ".rodata.cst4", ".rodata.cst8", ".rodata.cst16")
                for a in ("-j", s)]
        glob = [f"--globalize-symbol={n}" for n in names]
        subprocess.run(["objcopy", *keep, *glob, obj, data.name], cwd=tdp, check=True)
        data_objs.append(data.name)
        for n in names:
            decls.append(f'extern "C" const unsigned char {n}[];')
            calls.append(f'    dump("{n}", {n}, {sizes[n]});')
    src = DUMPER_HEAD + "\n".join(decls) + "\nint main() {\n" + "\n".join(calls) + "\n    return 0;\n}\n"
    (tdp / "dumper.cpp").write_text(src)
    subprocess.run(["g++", "-O1", f"-DOUTDIR=\"{tdp}\"", "dumper.cpp", *data_objs, "-o", "dumper"],
                   cwd=tdp, check=True)
    subprocess.run(["./dumper"], cwd=tdp, check=True)
    return {n: (tdp / f"{n}.bin").read_bytes() for _, n, _, _ in symbols}


def _arrays(raw: Dict[str, bytes], symbols) -> Dict[str, np.ndarray]:
    out = {}
    for _, name, dtype, shape in symbols:
        a = np.frombuffer(raw[name], dtype=dtype).copy()
        out[name] = a.reshape(shape) if shape is not None else a
    return out


def _imm32(line: str) -> int:
    return int(re.search(r"\$0x([0-9a-f]+),", line).group(1), 16)


def _g729_folded(tdp: Path) -> Dict[str, np.ndarray]:
    obj = tdp / "g729dec.o"
    head = np.frombuffer(_section(obj, ".rodata.cst16"), "<i2")
    assert head.size == 8, "g729dec.o's 16-byte constants are not the LSP vector's head"
    init = _function(obj, "decoder_init")
    at = next(i for i, ln in enumerate(init) if "movaps" in ln or "movdqa" in ln)
    tail_line = next(ln for ln in init[at:] if re.search(r"movl\s+\$0x[0-9a-f]{5,8},", ln))
    tail = np.frombuffer(np.uint32(_imm32(tail_line)).tobytes(), "<i2")
    lsp_init = np.concatenate([head, tail]).astype(np.int16)

    post = _function(tdp / "g729postfilter.o", "ff_g729_postfilter")
    factors = [int(m.group(1), 16) for ln in post
               for m in [re.search(r"imul\s+\$0x([0-9a-f]+),", ln)] if m][:20]
    num, den = np.array(factors[:10], np.int16), np.array(sorted(factors[10:], reverse=True),
                                                          np.int16)
    assert np.all(np.diff(num) < 0) and num[0] == 18022 and den[0] == 22938, (num, den)
    return {"lsp_init": lsp_init, "formant_pp_factor_num_pow": num,
            "formant_pp_factor_den_pow": den}


def _amr_folded(tdp: Path) -> Dict[str, np.ndarray]:
    obj = tdp / "amrnbdec.o"
    out = {}
    for name, sec, first, count, dtype in AMR_POOL_SLICES:
        pool = np.frombuffer(_section(obj, sec), dtype)
        out[name] = pool[first:first + count].copy()
    assert np.all((out["pred_fac"] > 0) & (out["pred_fac"] < 1)), out["pred_fac"]
    for k in ("lsf_5_mean", "lsf_3_mean_8000"):
        assert np.all(np.diff(out[k]) > 0), (k, out[k])
    assert 300 < out["lsf_5_mean"][0] < 400 and 0.04 < out["lsf_3_mean_8000"][0] < 0.05
    assert np.all(out["lsf_5_mean"].astype(np.float32).astype(np.float64) == out["lsf_5_mean"])
    out["lsf_5_mean"] = out["lsf_5_mean"].astype(np.float32)
    return out


def extract(archive: str = ARCHIVE) -> Dict[str, Dict[str, np.ndarray]]:
    """``{"g729": arrays, "amrnb": arrays}``, read from ``archive``."""
    with tempfile.TemporaryDirectory() as td:
        tdp = Path(td)
        subprocess.run(["ar", "x", archive, *OBJECTS], cwd=td, check=True)
        raw = _dump_symbols(tdp, G729_SYMBOLS + AMR_SYMBOLS)
        g729 = _arrays(raw, G729_SYMBOLS)
        g729.update(_g729_folded(tdp))
        amr = _arrays(raw, AMR_SYMBOLS)
        amr.update(_amr_folded(tdp))
        return {"g729": g729, "amrnb": amr}


_CTYPES = {"int16": "int16_t", "uint16": "uint16_t", "uint8": "uint8_t", "int8": "int8_t",
           "float32": "float", "float64": "double"}


def _literal(v, ctype: str) -> str:
    if ctype == "float":
        return f"{float(v).hex()}f" if np.isfinite(v) else "0"
    if ctype == "double":
        return float(v).hex()
    return str(int(v))


def header_text(codec: str, arrays: Dict[str, np.ndarray]) -> str:
    """The C++ header of ``codec``'s tables: one ``static const`` array a
    name, in the npz's order, each value written exactly (floats in hex)."""
    guard = f"SKT_{codec.upper()}_TABLES_H"
    lines = [f"// {codec} tables, generated from data/{codec}_tables.npz by",
             "// soundkit_tpu_torch/tools/extract_celp_tables.py; do not edit.",
             f"#ifndef {guard}", f"#define {guard}", "#include <cstdint>", "",
             f"namespace {codec}_tab {{", ""]
    for name, a in arrays.items():
        ctype = _CTYPES[a.dtype.name]
        dims = "".join(f"[{d}]" for d in a.shape)
        flat = [_literal(v, ctype) for v in a.reshape(-1)]
        body = ",\n".join("    " + ", ".join(flat[i:i + 10]) for i in range(0, len(flat), 10))
        lines += [f"static const {ctype} {name}{dims} = {{", body, "};", ""]
    lines += [f"}}  // namespace {codec}_tab", f"#endif  // {guard}", ""]
    return "\n".join(lines)


def load(codec: str) -> Dict[str, np.ndarray]:
    """The committed tables of ``codec`` ("g729" or "amrnb"), in file order."""
    with np.load(OUT[codec]) as z:
        return {k: z[k] for k in z.files}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    tables = extract(argv[0] if argv else ARCHIVE)
    for codec, arrays in tables.items():
        np.savez(OUT[codec], **arrays)
        HEADERS[codec].write_text(header_text(codec, load(codec)))
        print(f"wrote {OUT[codec]} and {HEADERS[codec]}")


if __name__ == "__main__":
    main()
