"""Extract the MPEG audio Layer I / II spec tables from libavcodec's static
archive into ``soundkit_tpu_torch/data/mpa_tables.npz``.

The owned Layer I / II decoder (``codecs/mpa_layer12.py``) is written
from the standard, but its allocation tables (ISO/IEC 11172-3 Table
3-B.2, ISO/IEC 13818-3 Table B.1) are published data. A machine without
network access keeps them in ``libavcodec.a``: this tool links a small
dumper against the archive's table objects (``mpegaudiodata.o``,
``mpegaudiotabs.o``, ``mpegaudiodsp_data.o``) and writes the raw arrays.
It needs the archive, ``ar`` and ``g++``, and is run once, where they
are, from the repository's root::

    python -m soundkit_tpu_torch.tools.extract_mpa_tables [out.npz]

The decoder only reads the committed ``.npz``. The arrays:

- ``alloc_<t>`` (t = 0..4): the allocation table ``t`` as libavcodec lays
  it out: for each subband its allocation width ``nbal``, then the
  ``2**nbal - 1`` quantization classes an allocation code selects;
- ``sblimit``: the subbands each table codes (27, 30, 8, 12, 30);
- ``quant_bits`` / ``quant_steps``: the 17 classes' code widths (negative:
  three samples grouped in one code of that many bits) and step counts;
- ``freq_tab``, ``bitrate_tab`` ([lsf, layer - 1, index] in kbit/s) and
  ``enwindow``: the header tables and the synthesis window's 257 taps at
  2**16.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ARCHIVE = "/usr/lib/x86_64-linux-gnu/libavcodec.a"
OUT = Path(__file__).resolve().parents[1] / "data" / "mpa_tables.npz"

DUMPER = r"""
#include <cstdio>
#include <cstdint>

extern "C" {
extern const unsigned char * const ff_mpa_alloc_tables[5];
extern const int ff_mpa_quant_bits[17];
extern const int ff_mpa_quant_steps[17];
extern const int ff_mpa_sblimit_table[5];
extern const uint16_t ff_mpa_freq_tab[3];
extern const uint16_t ff_mpa_bitrate_tab[2][3][15];
extern const int32_t ff_mpa_enwindow[257];
}

static void dump(const char* name, const void* data, size_t bytes) {
    char path[512];
    snprintf(path, sizeof path, "%s/%s.bin", OUTDIR, name);
    FILE* f = fopen(path, "wb");
    fwrite(data, 1, bytes, f);
    fclose(f);
}

int main() {
    for (int t = 0; t < 5; ++t) {
        // a table is, subband by subband, its width then 2^width entries
        const unsigned char* a = ff_mpa_alloc_tables[t];
        size_t j = 0;
        for (int i = 0; i < ff_mpa_sblimit_table[t]; ++i) j += (size_t)1 << a[j];
        char n[32];
        snprintf(n, sizeof n, "alloc_%d", t);
        dump(n, a, j);
    }
    dump("quant_bits", ff_mpa_quant_bits, sizeof ff_mpa_quant_bits);
    dump("quant_steps", ff_mpa_quant_steps, sizeof ff_mpa_quant_steps);
    dump("sblimit", ff_mpa_sblimit_table, sizeof ff_mpa_sblimit_table);
    dump("freq_tab", ff_mpa_freq_tab, sizeof ff_mpa_freq_tab);
    dump("bitrate_tab", ff_mpa_bitrate_tab, sizeof ff_mpa_bitrate_tab);
    dump("enwindow", ff_mpa_enwindow, sizeof ff_mpa_enwindow);
    return 0;
}
"""

OBJECTS = ("mpegaudiodata.o", "mpegaudiotabs.o", "mpegaudiodsp_data.o")


def extract(archive: str = ARCHIVE) -> dict:
    """The tables as arrays, read from ``archive``."""
    with tempfile.TemporaryDirectory() as td:
        tdp = Path(td)
        subprocess.run(["ar", "x", archive, *OBJECTS], cwd=td, check=True)
        (tdp / "dumper.cpp").write_text(DUMPER)
        subprocess.run(["g++", "-O1", f"-DOUTDIR=\"{td}\"", "dumper.cpp", *OBJECTS,
                        "-o", "dumper"], cwd=td, check=True)
        subprocess.run(["./dumper"], cwd=td, check=True)

        def load(name, dtype):
            return np.frombuffer((tdp / f"{name}.bin").read_bytes(), dtype=dtype).copy()

        out = {f"alloc_{t}": load(f"alloc_{t}", "u1") for t in range(5)}
        out.update(sblimit=load("sblimit", "<i4"), quant_bits=load("quant_bits", "<i4"),
                   quant_steps=load("quant_steps", "<i4"), freq_tab=load("freq_tab", "<u2"),
                   bitrate_tab=load("bitrate_tab", "<u2").reshape(2, 3, 15),
                   enwindow=load("enwindow", "<i4"))
        return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    out = Path(argv[0]) if argv else OUT
    np.savez(out, **extract())
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
