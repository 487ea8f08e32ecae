"""The SASS, registers and spills of named kernels, in the kernels' build
and in the first designs' build.

Builds both libraries from the checkout (``_build.kernel_library_path``,
``tools/first_designs``) and, for each kernel whose mangled name holds one
of the names given, prints its registers and spilled bytes from the
``ptxas -v`` log of each build and writes its SASS (``cuobjdump -sass``)
to ``<out>/kernels.sass`` and ``<out>/first_designs.sass``. Needs ``nvcc``
and ``cuobjdump``, no card. From the repository's root::

    python -m soundkit_tpu_torch.tools.kernel_sass silk_synth celt_postfilter
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

from soundkit_tpu_torch import _build
from soundkit_tpu_torch.tools import first_designs as fd


def sass(library: Path, names) -> str:
    """The SASS of the functions in ``library`` whose names hold one of
    ``names``."""
    text = subprocess.run(["cuobjdump", "-sass", str(library)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    return "".join(part for part in re.split(r"(?m)^(?=\s*Function : )", text)
                   if part.lstrip().startswith("Function :")
                   and any(n in part.lstrip().split("\n", 1)[0] for n in names))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="+", help="parts of the kernels' names")
    ap.add_argument("--out", default="soundkit_tpu_torch/_build/sass")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    res = {}
    for label, library in (("kernels", _build.kernel_library_path()),
                           ("first_designs", fd.library_path())):
        res[label] = [b for n in args.names for b in _build.build_info(library, n)]
        (out / f"{label}.sass").write_text(sass(library, args.names))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
