"""AAC channel configurations 1-7: the element list each one carries and
the order its channels come out in.

ISO/IEC 14496-3, Table 1.19, names the syntactic elements of an access
unit for each ``channelConfiguration`` (:data:`CONFIG_ELEMENTS`). The
owned parser (``codecs/aac_lc.AacLcDecoder``) returns a frame's elements
in bitstream order, and ``ops/aac_dsp.AacLcSynth`` synthesizes them in
that order: an SCE or LFE gives one channel, a CPE two. The JAX package
hands every configuration beyond stereo to libavcodec, which emits its
own channel order (front left, front right, centre, LFE, then the rest;
for configuration 7 the third CPE, the surround pair, before the second,
the outside front pair). :data:`LIBAVCODEC_ORDER` is that order as
indices into the bitstream order, measured against the JAX package's
libavcodec on the fixtures of ``tools/aac_mc_fixtures.py``; the port's
decoders emit it (:func:`to_output_order`), so that
``pipeline.output_options.downmix_channels``, which reads L R C LFE Ls
Rs, takes the centre as a centre.

:func:`check_elements` holds one access unit to its configuration. A
unit whose element kinds are not the configuration's is refused: the
encoder's own 2.1 (configuration 3 with CPE LFE) and 6.1 (configuration
7 with CPE SCE SCE CPE SCE) streams, and stereo units under a 5.1 or 7.1
AudioSpecificConfig. The JAX package's libavcodec gives no samples for
any of these either.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

#: the element kinds of an access unit, in bitstream order, for each
#: channel configuration (ISO/IEC 14496-3, Table 1.19)
CONFIG_ELEMENTS: Dict[int, Tuple[str, ...]] = {
    1: ("SCE",),
    2: ("CPE",),
    3: ("SCE", "CPE"),
    4: ("SCE", "CPE", "SCE"),
    5: ("SCE", "CPE", "CPE"),
    6: ("SCE", "CPE", "CPE", "LFE"),
    7: ("SCE", "CPE", "CPE", "CPE", "LFE"),
}

#: output channels of each configuration (configuration 7 is 7.1)
CHANNELS: Dict[int, int] = {c: sum(2 if k == "CPE" else 1 for k in e)
                            for c, e in CONFIG_ELEMENTS.items()}

#: libavcodec's output order as indices into the bitstream order
#: (output channel i is bitstream channel ``LIBAVCODEC_ORDER[c][i]``)
LIBAVCODEC_ORDER: Dict[int, Tuple[int, ...]] = {
    1: (0,),
    2: (0, 1),
    3: (1, 2, 0),
    4: (1, 2, 0, 3),
    5: (1, 2, 0, 3, 4),
    6: (1, 2, 0, 5, 3, 4),
    7: (1, 2, 0, 7, 5, 6, 3, 4),
}


def check_elements(frame, config: int) -> None:
    """Raise ``ValueError`` unless the elements of ``frame`` (a parsed
    ``AacFrame``) are those of channel configuration ``config``."""
    kinds = tuple(el.kind for el in frame.elements)
    if kinds != CONFIG_ELEMENTS[config]:
        raise ValueError(f"elements {' '.join(kinds)} in an access unit of channel configuration "
                         f"{config}, which carries {' '.join(CONFIG_ELEMENTS[config])}")


def to_output_order(pcm: np.ndarray, config: int) -> np.ndarray:
    """``pcm`` [channels, samples] in bitstream order, in libavcodec's."""
    order = LIBAVCODEC_ORDER[config]
    return pcm if order == tuple(range(len(order))) else pcm[list(order)]


def config_name(config: int) -> str:
    """How a refusal names channel configuration ``config``."""
    if config == 0:
        return "a program config element (channel configuration 0)"
    return f"channel configuration {config}"

