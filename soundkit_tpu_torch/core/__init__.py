from soundkit_tpu_torch.core.audio_types import (  # noqa: F401
    AudioData,
    EncodingFlag,
    Endianness,
    PcmData,
)
