"""Batched multi-stream serving models (the lockstep replacement for
the reference's pipeline-per-stream threads) and the StreamFleet
runtime that routes detected streams into them."""
from soundkit_tpu_torch.models.aac_lc_batch import BatchedAacLcDecoder
from soundkit_tpu_torch.models.flac_batch import BatchedFlacDecoder
from soundkit_tpu_torch.models.fleet import StreamFleet
from soundkit_tpu_torch.models.mp3_batch_model import BatchedMp3Decoder
from soundkit_tpu_torch.models.opus_batch import BatchedOpusDecoder
from soundkit_tpu_torch.models.telephony_batch import (
    BatchedTelephonyDecoder,
    BatchedTelephonyEncoder,
)

__all__ = [
    "BatchedAacLcDecoder",
    "BatchedFlacDecoder",
    "BatchedMp3Decoder",
    "BatchedOpusDecoder",
    "BatchedTelephonyDecoder",
    "BatchedTelephonyEncoder",
    "StreamFleet",
]
