"""The MP3 -> 8 kHz µ-law transcode chain of the port
(``soundkit_tpu_torch.tools.transcode``) against the JAX package's on the
CPU: four lanes of the ``stereo44`` fixture, each from its own frame,
through the port's ``BatchedMp3Decoder`` and the chunked tail (downmix,
carried-state resample 44.1 -> 8 kHz, µ-law), held to the same chain over
the JAX ``BatchedMp3Decoder`` with the tail of
``benchmarks/transcode_bench.py`` (``tail_stage``, restated here: it is a
closure of that script's ``main``), and to a continuous one-shot resample
of each lane's whole decoded mono signal. The bar, as on the card: at
least 99.99 % of the codes identical, every other one within one µ-law
step of the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from soundkit_tpu.models.mp3_batch_model import BatchedMp3Decoder as JaxMp3Decoder
from soundkit_tpu.ops import companding as jax_companding
from soundkit_tpu.ops import resample as jax_rs
from soundkit_tpu_torch.models.mp3_batch_model import BatchedMp3Decoder
from soundkit_tpu_torch.ops import resample as rs
from soundkit_tpu_torch.tools import mp3_fixtures as mf
from soundkit_tpu_torch.tools import transcode as tc

B = 4


def assert_codes_agree(got: np.ndarray, ref: np.ndarray) -> None:
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    differ, off_step = tc.codes_apart(got, ref)
    assert differ <= 1e-4 * got.size, f"{differ} of {got.size} codes differ"
    assert off_step == 0


def _streams():
    clip = next(c for c in mf.load_clips() if c.name == "stereo44")
    return mf.rotated_streams(clip, B)


def test_rotated_lanes_play_the_whole_clip_from_their_cut():
    clip = next(c for c in mf.load_clips() if c.name == "stereo44")
    streams = mf.rotated_streams(clip, 11)
    for i, s in enumerate(streams):
        start = mf._lane_cut(i, len(clip.frames))[0]
        assert len(s) == len(clip.stream())
        assert s.startswith(clip.frames[start])
    assert len({s[:64] for s in streams}) > 1


def test_transcode_chain_matches_the_jax_chain_and_a_continuous_resample():
    streams = _streams()
    port = BatchedMp3Decoder(B, channels=2, device="cpu")
    ref = JaxMp3Decoder(B, channels=2)
    for b, s in enumerate(streams):
        port.push(b, s)
        ref.push(b, s)
    codes, hist, granules, monos = tc.transcode_ready(port, rs.resample_init_state(B, "cpu"),
                                                      keep_mono=True)
    assert granules == tc.CHUNK * len(codes) and len(codes) == 4
    assert port.ready_granules < tc.CHUNK
    got = torch.cat(codes, dim=1).numpy()
    assert got.shape == (B, granules * tc.GRANULE * 80 // 441)

    def tail_stage(pcm_block, hist):
        mono = pcm_block.mean(axis=1)
        lo, hist = jax_rs.resample_stateful(mono, hist, tc.SRC_RATE, tc.DST_RATE)
        return jax_companding.encode_mulaw(jnp.clip(lo * 32768.0, -32768, 32767)), hist

    tail = jax.jit(tail_stage)
    jhist = jnp.asarray(jax_rs.resample_init_state(B))
    jcodes = []
    while ref.ready_granules >= tc.CHUNK:
        block = ref.decode_ready(max_granules=tc.CHUNK, device_out=True)
        merged = jnp.transpose(block, (1, 2, 0, 3)).reshape(B, 2, -1)
        c, jhist = tail(merged, jhist)
        jcodes.append(np.asarray(c))
    assert_codes_agree(got, np.concatenate(jcodes, axis=1))

    mono = torch.cat(monos, dim=1).numpy()
    assert_codes_agree(got, tc.continuous_codes(mono, got.shape[1]))
    np.testing.assert_array_equal(hist.numpy(), mono[:, -255:])
