"""The single-stream FLAC split walks of the port (``codecs/flac.FlacPartsStream``
and ``FlacSegsStream``, verbatim copies of the JAX package's over the port's
build of ``native_src/src/flac.cpp``) on the in-repo FLAC fixtures
(tests/data/torch_port/flac: 16-bit stereo with mid/side frames, 24-bit
stereo, 16-bit mono, and a stream whose left channel is constant in every
frame and whose right one has 2 wasted bits).

Each walk yields the JAX class's tuples, array for array, fed the stream
in one piece and in odd chunks. A segment stream's frames, decoded through
the plain versions of K8 (``ops/flac_rice.flac_rice_plane``, the Rice
plane from the frame bytes) and K9 (``ops/flac_lpc.flac_frame``, the LPC
restore, wasted bits and decorrelation), equal the fixture's PCM bit for
bit, and so do the residual planes of the parts walk through K9. The JAX
package's own cases of these walks (``tests/test_flac_device.py``) run on
the reference corpus, which is not in the repository, so their shapes are
held here on in-repo inputs: a stride too small for the frames, the parts
fallback mixed with segment frames in one stream, wasted bits, constant
subframes and high-order frames."""
import numpy as np
import pytest
import torch

from soundkit_tpu.codecs import flac as jax_flac
from soundkit_tpu_torch.codecs import flac
from soundkit_tpu_torch.ops import flac_lpc, flac_rice
from soundkit_tpu_torch.tools import flac_fixtures

from torch_port_helpers import flac_clip_pcm

STRIDE = 4096  # the fixtures' block size


def stream_bytes(name):
    clip = flac_fixtures.load_clips()[flac_fixtures.CLIPS.index(name)]
    return clip.header + b"".join(clip.frames)


def drain(walk, data, chunk, next_name):
    out = []
    for i in range(0, len(data), chunk):
        walk.feed(data[i: i + chunk])
        while (got := getattr(walk, next_name)()) is not None:
            out.append(got)
    return out


def assert_same_tuples(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


@pytest.mark.parametrize("name", flac_fixtures.CLIPS)
def test_walks_yield_the_jax_packages_tuples(name):
    data = stream_bytes(name)
    for chunk in (len(data), 997):
        got = drain(flac.FlacPartsStream(STRIDE), data, chunk, "next_parts")
        assert_same_tuples(got, drain(jax_flac.FlacPartsStream(STRIDE), data, chunk, "next_parts"))
        got = drain(flac.FlacSegsStream(STRIDE), data, chunk, "next")
        assert_same_tuples(got, drain(jax_flac.FlacSegsStream(STRIDE), data, chunk, "next"))
    ps = flac.FlacPartsStream(STRIDE)
    ps.feed(data)
    ps.next_parts()
    assert ps.max_block == flac_fixtures.BLOCK_SIZE


def frame_words(frames):
    """[NL, W] int32: each frame's bytes as big-endian 32-bit words."""
    W = max(-(-len(f) // 4) for f in frames)
    words = np.zeros((len(frames), W * 4), np.uint8)
    for i, f in enumerate(frames):
        words[i, :len(f)] = np.frombuffer(f, np.uint8)
    return words.view(">u4").astype(np.uint32).view(np.int32)


def decode_walk(items, stride):
    """Every frame of a segment walk's items, its segment frames through
    K8's and K9's plain versions and its parts frames through K9's, as
    samples [C, n]."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))  # noqa: E731
    n = len(items)
    meta = np.stack([it[1] for it in items])
    coef = np.zeros((n, 2, 32), np.int32)
    plane = torch.zeros((n, 2, stride), dtype=torch.int32)
    segs = [i for i, it in enumerate(items) if it[0] == "segs"]
    if segs:
        warm = np.stack([items[i][3] for i in segs])
        xmeta = np.stack([items[i][4] for i in segs])
        wire = flac_rice.seg_wire([items[i][5] for i in segs], stride)
        plane[segs] = flac_rice.flac_rice_plane(
            t(frame_words([items[i][6] for i in segs])), *map(t, wire), t(warm),
            t(xmeta[:, [0, 2]]), t(xmeta[:, [1, 3]]), stride)
        coef[segs] = [items[i][2] for i in segs]
    for i, it in enumerate(items):
        if it[0] == "parts":
            plane[i] = t(it[2])
            coef[i] = it[3]
    out = flac_lpc.flac_frame(plane, t(coef), t(meta[:, [4, 7]]), t(meta[:, [5, 8]]),
                              t(meta[:, [6, 9]]), t(meta[:, 2]), t(meta[:, 0]),
                              torch.ones(n, dtype=torch.bool)).numpy()
    C = int(meta[0, 1])
    return np.concatenate([out[i, :C, :meta[i, 0]] for i in range(n)], axis=1)


@pytest.mark.parametrize("name", flac_fixtures.CLIPS)
def test_segment_walk_through_k8_and_k9_is_the_fixture_pcm(name):
    items = drain(flac.FlacSegsStream(STRIDE), stream_bytes(name), 1 << 20, "next")
    assert all(it[0] == "segs" for it in items)
    np.testing.assert_array_equal(decode_walk(items, STRIDE), flac_clip_pcm(name))
    meta = np.stack([it[1] for it in items])
    xmeta = np.stack([it[4] for it in items])
    if name == "const_wasted":  # every left subframe constant, every right one 2 wasted bits
        assert (xmeta[:, 0] == 1).all() and (meta[:, 9] == 2).all()
        assert all(not (it[5][:, 3] < STRIDE).any() for it in items)  # no left segment
    if name == "stereo16":  # mid/side and real LPC orders
        assert 10 in set(meta[:, 2]) and meta[:, [4, 7]].max() >= 8


@pytest.mark.parametrize("name", ["stereo24", "const_wasted"])
def test_parts_walk_through_k9_is_the_fixture_pcm(name):
    items = drain(flac.FlacPartsStream(STRIDE), stream_bytes(name), 1 << 20, "next_parts")
    items = [("parts", *it) for it in items]
    np.testing.assert_array_equal(decode_walk(items, STRIDE), flac_clip_pcm(name))


def test_parts_fallback_mixes_with_segment_frames():
    """A segment cap that some frames of the 24-bit clip pass (45 and 59
    segments) and the others do not (61): the walk exports those as
    residual planes (the ``export_parts_last`` fallback, nothing decoded
    twice), as the JAX class does, and the mixed frames decode to the
    clip's PCM."""
    data = stream_bytes("stereo24")
    counts = [it[5].shape[0] for it in drain(flac.FlacSegsStream(STRIDE), data, 1 << 20, "next")]
    cap = 60
    walks = []
    for cls in (flac.FlacSegsStream, jax_flac.FlacSegsStream):
        ss = cls(STRIDE)
        ss.SEG_CAP = cap
        walks.append(drain(ss, data, 1 << 20, "next"))
    assert_same_tuples(*walks)
    kinds = [it[0] for it in walks[0]]
    assert kinds == ["segs" if c <= cap else "parts" for c in counts]
    assert {"segs", "parts"} == set(kinds)
    np.testing.assert_array_equal(decode_walk(walks[0], STRIDE), flac_clip_pcm("stereo24"))


@pytest.mark.parametrize("cls", [flac.FlacPartsStream, flac.FlacSegsStream])
def test_stride_too_small_raises(cls):
    walk = cls(stride=64)
    walk.feed(stream_bytes("stereo16"))
    with pytest.raises(flac.FlacError, match="stride"):
        walk.next_parts() if cls is flac.FlacPartsStream else walk.next()
