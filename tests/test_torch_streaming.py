"""`opental_torch.infer.streaming.StreamingSession` on the CPU in
float32: fed in uneven chunks (1-frame chunks among them), `finalize()`
equals the port's `run_video` on the whole video and the JAX package's
`StreamingSession` on the same frames and weights, per proposal at rtol
1e-4 (paired with `utils/propmatch.pair_proposals`), with host and with
device post-processing; `frames_resident` stays within one clip after
every feed, every forward has one shape, float frames raise TypeError."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opental_tpu.infer.pipeline import InferencePipeline as JPipeline
from opental_tpu.infer.streaming import StreamingSession as JSession
from opental_tpu.models.bdnet import BDNet as JBDNet
from opental_tpu.utils.propmatch import pair_proposals

from opental_torch.infer import streaming
from opental_torch.infer.pipeline import InferencePipeline
from opental_torch.infer.streaming import StreamingSession
from opental_torch.models.bdnet import BDNet
from opental_torch.utils.convert import from_jax_variables

from test_torch_train_step import numpy_variables

CLIP, STRIDE, CROP, BATCH = 128, 128, 32, 4
LENGTHS = (930, 100)          # 8 windows, the tail one off the stride;
#                               shorter than a clip
CHUNKS = (1, 3, 17, 64, 200)
KW = dict(clip_length=CLIP, stride=STRIDE, crop_size=CROP, use_edl=True,
          os_head=True)


@pytest.fixture(autouse=True, scope='module')
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def models():
    jm = JBDNet(num_classes=16, os_head=True, use_edl=True, frame_num=CLIP)
    x0 = jnp.zeros((1, CLIP, CROP, CROP, 3), jnp.float32)
    v = numpy_variables(dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                            x0)), seed=4)
    tm = BDNet(num_classes=16, os_head=True, use_edl=True, frame_num=CLIP,
               crop_size=CROP)
    tm.load_state_dict(from_jax_variables(v), strict=True)
    videos = [np.random.RandomState(10 + i).randint(
        0, 255, (t, 40, 40, 3), np.uint8) for i, t in enumerate(LENGTHS)]
    return jm, v, tm, videos


def feed_in_chunks(sess, video, seed):
    rng = np.random.RandomState(seed)
    resident, i = [], 0
    while i < video.shape[0]:
        n = int(rng.choice(CHUNKS))
        sess.feed(video[i:i + n])
        resident.append(sess.frames_resident)
        i += n
    return resident


def assert_same(want, got):
    """Each proposal paired with its counterpart: the same class, score,
    segment, uncertainty and actionness at rtol 1e-4."""
    assert len(got) == len(want)
    for a, b in pair_proposals(want, got):
        assert a['cls'] == b['cls']
        np.testing.assert_allclose(b['score'], a['score'], rtol=1e-4)
        np.testing.assert_allclose(b['segment'], a['segment'], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(b['uncertainty'], a['uncertainty'],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(b['actionness'], a['actionness'],
                                   rtol=1e-4)


@pytest.mark.parametrize('device_post', [False, True])
def test_finalize_matches_run_video_and_jax(models, device_post,
                                            monkeypatch):
    jm, v, tm, videos = models
    pipe = InferencePipeline(tm, device_post=device_post, device='cpu',
                             **KW)
    jpipe = JPipeline(jm, v, device_post=device_post, **KW)
    shapes = []
    fwd = pipe.forward_decode
    monkeypatch.setattr(pipe, 'forward_decode', lambda clips: (
        shapes.append(tuple(clips.shape)), fwd(clips))[1])
    total = 0
    for i, video in enumerate(videos):
        t = len(video)
        want = pipe.run_video(video, t, 10.0)
        sess = StreamingSession(pipe, 10.0, max_batch=BATCH)
        resident = feed_in_chunks(sess, video, seed=i)
        assert max(resident) <= CLIP
        assert sess.frames_received == t
        if sess.windows_processed:
            assert isinstance(sess.preview(), list)
        got = sess.finalize()
        assert sess.finalize() is got
        assert_same(want, got)
        jsess = JSession(jpipe, 10.0, max_batch=BATCH)
        feed_in_chunks(jsess, video, seed=i)
        assert_same(jsess.finalize(), got)
        total += len(got)
    assert total > 50
    # run_video's forwards take a video's 8 and 1 windows at once; a
    # session's take BATCH each, ceil(windows / BATCH) per video
    streamed = [s for s in shapes if s[0] == BATCH]
    assert len(streamed) == sum(-(-n // BATCH) for n in (8, 1))
    assert all(s == (BATCH, 3, CLIP, CROP, CROP) for s in streamed)


def test_one_forward_shape_per_stream(models, monkeypatch):
    """Every forward of a session is one full (max_batch, ...) batch; a
    window runs once, in offset order."""
    _, _, tm, videos = models
    pipe = InferencePipeline(tm, device='cpu', **KW)
    seen = []
    monkeypatch.setattr(streaming, 'ingest_windows', lambda clips, valid: (
        seen.append((clips.clone(), valid.clone())),
        torch.zeros((clips.shape[0], 3, CLIP, CROP, CROP)))[1])
    video = videos[0]
    sess = StreamingSession(pipe, 10.0, max_batch=BATCH)
    feed_in_chunks(sess, video, seed=5)
    sess.finalize()
    offsets = list(range(0, len(video) - CLIP + 1, STRIDE))
    offsets.append(len(video) - CLIP)
    rows = [(c[i], int(n[i])) for c, n in seen for i in range(BATCH)
            if n[i] > 0]
    assert all(c.shape == (BATCH, CLIP, CROP, CROP, 3) for c, _ in seen)
    assert len(rows) == len(offsets) == sess.windows_processed
    crop = video[:, 4:36, 4:36]
    for off, (win, n) in zip(offsets, rows):
        assert n == CLIP
        np.testing.assert_array_equal(win.numpy(), crop[off:off + CLIP])


def test_short_stream_and_float_frames(models):
    _, _, tm, videos = models
    pipe = InferencePipeline(tm, device='cpu', **KW)
    sess = StreamingSession(pipe, 10.0, max_batch=BATCH)
    assert sess.feed(videos[1][:50]) == 0
    assert sess.windows_processed == 0 and sess.frames_resident == 50
    sess.finalize()
    assert sess.windows_processed == 1
    with pytest.raises(RuntimeError, match='finalized'):
        sess.feed(videos[1][:5])
    sess = StreamingSession(pipe, 10.0, max_batch=BATCH)
    with pytest.raises(TypeError, match='uint8'):
        sess.feed(videos[1][:5].astype(np.float32))
    with pytest.raises(ValueError, match='single-stream'):
        StreamingSession(InferencePipeline(tm, flow_model=tm, device='cpu',
                                           **KW), 10.0)
