"""`opental_torch.infer.streaming.StreamingSession` on the CPU in
float32: fed in uneven chunks (1-frame chunks among them), `finalize()`
equals the port's `run_video` on the whole video and the JAX package's
`StreamingSession` on the same frames and weights, per proposal at rtol
1e-4 (paired with `utils/propmatch.pair_proposals`), with host and with
device post-processing; `frames_resident` stays within one clip after
every feed (the session's forward shapes, short streams and float
frames: `test_torch_streaming_session.py`)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from opental_tpu.infer.pipeline import InferencePipeline as JPipeline
from opental_tpu.infer.streaming import StreamingSession as JSession
from opental_tpu.models.bdnet import BDNet as JBDNet
from opental_tpu.utils.propmatch import pair_proposals

from opental_torch.infer.pipeline import InferencePipeline
from opental_torch.infer.streaming import StreamingSession
from opental_torch.models.bdnet import BDNet
from opental_torch.utils.convert import from_jax_variables

from test_torch_streaming_session import (BATCH, CLIP, CROP, KW,
                                          feed_in_chunks, make_videos)
from test_torch_train_step import numpy_variables
from torch_suite import suite_policy  # noqa: F401 (autouse)


@pytest.fixture(scope='module')
def models():
    jm = JBDNet(num_classes=16, os_head=True, use_edl=True, frame_num=CLIP)
    x0 = jnp.zeros((1, CLIP, CROP, CROP, 3), jnp.float32)
    v = numpy_variables(dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                            x0)), seed=4)
    tm = BDNet(num_classes=16, os_head=True, use_edl=True, frame_num=CLIP,
               crop_size=CROP)
    tm.load_state_dict(from_jax_variables(v), strict=True)
    return jm, v, tm, make_videos()


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
