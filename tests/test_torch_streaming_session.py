"""`opental_torch.infer.streaming.StreamingSession` on the CPU: every
forward is one full (max_batch, ...) batch, a window runs once in offset
order, a stream shorter than a clip gives one window, a finalized session
refuses frames, float frames raise TypeError. Apart from
`test_torch_streaming.py` (the session against `run_video` and JAX) so
that the two run on separate workers under `--dist loadfile`; this file
builds only the port's BDNet (seeded `factory.init_weights`: these cases
check the session's bookkeeping, not its numbers) and imports no JAX."""

import numpy as np
import pytest
import torch

from opental_torch import factory
from opental_torch.infer import streaming
from opental_torch.infer.pipeline import InferencePipeline
from opental_torch.infer.streaming import StreamingSession
from opental_torch.models.bdnet import BDNet

from torch_suite import suite_policy  # noqa: F401 (autouse)

CLIP, STRIDE, CROP, BATCH = 128, 128, 32, 4
LENGTHS = (930, 100)          # 8 windows, the tail one off the stride;
#                               shorter than a clip
CHUNKS = (1, 3, 17, 64, 200)
KW = dict(clip_length=CLIP, stride=STRIDE, crop_size=CROP, use_edl=True,
          os_head=True)


def make_videos():
    return [np.random.RandomState(10 + i).randint(
        0, 255, (t, 40, 40, 3), np.uint8) for i, t in enumerate(LENGTHS)]


def feed_in_chunks(sess, video, seed):
    rng = np.random.RandomState(seed)
    resident, i = [], 0
    while i < video.shape[0]:
        n = int(rng.choice(CHUNKS))
        sess.feed(video[i:i + n])
        resident.append(sess.frames_resident)
        i += n
    return resident


@pytest.fixture(scope='module')
def models():
    tm = BDNet(num_classes=16, os_head=True, use_edl=True, frame_num=CLIP,
               crop_size=CROP)
    return factory.init_weights(tm, seed=4), make_videos()


def test_one_forward_shape_per_stream(models, monkeypatch):
    """Every forward of a session is one full (max_batch, ...) batch; a
    window runs once, in offset order."""
    tm, videos = models
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
    tm, videos = models
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
