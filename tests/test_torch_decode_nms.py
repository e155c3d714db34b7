"""Port decode, soft-NMS and post-processing vs the JAX package, on the
CPU."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_suite import suite_policy  # noqa: F401 (autouse)

import jax.numpy as jnp

from opental_tpu.infer import decode as jd
from opental_tpu.infer import pipeline as jpipe
from opental_tpu.ops import nms as jnms

from opental_torch.infer import decode as td
from opental_torch.infer import pipeline as tpipe
from opental_torch.infer import post as tpost
from opental_torch.ops import _build, soft_nms_cuda
from opental_torch.ops import nms as tnms
from opental_torch.utils import profiling

W, P, K = 3, 126, 8


def random_out(seed, os_head=True, edl=True):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    out = {'loc': np.exp(f(W, P, 2)) * 10, 'prop_loc': f(W, P, 2) * 0.3,
           'conf': f(W, P, K) * 3, 'prop_conf': f(W, P, K) * 3,
           'center': f(W, P, 1),
           'priors': ((np.arange(P, dtype=np.float32) + 0.5) / P)[:, None]}
    if os_head:
        out['act'], out['prop_act'] = f(W, P, 1), f(W, P, 1)
    if edl:
        out['unct'] = rng.uniform(0, 1, (W, P)).astype(np.float32)
        out['prop_unct'] = rng.uniform(0, 1, (W, P)).astype(np.float32)
    return out


@pytest.mark.parametrize('score_func', ['softmax', 'dirichlet'])
@pytest.mark.parametrize('os_head', [True, False])
def test_decode_windows(score_func, os_head):
    out = random_out(1, os_head=os_head)
    kw = dict(use_edl=True, os_head=os_head, score_func=score_func,
              evidence='exp')
    want = jd.decode_windows({k: jnp.asarray(v) for k, v in out.items()},
                             256, **kw)
    got = td.decode_windows({k: torch.from_numpy(v) for k, v in out.items()},
                            256, **kw)
    for field in td.DecodedWindows._fields:
        w, g = getattr(want, field), getattr(got, field)
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=field)


def test_fuse_streams():
    a, b = random_out(2), random_out(3)
    want = jd.fuse_streams({k: jnp.asarray(v) for k, v in a.items()},
                           {k: jnp.asarray(v) for k, v in b.items()})
    got = td.fuse_streams({k: torch.from_numpy(v) for k, v in a.items()},
                          {k: torch.from_numpy(v) for k, v in b.items()})
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)


def random_block(seed, n=300, d=5):
    rng = np.random.RandomState(seed)
    start = rng.uniform(0, 100, n).astype(np.float32)
    block = np.stack([start, start + rng.uniform(0.5, 20, n),
                      rng.uniform(0, 1, n), rng.uniform(0, 1, n),
                      rng.uniform(0, 1, n)], -1)[:, :d].astype(np.float32)
    block[::7, 2] = 5e-4          # below the score floor
    return block


@pytest.mark.parametrize('seed', [0, 1])
def test_soft_nms_numpy_copy(seed):
    block = random_block(seed)
    for top_k in (10, 1000):
        want, wn = jnms.soft_nms_numpy(block, sigma=0.5, top_k=top_k)
        got, gn = tnms.soft_nms_numpy(block, sigma=0.5, top_k=top_k)
        assert gn == wn
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('top_k,check_every', [(200, 64), (37, 5), (5000, 1)])
def test_soft_nms_device_batched(top_k, check_every):
    blocks = np.stack([random_block(s, n=256) for s in range(4)])
    valid = np.random.RandomState(9).rand(4, 256) > 0.2
    got, count = tnms.soft_nms_device(torch.from_numpy(blocks), sigma=0.5,
                                      top_k=top_k,
                                      valid=torch.from_numpy(valid),
                                      check_every=check_every)
    for c in range(4):
        want, wc = jnms.soft_nms_device(jnp.asarray(blocks[c]), sigma=0.5,
                                        top_k=top_k,
                                        valid=jnp.asarray(valid[c]))
        want = np.asarray(want)
        assert int(count[c]) == int(wc)
        np.testing.assert_array_equal(got[c, :, -1].numpy(), want[:, -1])
        np.testing.assert_allclose(got[c].numpy(), want, rtol=1e-5,
                                   atol=1e-7)


def test_soft_nms_cuda_wrapper_rejects_without_building():
    """The kernel's wrapper imports without CUDA, and raises (instead of
    building or falling back) on CPU tensors and on input that is not
    float32."""
    block = torch.from_numpy(random_block(0, n=64))
    with pytest.raises(ValueError, match='CUDA'):
        soft_nms_cuda.soft_nms(block, None, 0.5, 200, 1e-3)
    with pytest.raises(TypeError, match='float32'):
        soft_nms_cuda.soft_nms(block.double(), None, 0.5, 200, 1e-3)
    assert not soft_nms_cuda._fns
    assert soft_nms_cuda.NAME not in _build._LOADED


def test_soft_nms_device_on_cpu_is_the_plain_loop(monkeypatch):
    """On CPU tensors `soft_nms_device` runs `soft_nms_plain` (the same
    blocks, counts and `nms.steps`) and launches no kernel."""
    blocks = torch.from_numpy(np.stack([random_block(s, n=128)
                                        for s in range(3)]))
    valid = torch.from_numpy(np.random.RandomState(4).rand(3, 128) > 0.3)
    want, want_count = tnms.soft_nms_plain(blocks, top_k=37, valid=valid)
    calls = []
    plain = tnms.soft_nms_plain

    def spy(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(tnms, 'soft_nms_plain', spy)
    launches = soft_nms_cuda.LAUNCHES
    with profiling.recording():
        got, count = tnms.soft_nms_device(blocks, top_k=37, valid=valid)
    steps = [c.n for c in profiling.recorded().counts
             if c.name == 'nms.steps']
    assert calls == [1] and soft_nms_cuda.LAUNCHES == launches
    assert torch.equal(got, want) and torch.equal(count, want_count)
    assert steps == [37]      # the loop runs out at top_k


class _Stub(torch.nn.Module):
    head_classes = K


def random_dec(seed=0, n=5):
    rng = np.random.RandomState(seed)
    start = rng.uniform(0, 250, (n, P, 1)).astype(np.float32)
    seg = np.concatenate(
        [start, start + rng.uniform(2, 40, (n, P, 1)).astype(np.float32)],
        -1).clip(0, 256)
    scores = rng.uniform(0, 0.2, (n, P, K)).astype(np.float32)
    unct = rng.uniform(0, 1, (n, P)).astype(np.float32)
    act = 1 / (1 + np.exp(-rng.uniform(-3, 3, (n, P)).astype(np.float32)))
    return seg, scores, unct, act


def _same_props(got, want):
    key = lambda p: (p['cls'], -p['score'], p['segment'][0])  # noqa: E731
    got, want = sorted(got, key=key), sorted(want, key=key)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a['cls'] == b['cls']
        np.testing.assert_allclose(a['score'], b['score'], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(a['segment'], b['segment'], atol=1e-4)
        np.testing.assert_allclose(a['uncertainty'], b['uncertainty'],
                                   rtol=1e-5)
        np.testing.assert_allclose(a['actionness'], b['actionness'],
                                   rtol=1e-5)


@pytest.mark.parametrize('seed,n_cand', [(0, 1024), (1, 64)])
def test_device_post_matches_jax(seed, n_cand):
    seg, scores, unct, act = random_dec(seed)
    offsets, fps = [0, 128, 256, 384, 512], 10.0
    kw = dict(clip_length=256, conf_thresh=0.01, top_k=200, nms_sigma=0.5,
              use_edl=True, os_head=True, n_candidates=n_cand)
    jp = jpipe.InferencePipeline(SimpleNamespace(head_classes=K, apply=None),
                                 variables=None, device_post=True, **kw)
    want = jp._post_process_on_device(
        jd.DecodedWindows(jnp.asarray(seg), jnp.asarray(scores),
                          jnp.asarray(unct), jnp.asarray(act)),
        offsets, fps, n=5)
    tp = tpipe.InferencePipeline(_Stub(), device='cpu', **kw)
    got = tp.post_process_on_device(
        td.DecodedWindows(*map(torch.from_numpy, (seg, scores, unct, act))),
        offsets, fps)
    _same_props(got, want)
    # and the host path gives the same proposals
    host = tp.post_process(
        (seg + np.asarray(offsets, np.float32)[:, None, None]) / fps,
        scores, unct, act)
    want_host = jp._post_process(
        (seg + np.asarray(offsets, np.float32)[:, None, None]) / fps,
        scores, unct, act)
    assert host == want_host


# (os_head, use_edl, videos, score floor and soft-NMS floor, actionness
# gate, sigma, durations): each caller's settings of `infer.post`
POST_CASES = {
    'thumos_oshead_edl': (True, True, 1, 0.01, 1e-3, True, 0.5, None),
    'thumos_softmax': (False, False, 1, 0.01, 1e-3, False, 0.5, None),
    'anet_oshead_edl': (True, True, 3, 0.001, 1e-3, True, 0.85,
                        [30.0, 9.0, 61.5]),
    'anet_binary': (True, True, 3, 1e-9, 1e-9, False, 0.85,
                    [30.0, 9.0, 61.5]),
}


@pytest.mark.parametrize('case', list(POST_CASES))
def test_device_post_matches_host(case):
    """`infer.post.device_blocks` (the plain loop on the CPU) with every
    candidate in the preselect keeps the rows `host_rows` keeps, video
    by video, and `proposals` formats both alike (with the duration clamp
    where a duration is given)."""
    os_head, use_edl, b, floor, nms_floor, gate, sigma, durations = \
        POST_CASES[case]
    seg, scores, unct, act = random_dec(seed=3, n=b * 2)
    if durations is not None:       # ANet: one 768-frame window a video
        seg = seg.reshape(b, -1, 2) * 3
        scores = scores.reshape(b, -1, K) * 0.05
        unct, act = unct.reshape(b, -1), act.reshape(b, -1)
    fps = torch.from_numpy(np.float32([10.0, 7.5, 29.97][:b]))
    seconds = torch.from_numpy(seg).reshape(b, -1, 2) / fps[:, None, None]
    scores_t = torch.from_numpy(scores).reshape(b, -1, K)
    unct_t = torch.from_numpy(unct).reshape(b, -1) if use_edl else None
    act_t = torch.from_numpy(act).reshape(b, -1) if os_head else None
    cls_cols = tpost.class_columns(K, os_head)
    n = scores_t.shape[1]
    blocks = tpost.device_blocks(seconds, scores_t, unct_t, act_t, cls_cols,
                                 floor, gate, n, sigma, 200, nms_floor)
    assert blocks.shape == (b, len(cls_cols), n, 4 + use_edl + os_head)
    total = 0
    for v in range(b):
        duration = None if durations is None else durations[v]
        got = tpost.proposals(tpost.device_rows(blocks[v].numpy(), cls_cols),
                              use_edl, os_head, duration)
        host = [None if t is None else t[v].numpy()
                for t in (seconds, scores_t, unct_t, act_t)]
        want = tpost.proposals(
            tpost.host_rows(*host, cls_cols, floor, gate, sigma, 200,
                            nms_floor), use_edl, os_head, duration)
        _same_props(got, want)
        if duration is not None:
            assert all(0 <= p['segment'][0] < p['segment'][1] <= duration
                       for p in got)
        total += len(got)
    assert total > 20


def test_window_offsets_and_device_windows():
    for args in ((100, 128, 64), (300, 128, 64), (256, 256, 128),
                 (1000, 256, 128)):
        assert tpipe.window_offsets(*args) == jpipe.window_offsets(*args)
    rng = np.random.RandomState(0)
    t, clip = 300, 128
    video = rng.randint(0, 255, (384, 16, 16, 3), np.uint8)
    video[t:] = 0
    offsets = [0, 64, 128, 172, 256]
    want = np.asarray(jpipe.device_windows(
        jnp.asarray(video), jnp.asarray(offsets, jnp.int32), jnp.int32(t),
        clip))
    got = tpipe.device_windows(torch.from_numpy(video),
                               torch.as_tensor(offsets), t, clip)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 4, 1), want,
                               rtol=0, atol=1e-6)
