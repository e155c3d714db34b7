"""The port's mesh inference vs the JAX package's mesh pipeline.

Two gloo ranks on the CPU (`opental_torch.parallel.dryrun.Ranks`) run
`InferencePipeline(mesh=...)` on three in-memory videos (frame 128,
crop 32, stride 64: 4, 9 and 5 windows, so forwards of `max_batch` 4
and padded tails); the JAX package runs its pipeline on `make_mesh(2)`
of the conftest's 8 CPU devices with the same seeded weights (the
port's state_dict through `utils/torch_convert`). Modes: per video and
packed, both with device ingest (two flushes of 1024 frames); the
shared backbone packed and RGB + flow fusion packed (flow one frame
short) in `test_torch_mesh_inference_shared.py`. Held per proposal (`pair_proposals`): equal classes and counts,
scores at rtol 1e-4 / atol 1e-6, segments at rtol 1e-4 / atol 1e-4;
both ranks return the same proposals. Also JAX's guards.
"""

import os

import numpy as np
import pytest
import torch

from opental_tpu.infer.pipeline import InferencePipeline as JPipeline
from opental_tpu.models.bdnet import BDNet as JBDNet
from opental_tpu.parallel import mesh as jmesh

from opental_torch import factory
from opental_torch.infer.pipeline import InferencePipeline
from opental_torch.infer.streaming import StreamingSession
from opental_torch.models.bdnet import BDNet
from opental_torch.parallel.dryrun import Ranks, assert_same_proposals
from opental_torch.parallel.mesh import Mesh

from test_torch_packed_inference import eval_shape_variables
from torch_suite import suite_policy  # noqa: F401 (autouse)

CLIP, CROP, STRIDE = 128, 32, 64
WORLD, BATCH, CAPACITY = 2, 4, 1024
LENGTHS = (320, 600, 350)
PIPE = dict(clip_length=CLIP, stride=STRIDE, crop_size=CROP,
            conf_thresh=0.01, top_k=50, nms_sigma=0.5, use_edl=True,
            os_head=True, device_post=False)
MODES = ('per_video', 'packed')   # the shared and fused modes: below


def port_models():
    kw = dict(num_classes=16, os_head=True, use_edl=True, frame_num=CLIP,
              crop_size=CROP)
    return (factory.init_weights(BDNet(**kw), seed=0),
            factory.init_weights(BDNet(in_channels=2, **kw), seed=1))


def videos():
    rng = np.random.RandomState(5)
    out = []
    for i, t in enumerate(LENGTHS):
        out.append((f'v{i}', rng.randint(0, 255, (t, CROP + 8, CROP + 8, 3),
                                         np.uint8), t, 10.0,
                    rng.randint(0, 255, (t - 1, CROP + 8, CROP + 8, 2),
                                np.uint8)))
    return out


def port_jobs(rgb, flow, vids, modes):
    rgb_only = [v[:4] for v in vids]
    packed = dict(max_batch=BATCH, frames_capacity=CAPACITY)

    def job(method, vs, kwargs, **kw):
        pipe = dict(PIPE, **kw.pop('pipe', {}))
        return ('infer', dict(model=rgb, pipe=pipe, method=method,
                              videos=vs, kwargs=kwargs, **kw))

    jobs = {'per_video': job('run_video', rgb_only, dict(max_batch=BATCH)),
            'packed': job('run_videos', rgb_only, packed),
            'shared': job('run_videos', rgb_only,
                          dict(frames_capacity=CAPACITY),
                          pipe={'shared_backbone': True}),
            'fused': job('run_videos', vids, packed, flow=flow)}
    return [jobs[m] for m in modes]


def jax_runs(tmp, rgb, flow, vids, modes):
    """{mode: JAX mesh proposals}, each pipeline on make_mesh(2)."""
    variables = []
    for name, model, ch in (('rgb', rgb, 3), ('flow', flow, 2)):
        path = os.path.join(tmp, f'{name}.ckpt')
        torch.save(model.state_dict(), path)
        jm = JBDNet(num_classes=16, os_head=True, use_edl=True,
                    frame_num=CLIP, in_channels=ch)
        variables.append((jm, eval_shape_variables(
            jm, path, (1, CLIP, CROP, CROP, ch))))
    (jm, jv), (fm, fv) = variables
    mesh = jmesh.make_mesh(WORLD)
    kw = {k: v for k, v in PIPE.items() if k != 'device_post'}
    rgb_only = [v[:4] for v in vids]
    out = {}
    if 'per_video' in modes or 'packed' in modes:
        ingest = JPipeline(jm, jv, mesh=mesh, device_ingest=True, **kw)
        out['per_video'] = {v[0]: ingest.run_video(v[1], v[2], v[3],
                                                   max_batch=BATCH)
                            for v in rgb_only}
        out['packed'] = ingest.run_videos(iter(rgb_only), max_batch=BATCH,
                                          frames_capacity=CAPACITY)
    if 'shared' in modes:
        shared = JPipeline(jm, jv, mesh=mesh, shared_backbone=True, **kw)
        out['shared'] = shared.run_videos(iter(rgb_only),
                                          frames_capacity=CAPACITY)
    if 'fused' in modes:
        fused = JPipeline(jm, jv, mesh=mesh, device_ingest=True,
                          flow_model=fm, flow_variables=fv, **kw)
        out['fused'] = fused.run_videos(iter(vids), max_batch=BATCH,
                                        frames_capacity=CAPACITY)
    return out


def mesh_runs(tmp, modes):
    """(JAX mesh proposals per mode, each rank's port proposals per
    mode); the ranks run while JAX compiles."""
    rgb, flow = port_models()
    vids = videos()
    ranks = Ranks(WORLD, port_jobs(rgb, flow, vids, modes), root=tmp)
    want = jax_runs(tmp, rgb, flow, vids, modes)
    got = [{mode: res['results'] for mode, res in zip(modes, r)}
           for r in ranks.results()]
    return want, got


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    return mesh_runs(str(tmp_path_factory.mktemp('mesh_infer')), MODES)


@pytest.mark.parametrize('mode', MODES)
def test_mesh_proposals_match_jax_mesh(runs, mode):
    want, got = runs
    n = assert_same_proposals(want[mode], got[0][mode], mode)
    assert n >= 50, n


@pytest.mark.parametrize('mode', MODES)
def test_ranks_return_the_same_proposals(runs, mode):
    _, got = runs
    assert got[0][mode] == got[1][mode]


def fake_mesh(size=WORLD):
    return Mesh(group=None, rank=0, size=size, device=torch.device('cpu'))


def test_mesh_guards():
    """The JAX pipeline's mesh guards (`opental_tpu/infer/pipeline.py:
    235-243, 276, 378, 729`, `infer/streaming.py:55-57`)."""
    rgb, flow = port_models()
    with pytest.raises(ValueError, match='device_ingest'):
        InferencePipeline(rgb, flow_model=flow, mesh=fake_mesh(),
                          device_ingest=False, **PIPE)
    with pytest.raises(ValueError, match='single-device'):
        InferencePipeline(rgb, flow_model=flow, mesh=fake_mesh(),
                          shared_backbone=True, **PIPE)
    with pytest.raises(ValueError, match='mesh'):
        InferencePipeline(rgb, mesh=fake_mesh(), device='cuda', **PIPE)
    pipe = InferencePipeline(rgb, mesh=fake_mesh(), **PIPE)
    assert pipe.device == torch.device('cpu')
    data = np.zeros((200, CROP, CROP, 3), np.uint8)
    with pytest.raises(ValueError, match='divide'):
        pipe.run_video(data, 200, 10.0, max_batch=3)
    with pytest.raises(ValueError, match='divide'):
        pipe.run_videos(iter([('a', data, 200, 10.0)]), max_batch=3)
    host = InferencePipeline(rgb, mesh=fake_mesh(), device_ingest=False,
                             **PIPE)
    with pytest.raises(ValueError, match='divide'):
        host.run_videos(iter([('a', data, 200, 10.0)]), max_batch=5)
    with pytest.raises(ValueError, match='multiple'):
        StreamingSession(pipe, 10.0, max_batch=3)
    StreamingSession(pipe, 10.0, max_batch=4)
