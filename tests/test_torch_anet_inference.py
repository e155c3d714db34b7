"""The port's ActivityNet inference and calibration vs the JAX package's,
on the CPU in float32.

One synthetic ANet dataset (`make_synthetic_anet_dataset`, frame 256,
crop 32; 4 validation videos of 128 to 256 frames, so padded, plus one
of 300 frames, so cut; 3 training videos), random 2-channel flow npys,
and seeded port weights (RGB, flow) saved as torch .ckpt files. JAX's
`tools.test_anet.run_test_anet` runs in float32 (its build_model's
bf16 dtype dropped) on weights it loads from those files through its
ANet key map (`map_anet_bdnet_key`), with video_batch 2: 3 forwards and
a padded tail batch. Held, per proposal after `pair_proposals` (score,
segment, uncertainty, actionness at rtol 1e-4) and by the JAX
evaluator's metrics (mAP at tIoU 0.1:0.5, AUROC / AUPR) at atol 1e-6:
 * the port's run with the device post-processing (the default) and
   with the host numpy loop (`testing.device_nms: false`);
 * `tools.threshold` (the port's CLI) on the ANet config, fused RGB +
   flow in the binary-actionness mode, against JAX's `calibrate_anet`
   over the training videos of a video-level classifier file: the
   threshold at rtol 1e-4 and the thresholding JSON per proposal.
The CLI reads an existing thresholding file before it routes
(`test_torch_anet_threshold_cli.py`).
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from torch_suite import suite_policy  # noqa: F401 (autouse)

import jax
import jax.numpy as jnp

from opental_tpu import factory as jax_factory
from opental_tpu.config import load_config as jax_load_config
from opental_tpu.eval.detection import DetectionEvaluator
from opental_tpu.openset import threshold as jax_threshold
from opental_tpu.tools import test_anet as jax_test_anet
from opental_tpu.utils.propmatch import pair_proposals
from opental_tpu.utils.torch_convert import (align_bn_collections,
                                             convert_state_dict,
                                             load_torch_file,
                                             map_anet_bdnet_key,
                                             merge_variables)

from opental_torch import factory
from opental_torch.config import load_config
from opental_torch.tools import test_anet
from opental_torch.tools import threshold as threshold_cli
from opental_torch.utils.synthetic import make_synthetic_anet_dataset

CLIP, CROP, BATCH = 256, 32, 2
CLASSES = [f'Act{i:02d}' for i in range(1, 5)]


def write_cls_file(path, names, seed):
    rng = np.random.RandomState(seed)
    with open(path, 'w') as f:
        json.dump({'results': {n[2:]: rng.rand(len(CLASSES)).tolist()
                               for n in names}, 'class': CLASSES}, f)
    return path


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    """(root, config path, overrides): the dataset with a 300-frame
    validation video added, flow npys, checkpoints and classifier files."""
    root = str(tmp_path_factory.mktemp('anet_infer') / 'synth')
    cfg_path = make_synthetic_anet_dataset(root, n_train=3, n_val=4,
                                           clip_length=CLIP, crop_size=CROP)
    anno = os.path.join(root, 'annotations', 'video_info.json')
    npy = os.path.join(root, 'npy')
    with open(anno) as f:
        info = json.load(f)
    rng = np.random.RandomState(11)
    video = rng.randint(0, 255, (300, 40, 40, 3), dtype=np.uint8)
    video[40:140] += 40
    np.save(os.path.join(npy, 'v_validation_long.npy'), video)
    info['v_validation_long'] = {
        'subset': 'validation', 'frame_num': 300, 'fps': 5.0,
        'duration': 60.0, 'annotations': [
            {'label_id': 2, 'label': 'Act02', 'start_frame': 40,
             'end_frame': 140}]}
    with open(anno, 'w') as f:
        json.dump(info, f)
    flow = os.path.join(root, 'flow_npy')
    os.makedirs(flow)
    for name in sorted(os.listdir(npy)):
        t = np.load(os.path.join(npy, name), mmap_mode='r').shape[0]
        np.save(os.path.join(flow, name),
                rng.randint(0, 255, (t, 40, 40, 2), dtype=np.uint8))
    cfg = load_config(cfg_path)
    ckpts = {}
    for name, ch, seed in (('rgb', 3, 0), ('flow', 2, 1)):
        model = factory.init_weights(factory.build_model(
            cfg, frame_num=CLIP, crop_size=CROP, in_channels=ch), seed=seed)
        ckpts[name] = os.path.join(root, f'{name}.ckpt')
        torch.save(model.state_dict(), ckpts[name])
    train = sorted(n for n, v in info.items() if v['subset'] == 'training')
    files = {'train_cls': write_cls_file(os.path.join(root,
                                                      'train_cls.json'),
                                         train[:2], 1)}
    overrides = {'model.compute_dtype': 'float32',
                 'testing.checkpoint_path': ckpts['rgb'],
                 'testing.flow_checkpoint_path': ckpts['flow'],
                 'testing.flow_data_path': flow}
    return root, cfg_path, overrides, files


def jax_variables(model, checkpoint_path, sample_shape):
    """JAX's load_variables for a torch ANet .ckpt: the ANet key map onto
    a `jax.eval_shape` template (strict merge)."""
    template = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                              jnp.zeros(sample_shape, jnp.float32))
    loaded = align_bn_collections(
        convert_state_dict(load_torch_file(checkpoint_path),
                           map_anet_bdnet_key), template['params'])
    return {k: merge_variables(template[k], loaded[k], strict=True)
            for k in ('params', 'constants')}


@pytest.fixture(scope='module')
def jax_runs(dataset):
    """{run: JSON path or threshold} of the JAX package in float32."""
    root, cfg_path, overrides, files = dataset
    real_build = jax_factory.build_model
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_test_anet, 'load_variables', jax_variables)
        mp.setattr(jax_factory, 'build_model', lambda cfg, dtype=None, **kw:
                   real_build(cfg, **kw))

        def cfg(name, **extra):
            return jax_load_config(cfg_path, overrides=dict(
                overrides, **extra, **{'testing.output_json': name}))

        out['plain'] = jax_test_anet.run_test_anet(cfg('jax_plain.json'),
                                                   video_batch=BATCH)
        out['threshold'] = jax_threshold.calibrate_anet(
            cfg('jax_thr.json', **{'testing.fusion': True}), binary=True,
            cls_score_file=files['train_cls'])
        out['thr_json'] = os.path.join(root, 'output', 'jax_thr.json')
    return out


def port_run(dataset, name, **kw):
    _, cfg_path, overrides, _ = dataset
    extra = kw.pop('extra', {})
    path = test_anet.run_test_anet(load_config(cfg_path, overrides=dict(
        overrides, **extra, **{'testing.output_json': name})),
        video_batch=BATCH, device='cpu', **kw)
    with open(path) as f:
        return path, json.load(f)


def assert_same(want, got):
    assert set(got['results']) == set(want['results'])
    total = 0
    for vid, w in want['results'].items():
        g = got['results'][vid]
        assert len(g) == len(w), (vid, len(g), len(w))
        for a, b in pair_proposals([dict(p, cls=p['label']) for p in w],
                                   [dict(p, cls=p['label']) for p in g]):
            assert a['cls'] == b['cls'], (vid, a, b)
            np.testing.assert_allclose(b['score'], a['score'], rtol=1e-4,
                                       atol=1e-9)
            np.testing.assert_allclose(b['segment'], a['segment'],
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(b['uncertainty'], a['uncertainty'],
                                       rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(b['actionness'], a['actionness'],
                                       rtol=1e-4)
        total += len(w)
    return total


def metrics(root, pred_path):
    """mAP at tIoU 0.1:0.5 and AUROC / AUPR of the proposals in a fixed
    order (the host loop keeps a class's rows in prior order, the device
    post in score order; the evaluator breaks ties by file order)."""
    with open(pred_path) as f:
        payload = json.load(f)
    for props in payload['results'].values():
        props.sort(key=lambda p: (p['label'], -p['score'], p['segment']))
    sorted_path = pred_path + '.sorted.json'
    with open(sorted_path, 'w') as f:
        json.dump(payload, f)
    anno = os.path.join(root, 'annotations')
    ev = DetectionEvaluator(
        os.path.join(anno, 'gt_open.json'), sorted_path,
        os.path.join(anno, 'action_known.txt'),
        tiou_thresholds=np.arange(0.1, 0.6, 0.1), ood_scoring='uncertainty',
        subset=['validation'], openset=True, dataset='anet')
    m_ap, _, _ = ev.evaluate('AP')
    ev.pre_evaluate()
    auc = ev.evaluate('AUC')
    return np.concatenate([np.atleast_1d(np.asarray(x, np.float64))
                           for x in (m_ap, *auc)])


@pytest.mark.parametrize('post', ['device', 'host'])
def test_run_test_anet_matches_jax(dataset, jax_runs, post):
    root = dataset[0]
    path, got = port_run(dataset, f'port_{post}.json', extra={
        'testing.device_nms': post == 'device'})
    with open(jax_runs['plain']) as f:
        want = json.load(f)
    assert got['version'] == 'ActivityNet-v1.3'
    assert 'validation_long' in got['results']
    assert not any(k.startswith('v_') for k in got['results'])
    assert assert_same(want, got) > 50
    for props in got['results'].values():
        for p in props:
            assert 0.0 <= p['segment'][0] < p['segment'][1]
    np.testing.assert_allclose(metrics(root, path),
                               metrics(root, jax_runs['plain']), atol=1e-6)


def cli_config(dataset, path):
    _, cfg_path, overrides, _ = dataset
    with open(cfg_path) as f:
        raw = yaml.safe_load(f)
    for dotted, value in overrides.items():
        *parents, leaf = dotted.split('.')
        cur = raw
        for p in parents:
            cur = cur.setdefault(p, {})
        cur[leaf] = value
    with open(path, 'w') as f:
        yaml.safe_dump(raw, f)
    return path


def test_threshold_cli_matches_jax_calibrate_anet(dataset, jax_runs,
                                                  capsys):
    """The ANet config routes to calibrate_anet over the training videos
    of the classifier file, each with the classifier's class; a second
    call reads the file back."""
    root, _, _, files = dataset
    cfg = cli_config(dataset, os.path.join(root, 'anet_thr.yaml'))
    outs = []
    for _ in range(2):
        threshold_cli.main([cfg, '--device', 'cpu', '--fusion', '--binary',
                            '--cls_score_file', files['train_cls'],
                            '--output_json', 'port_thr.json'])
        outs.append(capsys.readouterr().out)
    thr = [float(o.rsplit('The threshold is: ', 1)[1].split()[0])
           for o in outs]
    np.testing.assert_allclose(thr[0], jax_runs['threshold'], rtol=1e-4)
    assert 'already exist' in outs[1] and thr[1] == thr[0]
    with open(jax_runs['thr_json']) as f:
        want = json.load(f)
    with open(os.path.join(root, 'output', 'port_thr.json')) as f:
        got = json.load(f)
    assert len(got['results']) == 2        # the classifier file's videos
    assert assert_same(want, got) > 20
    with open(files['train_cls']) as f:
        cls = json.load(f)
    for vid, props in got['results'].items():
        label = CLASSES[int(np.argmax(cls['results'][vid]))]
        assert props and all(p['label'] == label for p in props), vid
    np.testing.assert_allclose(got['external_data']['threshold'],
                               jax_runs['threshold'], rtol=1e-4)
