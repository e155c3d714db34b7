"""The port stands alone: no module of opental_torch, nor chip_smoke.py,
imports jax, flax or opental_tpu, and the entry points refuse to run
without a card unless the CPU is asked for."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'opental_tpu')


def port_modules():
    mods = []
    pkg = os.path.join(ROOT, 'opental_torch')
    for dirpath, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith('.py'):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                mod = rel[:-3].replace(os.sep, '.')
                mods.append(mod[:-len('.__init__')]
                            if mod.endswith('.__init__') else mod)
    return sorted(mods)


def test_imports_with_jax_blocked():
    code = textwrap.dedent(f"""
        import importlib, importlib.abc, sys
        BLOCKED = {BLOCKED!r}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split('.')[0] in BLOCKED:
                    raise ImportError('blocked: ' + name)
                return None

        for m in list(sys.modules):
            if m.split('.')[0] in BLOCKED:
                del sys.modules[m]
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {ROOT!r})
        for m in {port_modules()!r} + ['chip_smoke']:
            importlib.import_module(m)
        bad = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
        assert not bad, bad
        print('ok')
    """)
    res = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == 'ok', res.stderr


def test_no_jax_import_statements():
    files = [os.path.join(ROOT, 'chip_smoke.py')] + [
        os.path.join(ROOT, *m.split('.')) + '.py'
        if os.path.isfile(os.path.join(ROOT, *m.split('.')) + '.py')
        else os.path.join(ROOT, *m.split('.'), '__init__.py')
        for m in port_modules()]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split('.')[0] not in BLOCKED, (path, n)


def test_entry_points_need_a_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    from opental_torch.infer.pipeline import InferencePipeline
    from opental_torch.models.bdnet import BDNet
    from opental_torch.tools.test import build_pipeline, main
    from opental_torch.config import load_config

    model = BDNet(num_classes=5, os_head=True, use_edl=True, frame_num=64,
                  crop_size=32)
    with pytest.raises(RuntimeError, match='CUDA'):
        InferencePipeline(model)
    assert InferencePipeline(model, device='cpu').device.type == 'cpu'
    cfg = load_config(os.path.join(ROOT, 'configs',
                                   'thumos14_opental_final.yaml'))
    with pytest.raises(RuntimeError, match='CUDA'):
        build_pipeline(cfg)
    with pytest.raises(RuntimeError, match='CUDA'):
        main([os.path.join(ROOT, 'configs', 'thumos14_opental_final.yaml')])


def test_orbax_directory_is_refused(tmp_path):
    from opental_torch.models.bdnet import BDNet
    from opental_torch.tools.test import load_variables
    model = BDNet(num_classes=5, os_head=True, frame_num=64, crop_size=32)
    ckpt_dir = tmp_path / 'checkpoint-3'
    ckpt_dir.mkdir()
    with pytest.raises(ValueError, match='from_jax_variables'):
        load_variables(model, str(ckpt_dir))


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    res = subprocess.run([sys.executable, 'chip_smoke.py'],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_train_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    from opental_torch.config import load_config
    from opental_torch.tools import train as train_cli
    from opental_torch.train.loop import train
    cfg_path = os.path.join(ROOT, 'configs', 'thumos14_opental_final.yaml')
    with pytest.raises(RuntimeError, match='CUDA'):
        train(load_config(cfg_path))
    with pytest.raises(RuntimeError, match='CUDA'):
        train_cli.main([cfg_path])
    with pytest.raises(NotImplementedError, match='use_mesh'):
        train(load_config(cfg_path, overrides={'training.use_mesh': True}),
              device='cpu')


def test_training_modules_are_ported():
    """The training slice's modules are part of the port (and so of the
    blocked-import check above)."""
    mods = set(port_modules())
    assert {'opental_torch.train.step', 'opental_torch.train.loop',
            'opental_torch.train.checkpoint', 'opental_torch.tools.train',
            'opental_torch.losses.edl', 'opental_torch.losses.cls',
            'opental_torch.losses.boundary',
            'opental_torch.losses.multisegment',
            'opental_torch.data.prefetch',
            'opental_torch.utils.synthetic'} <= mods


def test_stem_modules_are_ported():
    """The stem-pack slice's modules are part of the port (and so of the
    blocked-import check above), and the kernel source is in the
    package."""
    assert {'opental_torch.ops.stem_pack',
            'opental_torch.ops.stem_pack_cuda'} <= set(port_modules())
    assert os.path.isfile(os.path.join(ROOT, 'opental_torch', 'csrc',
                                       'stem_pack.cu'))


def test_dataset_inference_modules_are_ported():
    """The dataset-scale inference slice's modules (threshold calibration,
    its CLI) are part of the port, and so of the blocked-import check
    above, and their CLIs refuse to run without a card unless the CPU is
    asked for."""
    assert {'opental_torch.openset.threshold',
            'opental_torch.tools.threshold',
            'opental_torch.tools.test',
            'opental_torch.infer.pipeline'} <= set(port_modules())
    if torch.cuda.is_available():
        return
    from opental_torch.tools import threshold
    cfg_path = os.path.join(ROOT, 'configs', 'thumos14_opental_final.yaml')
    with pytest.raises(RuntimeError, match='CUDA'):
        threshold.main([cfg_path, '--output_json', 'no_such_file.json'])


def test_anet_modules_are_ported():
    """The ActivityNet slice's modules are part of the port (and so of
    the blocked-import check above), and its CLI refuses to run without a
    card unless the CPU is asked for."""
    assert {'opental_torch.models.anet_pyramid',
            'opental_torch.losses.anet_multisegment',
            'opental_torch.data.anet',
            'opental_torch.tools.test_anet'} <= set(port_modules())
    if torch.cuda.is_available():
        return
    from opental_torch.tools import test_anet
    cfg_path = os.path.join(ROOT, 'configs', 'anet_opental.yaml')
    with pytest.raises(RuntimeError, match='CUDA'):
        test_anet.main([cfg_path])


OPENSET_CLIS = {
    'test_openmax': ['configs/thumos14_openmax.yaml'],
    'test_cross_data': ['configs/thumos14_opental_final.yaml'],
    'search_param': ['configs/thumos14_opental_final.yaml', '--gt_json',
                     'no_such_gt.json'],
}


@pytest.mark.parametrize('cli', sorted(OPENSET_CLIS))
def test_openset_modules_are_ported(cli):
    """The open-set slice's modules (the OpenMax baseline, the evaluator
    copies and the tools) are part of the port, and so of the
    blocked-import check above; each new CLI refuses to run without a
    card unless the CPU is asked for, before it reads or writes any
    file."""
    assert {'opental_torch.openset.libmr', 'opental_torch.openset.openmax',
            'opental_torch.eval.detection', 'opental_torch.eval.curves',
            'opental_torch.eval.metrics', 'opental_torch.tools.eval_open',
            'opental_torch.tools.test_openmax',
            'opental_torch.tools.test_cross_data',
            'opental_torch.tools.search_param'} <= set(port_modules())
    if torch.cuda.is_available():
        return
    import importlib
    mod = importlib.import_module(f'opental_torch.tools.{cli}')
    with pytest.raises(RuntimeError, match='CUDA'):
        mod.main([os.path.join(ROOT, a) if a.startswith('configs') else a
                  for a in OPENSET_CLIS[cli]])
