"""The port's open-set split and GT tools (`opental_torch/openset/splits.py`,
and the `tools.preprocess` subcommands that drive them) against the JAX
package's, on annotation trees the test writes.

Both packages run in one process, so the seed-123 draws (and the python
set order of the ANet known classes, which follows the process's string
hashing) are the same for both: every file they write must be equal
byte for byte.
"""

import csv
import json
import os

import numpy as np

from torch_suite import suite_policy  # noqa: F401 (autouse)

from opental_tpu.openset import splits as jax_splits
from opental_tpu.tools import preprocess as jax_preprocess

from opental_torch.openset import splits
from opental_torch.tools import preprocess

THUMOS_CLASSES = [
    (7, 'BaseballPitch'), (9, 'BasketballDunk'), (12, 'Billiards'),
    (21, 'CleanAndJerk'), (22, 'CliffDiving'), (23, 'CricketBowling'),
    (24, 'CricketShot'), (26, 'Diving'), (31, 'FrisbeeCatch'),
    (33, 'GolfSwing'), (36, 'HammerThrow'), (40, 'HighJump'),
    (45, 'JavelinThrow'), (51, 'LongJump'), (68, 'PoleVault'),
    (79, 'Shotput'), (85, 'SoccerPenalty'), (92, 'TennisSwing'),
    (93, 'ThrowDiscus'), (97, 'VolleyballSpiking'),
]

GT = {
    'database': {
        'vid_a': {'subset': 'validation', 'duration': 10.0,
                  'annotations': [
                      {'label': 'Diving', 'segment': [1.0, 3.0]},
                      {'label': 'Surfing', 'segment': [5.0, 7.0]}]},
        'vid_b': {'subset': 'validation', 'duration': 8.0,
                  'annotations': [
                      {'label': 'Knitting', 'segment': [0.5, 2.0]}]},
        'vid_c': {'subset': 'training', 'duration': 9.0,
                  'annotations': [
                      {'label': 'Diving', 'segment': [2.0, 4.0]}]},
    }
}


def write_thumos_anno_tree(root):
    """An annotations/ tree in the reference's on-disk format: the class
    index, val/test annotation CSVs (with an Ambiguous row and a blank
    row), the GT JSON and the video info CSVs."""
    anno = root / 'annotations'
    anno.mkdir(parents=True)
    with open(anno / 'Class_Index_Detection.txt', 'w') as f:
        for ori, name in THUMOS_CLASSES:
            f.write(f'{ori} {name}\n')
    header = ['video', 'type', 'type_idx', 'start', 'end',
              'startFrame', 'endFrame']
    rows = []
    for i, (_, name) in enumerate(THUMOS_CLASSES):
        rows.append([f'video_{i:04d}', name, str(i + 1),
                     '1.5', '4.25', '15', '42'])
        rows.append([f'video_{i:04d}', name, str(i + 1),
                     '6.0', '9.5', '60', '95'])
    rows.append(['video_0000', 'Ambiguous', '0', '2.0', '3.0', '20', '30'])
    rows.append(['', '', '', '', '', '', ''])
    for phase in ('val', 'test'):
        with open(anno / f'{phase}_Annotation_ours.csv', 'w',
                  newline='') as f:
            w = csv.writer(f)
            w.writerow(header)
            w.writerows(rows)
    gt = {'version': 'THUMOS14', 'database': {}, 'external_data': {}}
    for i, (_, name) in enumerate(THUMOS_CLASSES):
        gt['database'][f'video_{i:04d}'] = {
            'subset': 'test', 'duration': 10.0,
            'annotations': [
                {'label': name, 'segment': [1.5, 4.25]},
                {'label': THUMOS_CLASSES[(i + 1) % 20][1],
                 'segment': [6.0, 9.5]},
            ]}
    (anno / 'thumos_gt.json').write_text(json.dumps(gt))
    for phase in ('val', 'test'):
        (anno / f'{phase}_video_info.csv').write_text(
            'video,fps\nvideo_0000,30\n')
    return anno


def write_anet_anno_tree(root, n_classes=12, n_videos=24, seed=0):
    """An ActivityNet annotations/ tree: action_name.txt and
    video_info_train_val.json over both subsets."""
    rng = np.random.RandomState(seed)
    anno = root / 'anet_annotations'
    anno.mkdir(parents=True)
    names = [f'Action{c:02d}' for c in range(n_classes)]
    (anno / 'action_name.txt').write_text(''.join(n + '\n' for n in names))
    info = {}
    for v in range(n_videos):
        anns = [{'label': names[rng.randint(n_classes)],
                 'segment': [float(s), float(s + 2.5)]}
                for s in rng.uniform(0, 20, rng.randint(1, 4))]
        info[f'v_{v:05d}'] = {
            'subset': 'training' if v % 3 else 'validation',
            'duration': 30.0, 'annotations': anns}
    (anno / 'video_info_train_val.json').write_text(json.dumps(info))
    return anno


def tree_bytes(root):
    """{relative path: file bytes} of every file under `root`."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, 'rb') as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def assert_same_trees(a, b):
    want, got = tree_bytes(a), tree_bytes(b)
    assert want, a
    assert sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], rel


def test_class_index_round_trip_matches_jax(tmp_path):
    anno = write_thumos_anno_tree(tmp_path)
    path = str(anno / 'Class_Index_Detection.txt')
    got = splits.read_class_index(path)
    assert got == jax_splits.read_class_index(path)
    ori, idx = got
    assert ori[7] == 1 and idx[20] == 'VolleyballSpiking'
    splits.write_class_index(str(tmp_path / 'port.txt'), idx, ori)
    jax_splits.write_class_index(str(tmp_path / 'jax.txt'), idx, ori)
    assert ((tmp_path / 'port.txt').read_bytes()
            == (tmp_path / 'jax.txt').read_bytes()
            == (anno / 'Class_Index_Detection.txt').read_bytes())


def test_annotation_filters_match_jax(tmp_path):
    anno = write_thumos_anno_tree(tmp_path)
    drop = ['Ambiguous', 'Diving', 'HighJump']
    for tag, mod in (('port', splits), ('jax', jax_splits)):
        mod.filter_annotation_csv(str(anno / 'val_Annotation_ours.csv'),
                                  str(tmp_path / f'{tag}.csv'), drop)
        mod.filter_gt_json(str(anno / 'thumos_gt.json'),
                           str(tmp_path / f'{tag}.json'), drop)
    for ext in ('csv', 'json'):
        assert ((tmp_path / f'port.{ext}').read_bytes()
                == (tmp_path / f'jax.{ext}').read_bytes()), ext
    rows = list(csv.reader(open(tmp_path / 'port.csv')))
    assert not {r[1] for r in rows[1:]} & set(drop)
    assert len(rows) == 1 + 2 * 18


def test_thumos_splits_match_jax(tmp_path):
    """The seed-123 generator, with the reference's RNG quirk (the draw
    is over indices 0..K-1 while the class ids are 1..K, so a split may
    hold 4 unknown classes): equal return value and equal files."""
    anno = write_thumos_anno_tree(tmp_path)
    got = splits.generate_thumos_splits(str(anno), str(tmp_path / 'port'))
    want = jax_splits.generate_thumos_splits(str(anno),
                                             str(tmp_path / 'jax'))
    assert got == want
    assert any(len(m) < 5 for m in got)
    assert_same_trees(tmp_path / 'jax', tmp_path / 'port')


def test_anet_splits_match_jax(tmp_path):
    anno = write_anet_anno_tree(tmp_path)
    splits.generate_anet_splits(str(anno), str(tmp_path / 'port'),
                                num_splits=3)
    jax_splits.generate_anet_splits(str(anno), str(tmp_path / 'jax'),
                                    num_splits=3)
    assert_same_trees(tmp_path / 'jax', tmp_path / 'port')
    known = (tmp_path / 'port' / 'split_0' / 'action_known.txt'
             ).read_text().split()
    assert len(known) == 9


def test_class_maps_and_filtered_database_match_jax(tmp_path):
    p = tmp_path / 'action_name.txt'
    p.write_text('Diving\nSurfing\n\nKnitting\n')
    assert splits.load_class_names(str(p)) == \
        jax_splits.load_class_names(str(p)) == ['Diving', 'Surfing',
                                                'Knitting']
    assert splits.class_maps(str(p)) == jax_splits.class_maps(str(p))
    for keep, subset in ((['Diving'], 'validation'),
                         (['Diving'], 'training'),
                         (['Knitting', 'Surfing'], 'validation')):
        assert splits.filtered_database(GT, keep, subset) == \
            jax_splits.filtered_database(GT, keep, subset)


def write_split_tree(root):
    root.mkdir(parents=True)
    gt_file = root / 'gt.json'
    gt_file.write_text(json.dumps(GT))
    known = [['Diving'], ['Knitting']]
    al = [['Diving', 'Surfing', 'Knitting'], ['Knitting', 'Diving']]
    for i in range(2):
        d = root / f'split_{i}'
        d.mkdir()
        (d / 'action_known.txt').write_text(
            ''.join(n + '\n' for n in known[i]))
        (d / 'action_all.txt').write_text(''.join(n + '\n' for n in al[i]))
    return str(gt_file)


def test_gt_writers_match_jax(tmp_path):
    """write_anet_val_gt, write_video_list and merge_thumos_anet_gt
    write the same files as JAX's."""
    for tag, mod in (('port', splits), ('jax', jax_splits)):
        root = tmp_path / tag
        gt_file = write_split_tree(root / 'anet')
        mod.write_anet_val_gt(gt_file, str(root / 'anet'), num_splits=2)
        vids = root / 'vids'
        vids.mkdir()
        for name in ('b.mp4', 'a.mp4', 'c.txt'):
            (vids / name).write_text('x')
        paths = mod.write_video_list(str(vids), str(root / 'list.txt'))
        assert [os.path.basename(p) for p in paths] == ['a.mp4', 'b.mp4']
        (root / 'list.txt').write_text(
            (root / 'list.txt').read_text().replace(str(vids), 'VIDS'))
        thumos = write_thumos_anno_tree(root / 'thumos') / 'thumos_gt.json'
        (root / 'overlap.txt').write_text('Knitting\n')
        n = mod.merge_thumos_anet_gt(str(thumos), gt_file,
                                     str(root / 'overlap.txt'),
                                     str(root / 'merged.json'))
        assert n == 20 + 1
    assert_same_trees(tmp_path / 'jax', tmp_path / 'port')


def run_cli(mod, root, anno, anet):
    """Every subcommand of the preprocess CLI that needs no video
    decoder, with the same arguments for both packages."""
    out = root / 'out'
    out.mkdir(parents=True)
    vids = root / 'vids'
    vids.mkdir()
    for name in ('b.mp4', 'a.mp4'):
        (vids / name).write_text('x')
    npy = root / 'npy'
    npy.mkdir()
    np.save(npy / 'v_00001.npy', np.zeros((37, 2, 2, 3), np.uint8))
    np.save(npy / 'v_00002.npy', np.zeros((50, 2, 2, 3), np.uint8))
    split_dir = root / 'anet_val'
    split_gt = write_split_tree(split_dir)
    mod.main(['thumos_splits', '--anno_path', str(anno),
              '--out_path', str(out / 'thumos_open'), '--num_splits', '3'])
    mod.main(['anet_splits', '--anno_path', str(anet),
              '--out_path', str(out / 'anet_open'), '--num_splits', '2',
              '--unknown_ratio', '0.5', '--seed', '7'])
    mod.main(['filter_annotations', '--src',
              str(anno / 'test_Annotation_ours.csv'),
              '--dst', str(out / 'filtered.csv'),
              '--drop', 'Ambiguous', 'Billiards'])
    mod.main(['anet_val_gt', '--video_info', split_gt,
              '--splits_dir', str(split_dir), '--num_splits', '2'])
    mod.main(['video_list', '--video_dir', str(vids),
              '--out_txt', str(out / 'list.txt')])
    (out / 'list.txt').write_text(
        (out / 'list.txt').read_text().replace(str(vids), 'VIDS'))
    (root / 'overlap.txt').write_text('Surfing\n')
    mod.main(['merge_gt', '--thumos_gt', str(anno / 'thumos_gt.json'),
              '--anet_gt', split_gt, '--overlap', str(root / 'overlap.txt'),
              '--out', str(out / 'merged.json')])
    anet_db = {'database': {
        '00001': {'subset': 'training', 'duration': 12.5, 'annotations': [
            {'label': 'Diving', 'label_id': 3, 'segment': [1.0, 4.0]}]},
        'v_00002': {'subset': 'validation', 'duration': 20.0,
                    'annotations': [{'label': 'Surfing',
                                     'segment': [2.0, 9.5]}]},
        '00003': {'subset': 'training', 'duration': 5.0,
                  'annotations': []}}}
    (root / 'anet_db.json').write_text(json.dumps(anet_db))
    mod.main(['anet_info', '--npy_dir', str(npy), '--anno_json',
              str(root / 'anet_db.json'), '--out_json',
              str(out / 'anet_info.json')])
    for d in (split_dir / 'split_0', split_dir / 'split_1'):
        for name in ('known_val_gt.json', 'all_val_gt.json'):
            os.replace(d / name, out / f'{d.name}_{name}')
    return out


def test_preprocess_cli_matches_jax(tmp_path):
    """`main(argv)` of both CLIs, every subcommand that needs no video
    decoder (video2npy and flow2npy: tests/test_torch_preprocess.py):
    equal files out."""
    anno = write_thumos_anno_tree(tmp_path / 'src')
    anet = write_anet_anno_tree(tmp_path / 'src')
    outs = {tag: run_cli(mod, tmp_path / tag, anno, anet)
            for tag, mod in (('port', preprocess),
                             ('jax', jax_preprocess))}
    assert_same_trees(outs['jax'], outs['port'])
    info = json.loads((outs['port'] / 'anet_info.json').read_text())
    assert sorted(info) == ['v_00001', 'v_00002']
    assert info['v_00001']['frame_num'] == 37
    assert info['v_00001']['fps'] == 37 / 12.5
