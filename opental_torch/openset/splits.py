"""Open-set known/unknown split generation.

Reference: datasets/openset_split_thumos14.py (seed 123, 5 random splits
of the 20 THUMOS classes into 5 unknown / 15 known; writes per-split
Class_Index_{Known,Unknown}.txt, class-filtered annotation CSVs, and
known/unknown GT JSONs) and datasets/openset_split_anet.py (50 unknown /
150 known of 200). The same unknown-class draws are reproduced exactly
(same seed, same np.random.choice sequence).

Copy of `opental_tpu/openset/splits.py`: numpy and files only.
"""

from __future__ import annotations

import copy
import csv
import json
import os
import shutil
from typing import Dict, List, Sequence, Tuple

import numpy as np


def read_class_index(class_info_path: str
                     ) -> Tuple[Dict[int, int], Dict[int, str]]:
    originidx_to_idx: Dict[int, int] = {}
    idx_to_class: Dict[int, str] = {}
    with open(class_info_path) as f:
        rows = [ln.split() for ln in f.read().splitlines() if ln.strip()]
    for i, (origin, name) in enumerate(rows):
        originidx_to_idx[int(origin)] = i + 1
        idx_to_class[i + 1] = name
    return originidx_to_idx, idx_to_class


def write_class_index(path: str, idx_to_class: Dict[int, str],
                      originidx_to_idx: Dict[int, int]) -> None:
    with open(path, 'w') as f:
        for ori_idx, idx in originidx_to_idx.items():
            f.write(f'{ori_idx} {idx_to_class[idx]}\n')


def filter_annotation_csv(src_csv: str, dst_csv: str,
                          drop_classes: Sequence[str]) -> None:
    """Drop annotation rows whose 'type' column is in drop_classes
    (reference csv_filtering)."""
    drop = set(drop_classes)
    with open(src_csv) as f:
        reader = csv.reader(f)
        rows = list(reader)
    header = rows[0]
    type_col = header.index('type')
    kept = [header] + [
        r for r in rows[1:]
        if any(c.strip() for c in r) and r[type_col] not in drop]
    with open(dst_csv, 'w', newline='') as f:
        csv.writer(f).writerows(kept)


def filter_gt_json(src_json: str, dst_json: str,
                   drop_classes: Sequence[str]) -> None:
    """Drop annotations of the given classes; drop videos left empty
    (reference json_filtering)."""
    drop = set(drop_classes)
    with open(src_json) as f:
        data = json.load(f)
    new_gt = copy.deepcopy(data)
    for videoid, v in data['database'].items():
        anns = [a for a in v['annotations'] if a['label'] not in drop]
        if anns:
            v_new = copy.deepcopy(v)
            v_new['annotations'] = anns
            new_gt['database'][videoid] = v_new
        else:
            new_gt['database'].pop(videoid)
    with open(dst_json, 'w') as f:
        json.dump(new_gt, f)


def generate_thumos_splits(anno_path: str, result_anno_path: str,
                           num_splits: int = 5, num_unknown: int = 5,
                           seed: int = 123) -> List[Dict[int, str]]:
    """Generate the open-set split directory tree. Returns the per-split
    unknown class maps. Seeded identically to the reference so split
    membership matches."""
    np.random.seed(seed)
    os.makedirs(result_anno_path, exist_ok=True)
    class_info_file = os.path.join(anno_path, 'Class_Index_Detection.txt')
    shutil.copyfile(class_info_file,
                    os.path.join(result_anno_path,
                                 'Class_Index_Detection.txt'))
    originidx_to_idx, idx_to_class = read_class_index(class_info_file)

    unknown_maps = []
    for i in range(num_splits):
        split_path = os.path.join(result_anno_path, f'split_{i}')
        os.makedirs(split_path, exist_ok=True)
        # NOTE reference quirk kept: np.random.choice over
        # len(idx_to_class) draws indices 0..K-1 but idx_to_class keys
        # are 1..K, so index 0 never maps to a class and the draw of
        # class ids is over {1..K} ∩ {0..K-1}
        unknown = np.random.choice(len(idx_to_class), size=num_unknown,
                                   replace=False)
        idx_to_unknown = {k: v for k, v in idx_to_class.items()
                          if k in unknown}
        ori_unknown = {k: v for k, v in originidx_to_idx.items()
                       if v in unknown}
        write_class_index(os.path.join(split_path,
                                       'Class_Index_Unknown.txt'),
                          idx_to_unknown, ori_unknown)
        idx_to_known = {k: v for k, v in idx_to_class.items()
                        if k not in unknown}
        ori_known = {k: v for k, v in originidx_to_idx.items()
                     if v not in unknown}
        write_class_index(os.path.join(split_path,
                                       'Class_Index_Known.txt'),
                          idx_to_known, ori_known)
        unknown_names = list(idx_to_unknown.values())
        known_names = list(idx_to_known.values())
        for phase in ('val', 'test'):
            src = os.path.join(anno_path, f'{phase}_Annotation_ours.csv')
            if not os.path.exists(src):
                continue
            filter_annotation_csv(
                src, os.path.join(split_path,
                                  f'{phase}_Annotation_known.csv'),
                unknown_names)
            filter_annotation_csv(
                src, os.path.join(split_path,
                                  f'{phase}_Annotation_unknown.csv'),
                known_names)
        gt = os.path.join(anno_path, 'thumos_gt.json')
        if os.path.exists(gt):
            filter_gt_json(gt, os.path.join(split_path, 'known_gt.json'),
                           unknown_names)
            filter_gt_json(gt, os.path.join(split_path, 'unknown_gt.json'),
                           known_names)
        unknown_maps.append(idx_to_unknown)

    for name in ('val_video_info.csv', 'test_video_info.csv'):
        src = os.path.join(anno_path, name)
        if os.path.exists(src):
            shutil.copyfile(src, os.path.join(result_anno_path, name))
    src = os.path.join(anno_path, 'test_Annotation_ours.csv')
    if os.path.exists(src):
        shutil.copyfile(src, os.path.join(result_anno_path,
                                          'test_Annotation_open.csv'))
    return unknown_maps


def generate_anet_splits(anno_path: str, result_anno_path: str,
                         num_splits: int = 5, unknown_ratio: float = 0.25,
                         seed: int = 123) -> None:
    """ActivityNet open splits: 50 unknown / 150 known of 200 classes
    (datasets/openset_split_anet.py:90-134). For each split, the big
    video_info JSON is filtered (training keeps known-only videos) and
    label ids are re-coded 1..K+U with known classes first."""
    import json as _json
    np.random.seed(seed)
    os.makedirs(result_anno_path, exist_ok=True)
    class_info_file = os.path.join(anno_path, 'action_name.txt')
    shutil.copyfile(class_info_file,
                    os.path.join(result_anno_path, 'action_name.txt'))
    with open(class_info_file) as f:
        class_names_all = [ln.strip() for ln in f.read().splitlines()
                           if ln.strip()]
    with open(os.path.join(anno_path, 'video_info_train_val.json')) as f:
        video_info_all = _json.load(f)

    for i in range(num_splits):
        split_path = os.path.join(result_anno_path, f'split_{i}')
        os.makedirs(split_path, exist_ok=True)
        n = len(class_names_all)
        unknown_idx = np.random.choice(n, size=int(n * unknown_ratio),
                                       replace=False)
        classes_unknown = [class_names_all[j] for j in unknown_idx]
        # NOTE reference quirk kept: known classes come from a set
        # difference, so their order is python-set order
        classes_known = list(set(class_names_all) - set(classes_unknown))
        class_to_id = {name: j + 1 for j, name in
                       enumerate(classes_known + classes_unknown)}
        with open(os.path.join(split_path, 'action_all.txt'), 'w') as f:
            f.write(''.join(name + '\n'
                            for name in classes_known + classes_unknown))
        with open(os.path.join(split_path, 'action_known.txt'), 'w') as f:
            f.write(''.join(name + '\n' for name in classes_known))

        filtered = {}
        for video_name, info in video_info_all.items():
            this = copy.deepcopy(info)
            if this['subset'] == 'training':
                annos = [dict(a, label_id=class_to_id[a['label']])
                         for a in this['annotations']
                         if a['label'] in class_to_id
                         and a['label'] in classes_known]
                if not annos:
                    continue
                this['annotations'] = annos
            else:
                this['annotations'] = [
                    dict(a, label_id=class_to_id.get(a['label'], 0))
                    for a in this['annotations']]
            filtered[video_name] = this
        with open(os.path.join(split_path,
                               'video_info_trainval_openset.json'),
                  'w') as f:
            _json.dump(filtered, f)


def load_class_names(class_info_path: str) -> List[str]:
    """One class name per line (datasets/anet_test_gt.py:5-10,
    AFSD/anet_data/class_map.py:4)."""
    with open(class_info_path) as f:
        return [ln.strip() for ln in f.read().splitlines() if ln.strip()]


def class_maps(class_info_path: str
               ) -> Tuple[Dict[str, int], Dict[int, str]]:
    """1-indexed name<->id maps (AFSD/anet_data/class_map.py:6-10)."""
    names = load_class_names(class_info_path)
    class_to_id = {name: i + 1 for i, name in enumerate(names)}
    id_to_class = {i + 1: name for i, name in enumerate(names)}
    return class_to_id, id_to_class


def filtered_database(video_info: Dict[str, dict],
                      keep_classes: Sequence[str],
                      subset: str = 'validation') -> Dict[str, dict]:
    """Keep only `subset` videos whose annotations fall in keep_classes;
    drop videos left empty (datasets/anet_test_gt.py:20-36)."""
    keep = set(keep_classes)
    database = {}
    for videoid, v in video_info['database'].items():
        if v['subset'] != subset:
            continue
        annos = [a for a in v['annotations'] if a['label'] in keep]
        if annos:
            this = copy.deepcopy(v)
            this['annotations'] = annos
            database[videoid] = this
    return {'database': database}


def write_anet_val_gt(video_info_path: str, splits_dir: str,
                      num_splits: int = 5,
                      subset: str = 'validation') -> None:
    """Per-split ANet validation ground truth: known_val_gt.json filtered
    to split_i/action_known.txt classes and all_val_gt.json to
    action_all.txt (datasets/anet_test_gt.py:40-63)."""
    with open(video_info_path) as f:
        video_info = json.load(f)
    for i in range(num_splits):
        split_path = os.path.join(splits_dir, f'split_{i}')
        for cls_file, out_name in (('action_known.txt', 'known_val_gt.json'),
                                   ('action_all.txt', 'all_val_gt.json')):
            keep = load_class_names(os.path.join(split_path, cls_file))
            gt = filtered_database(video_info, keep, subset=subset)
            with open(os.path.join(split_path, out_name), 'w') as f:
                json.dump(gt, f)


def write_video_list(video_dir: str, out_txt: str,
                     pattern: str = '*.mp4') -> List[str]:
    """Sorted video-path list file (AFSD/anet_data/gen_video_list.py:1-6).
    Returns the list written."""
    import glob as _glob
    paths = sorted(_glob.glob(os.path.join(video_dir, pattern)))
    os.makedirs(os.path.dirname(os.path.abspath(out_txt)), exist_ok=True)
    with open(out_txt, 'w') as f:
        f.write(''.join(p + '\n' for p in paths))
    return paths


def merge_thumos_anet_gt(thumos_gt_path: str, anet_gt_path: str,
                         overlapping_class_file: str,
                         merged_gt_file: str,
                         anet_subset: str = 'validation') -> int:
    """Merged cross-dataset GT: THUMOS test videos + ANet validation
    videos with THUMOS-overlapping classes excluded
    (datasets/merge_thumos_anet_gt.py:49-76). Returns video count."""
    import json as _json
    with open(thumos_gt_path) as f:
        merged = _json.load(f)
    merged['database'] = {k: v for k, v in merged['database'].items()
                          if v['subset'] == 'test'}
    with open(overlapping_class_file) as f:
        excluded = {ln.strip() for ln in f.read().splitlines()
                    if ln.strip()}
    with open(anet_gt_path) as f:
        anet = _json.load(f)['database']
    for vid, v in anet.items():
        if v['subset'] != anet_subset:
            continue
        if any(a['label'] in excluded for a in v['annotations']):
            continue
        merged['database'][vid] = v
    with open(merged_gt_file, 'w') as f:
        _json.dump(merged, f)
    return len(merged['database'])
