"""Offline preprocessing CLI.

Command surface for the reference's standalone data scripts:
AFSD/common/video2npy.py, AFSD/anet_data/video2npy.py (sharded mp4 ->
npy, driven by datasets/get_anet_npy.sh), AFSD/common/gen_denseflow_npy.py
(TVL1 flow), AFSD/anet_data/gen_video_info.py, AFSD/anet_data/
gen_video_list.py, AFSD/common/gen_annotations.py (drop Ambiguous rows),
and datasets/anet_test_gt.py (per-split validation GT jsons).

    python -m opental_torch.tools.preprocess video2npy --video_dir D \
        --output_dir O [--workers 8 --resolution 112 --max_frames 768]
    python -m opental_torch.tools.preprocess flow2npy --rgb_npy A.npy \
        --out_npy F.npy
    python -m opental_torch.tools.preprocess anet_info --npy_dir D \
        --anno_json a.json --out_json info.json
    python -m opental_torch.tools.preprocess video_list --video_dir D \
        --out_txt list.txt
    python -m opental_torch.tools.preprocess filter_annotations \
        --src in.csv --dst out.csv [--drop Ambiguous]
    python -m opental_torch.tools.preprocess anet_val_gt \
        --video_info gt.json --splits_dir annotations_open
    python -m opental_torch.tools.preprocess thumos_splits \
        --anno_path datasets/thumos14/annotations \
        --out_path datasets/thumos14/annotations_open
    python -m opental_torch.tools.preprocess anet_splits \
        --anno_path datasets/activitynet/annotations \
        --out_path datasets/activitynet/annotations_open
    python -m opental_torch.tools.preprocess merge_gt \
        --thumos_gt t.json --anet_gt a.json --overlap cls.txt --out m.json

The split generators cover datasets/openset_split_thumos14.py and
datasets/openset_split_anet.py (seed 123; the reference's RNG sequence
is reproduced so split membership is identical), merge_gt covers
datasets/merge_thumos_anet_gt.py.

Copy of `opental_tpu/tools/preprocess.py` on the port's copies of
`data/preprocess.py` and `openset/splits.py`.
"""

from __future__ import annotations

import argparse
import os

from opental_torch.data import preprocess as pp
from opental_torch.openset import splits as sp


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest='cmd', required=True)

    v = sub.add_parser('video2npy')
    v.add_argument('--video_dir', required=True)
    v.add_argument('--output_dir', required=True)
    v.add_argument('--workers', type=int, default=1)
    v.add_argument('--sample_fps', type=float, default=10.0)
    v.add_argument('--resolution', type=int, default=112)
    v.add_argument('--max_frames', type=int, default=None)
    v.add_argument('--video_info_csv', default=None)

    f = sub.add_parser('flow2npy')
    f.add_argument('--rgb_npy', required=True)
    f.add_argument('--out_npy', required=True)
    f.add_argument('--bound', type=float, default=20.0)

    a = sub.add_parser('anet_info')
    a.add_argument('--npy_dir', required=True)
    a.add_argument('--anno_json', required=True)
    a.add_argument('--out_json', required=True)
    a.add_argument('--clip_length', type=int, default=768)

    l = sub.add_parser('video_list')
    l.add_argument('--video_dir', required=True)
    l.add_argument('--out_txt', required=True)
    l.add_argument('--pattern', default='*.mp4')

    c = sub.add_parser('filter_annotations')
    c.add_argument('--src', required=True)
    c.add_argument('--dst', required=True)
    c.add_argument('--drop', nargs='+', default=['Ambiguous'])

    g = sub.add_parser('anet_val_gt')
    g.add_argument('--video_info', required=True)
    g.add_argument('--splits_dir', required=True)
    g.add_argument('--num_splits', type=int, default=5)
    g.add_argument('--subset', default='validation')

    ts = sub.add_parser('thumos_splits')
    ts.add_argument('--anno_path', required=True)
    ts.add_argument('--out_path', required=True)
    ts.add_argument('--num_splits', type=int, default=5)
    ts.add_argument('--num_unknown', type=int, default=5)
    ts.add_argument('--seed', type=int, default=123)

    asp = sub.add_parser('anet_splits')
    asp.add_argument('--anno_path', required=True)
    asp.add_argument('--out_path', required=True)
    asp.add_argument('--num_splits', type=int, default=5)
    asp.add_argument('--unknown_ratio', type=float, default=0.25)
    asp.add_argument('--seed', type=int, default=123)

    m = sub.add_parser('merge_gt')
    m.add_argument('--thumos_gt', required=True)
    m.add_argument('--anet_gt', required=True)
    m.add_argument('--overlap', required=True,
                   help='txt file of THUMOS-overlapping ANet class names')
    m.add_argument('--out', required=True)
    m.add_argument('--anet_subset', default='validation')

    args = p.parse_args(argv)
    if args.cmd == 'video2npy':
        names = sorted(os.path.splitext(n)[0]
                       for n in os.listdir(args.video_dir)
                       if n.endswith('.mp4'))
        pp.videos_to_npy(args.video_dir, args.output_dir, names,
                         sample_fps=args.sample_fps,
                         resolution=args.resolution,
                         video_info_csv=args.video_info_csv,
                         max_frames=args.max_frames,
                         workers=args.workers)
    elif args.cmd == 'flow2npy':
        pp.flow_to_npy(args.rgb_npy, args.out_npy, bound=args.bound)
    elif args.cmd == 'anet_info':
        pp.anet_video_info(args.npy_dir, args.anno_json, args.out_json,
                           clip_length=args.clip_length)
    elif args.cmd == 'video_list':
        sp.write_video_list(args.video_dir, args.out_txt,
                            pattern=args.pattern)
    elif args.cmd == 'filter_annotations':
        sp.filter_annotation_csv(args.src, args.dst, args.drop)
    elif args.cmd == 'anet_val_gt':
        sp.write_anet_val_gt(args.video_info, args.splits_dir,
                             num_splits=args.num_splits,
                             subset=args.subset)
    elif args.cmd == 'thumos_splits':
        sp.generate_thumos_splits(args.anno_path, args.out_path,
                                  num_splits=args.num_splits,
                                  num_unknown=args.num_unknown,
                                  seed=args.seed)
    elif args.cmd == 'anet_splits':
        sp.generate_anet_splits(args.anno_path, args.out_path,
                                num_splits=args.num_splits,
                                unknown_ratio=args.unknown_ratio,
                                seed=args.seed)
    elif args.cmd == 'merge_gt':
        n = sp.merge_thumos_anet_gt(args.thumos_gt, args.anet_gt,
                                    args.overlap, args.out,
                                    anet_subset=args.anet_subset)
        print(f'merged GT: {n} videos -> {args.out}')


if __name__ == '__main__':
    main()
