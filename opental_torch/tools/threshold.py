"""OOD threshold calibration CLI: python -m opental_torch.tools.threshold
<cfg.yaml> [flags] [--device cuda|cpu].

Counterpart of `opental_tpu/tools/threshold.py` (reference
AFSD/thumos14/threshold.py:157-170): run the inference stack of
`tools.test` over the TRAINING videos (fused with `--fusion`), compose a
confidence score per proposal, pick the 95%-TPR percentile as the
rejection threshold and store it in the detection JSON's external_data.
The ANet calibration (`model.arch: anet`, `--binary`, `--cls_score_file`)
raises until the ANet slice. Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import os

from opental_torch.config import build_arg_parser, config_from_namespace
from opental_torch.openset.threshold import (calibrate, calibrate_anet,
                                             output_file, read_threshold)
from opental_torch.tools.test import build_pipeline


def main(argv=None) -> None:
    parser = build_arg_parser()
    parser.add_argument('--device', type=str, default='cuda',
                        help='cuda (default) or cpu')
    parser.add_argument('--binary', action='store_true')
    parser.add_argument('--cls_score_file', type=str, default=None)
    args = parser.parse_args(argv)
    cfg = config_from_namespace(args)
    path = output_file(cfg)
    if cfg.get_path('model.arch') == 'anet' or args.binary \
            or args.cls_score_file:
        threshold = calibrate_anet(cfg, binary=args.binary,
                                   cls_score_file=args.cls_score_file)
    elif os.path.exists(path):
        threshold = read_threshold(path)
        print(f'Thresholding result file already exist at {path}!')
    else:
        pipe, _, _ = build_pipeline(cfg, device=args.device)
        threshold = calibrate(cfg, pipe)
    print(f'The threshold is: {threshold:.12f}')


if __name__ == '__main__':
    main()
