"""OOD threshold calibration CLI: python -m opental_torch.tools.threshold
<cfg.yaml> [flags] [--device cuda|cpu].

Counterpart of `opental_tpu/tools/threshold.py` (reference
AFSD/thumos14/threshold.py:157-170, AFSD/anet/threshold.py:66-79): run
the inference stack over the TRAINING videos, compose a confidence score
per proposal, pick the 95%-TPR percentile as the rejection threshold and
store it in the detection JSON's external_data. An existing output file
is read back first; otherwise `model.arch: anet` takes the ANet CLI
(`tools.test_anet`, with `--binary` / `--cls_score_file`) and any other
arch the THUMOS one (`tools.test`, fused with `--fusion`), as the JAX
CLI routes. Runs on the card unless `--device cpu`.
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
    if os.path.exists(path):
        threshold = read_threshold(path)
        print(f'Thresholding result file already exist at {path}!')
    elif cfg.get_path('model.arch') == 'anet':
        threshold = calibrate_anet(cfg, binary=args.binary,
                                   cls_score_file=args.cls_score_file,
                                   device=args.device)
    else:
        pipe, _, _ = build_pipeline(cfg, device=args.device)
        threshold = calibrate(cfg, pipe)
    print(f'The threshold is: {threshold:.12f}')


if __name__ == '__main__':
    main()
