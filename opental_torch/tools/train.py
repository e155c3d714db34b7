"""Training CLI: python -m opental_torch.tools.train <cfg.yaml> [flags]
[--device cuda|cpu] [--max_steps_per_epoch N].

Counterpart of `opental_tpu/tools/train.py` (reference
`python AFSD/thumos14/train.py <cfg>`, AFSD/thumos14/train.py:306-363).
Trains on the card unless `--device cpu` is asked for. `--use_mesh`
trains data-parallel, one process per card, over the global batch of
`--batch_size` rows:

    torchrun --nproc_per_node N -m opental_torch.tools.train <cfg> \
        --use_mesh
"""

from __future__ import annotations

from opental_torch.config import build_arg_parser, config_from_namespace
from opental_torch.train.loop import train


def main(argv=None) -> None:
    parser = build_arg_parser()
    parser.add_argument('--device', type=str, default='cuda',
                        help='cuda (default) or cpu')
    # smoke-run bound (no reference analog; default: full epochs)
    parser.add_argument('--max_steps_per_epoch', type=int, default=None)
    args = parser.parse_args(argv)
    cfg = config_from_namespace(args)
    tr = cfg.training
    for label, key in (('batch size', 'batch_size'),
                       ('learning rate', 'learning_rate'),
                       ('weight decay', 'weight_decay'),
                       ('max epoch', 'max_epoch'),
                       ('checkpoint path', 'checkpoint_path'),
                       ('loc weight', 'lw'), ('cls weight', 'cw'),
                       ('ctr weight', 'ctw'), ('ssl weight', 'ssl'),
                       ('piou', 'piou'), ('resume', 'resume')):
        print(f'{label}: ', tr.get(key))
    print('use_mesh: ', tr.get('use_mesh', False))
    train(cfg, max_steps_per_epoch=args.max_steps_per_epoch,
          device=args.device)


if __name__ == '__main__':
    main()
