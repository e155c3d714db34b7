"""`train.loop.init_state` on the CPU with `model.backbone_model`: the I3D
backbone file overlaid on the seeded init. Apart from
`test_torch_train_loop.py` (training end to end) so that the two run on
separate workers under `--dist loadfile`."""

import pytest
import torch

from opental_torch.config import load_config
from opental_torch.train.loop import init_state
from opental_torch.utils.synthetic import make_synthetic_dataset

from torch_suite import suite_policy  # noqa: F401 (autouse)


def test_init_state_overlays_the_backbone_file(tmp_path):
    """A backbone file (reference `rgb_imagenet.pt` layout: the I3D keys
    plus its logits layer) is loaded onto the backbone; a file that lacks
    a backbone key raises."""
    cfg_path = make_synthetic_dataset(str(tmp_path / 'synth'), n_train=1,
                                      n_test=1, clip_length=128,
                                      crop_size=32, spatial=40)
    plain = init_state(load_config(cfg_path), torch.device('cpu'), seed=0,
                       frame_num=128, crop_size=32)
    sd = {k: v + 0.5 if v.is_floating_point() else v
          for k, v in plain.model.backbone._model.state_dict().items()}
    sd['logits.conv3d.weight'] = torch.zeros(400, 1024, 1, 1, 1)
    path = str(tmp_path / 'rgb_imagenet.pt')
    torch.save(sd, path)
    cfg = load_config(cfg_path, overrides={'model.backbone_model': path})
    state = init_state(cfg, torch.device('cpu'), seed=0, frame_num=128,
                       crop_size=32)
    got = state.model.backbone._model.state_dict()
    assert set(got) == set(sd) - {'logits.conv3d.weight'}
    for k, v in got.items():
        assert torch.equal(v, sd[k]), k
    # the head keeps the seeded init
    for k, v in state.model.coarse_pyramid_detection.state_dict().items():
        assert torch.equal(
            v, plain.model.coarse_pyramid_detection.state_dict()[k]), k
    del sd['Conv3d_1a_7x7.conv3d.weight']
    torch.save(sd, path)
    with pytest.raises(KeyError, match='lacks backbone keys'):
        init_state(cfg, torch.device('cpu'), seed=0, frame_num=128,
                   crop_size=32)
