"""The port's threshold CLI on an ActivityNet config reads an existing
thresholding file before it routes to `calibrate_anet`, as the JAX CLI
does. Apart from `test_torch_anet_inference.py` (inference and
calibration against JAX) so that the two run on separate workers under
`--dist loadfile`."""

import json

import yaml

from opental_torch.tools import threshold as threshold_cli

from torch_suite import suite_policy  # noqa: F401 (autouse)


def test_threshold_cli_reads_an_existing_file_first(tmp_path, monkeypatch,
                                                   capsys):
    """An ANet config routes to calibrate_anet, but an existing
    thresholding file is read before any routing, as the JAX CLI does
    (a THUMOS config with the ANet flags:
    `tests/test_torch_threshold.py::test_anet_calibration_is_refused`)."""
    calls = []
    monkeypatch.setattr(threshold_cli, 'calibrate_anet',
                        lambda *a, **k: calls.append('anet') or 0.25)
    out = tmp_path / 'out'
    path = tmp_path / 'anet.yaml'
    path.write_text(yaml.safe_dump({'model': {'arch': 'anet'},
                                    'testing': {'output_path': str(out)}}))
    threshold_cli.main([str(path), '--binary', '--device', 'cpu',
                        '--output_json', 'new.json'])
    assert calls == ['anet']
    out.mkdir()
    (out / 'existing.json').write_text(json.dumps(
        {'external_data': {'threshold': 0.125}}))
    threshold_cli.main([str(path), '--device', 'cpu', '--output_json',
                        'existing.json'])
    assert calls == ['anet']
    assert 'The threshold is: 0.125' in capsys.readouterr().out
