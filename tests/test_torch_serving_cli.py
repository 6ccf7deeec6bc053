"""The port's serving CLI (``python -m dis_tpu_torch.serving``) on the CPU:
``export`` then ``run`` with ``--device cpu`` prints the flow's shape,
as ``dis_tpu``'s does (tests/test_serving.py), and without a card the
default device is refused."""

import torch

from dis_tpu_torch import serving


def test_serving_cli_export_and_run(tmp_path, capsys):
    path = str(tmp_path / "a.pt2")
    assert serving.main(["export", "--size", "40x48", "--preset", "ultrafast",
                         "--mode", "compat", "--device", "cpu", "--out", path]) == 0
    assert serving.main(["run", path, "--reps", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "in (40, 48) -> flow (40, 48, 2);" in out and "ms/call" in out
    if not torch.cuda.is_available():
        assert serving.main(["run", path, "--reps", "1"]) != 0
        assert serving.main(["export", "--size", "40x48", "--out", path]) != 0
        assert "pass --device cpu" in capsys.readouterr().err
