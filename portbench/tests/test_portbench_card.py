"""On the card: each cell runs at its full size for a short window and
comes out correct (skips without a CUDA device)."""
import json

import pytest

from portbench import run


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mtv_direct.level5",
                                      "mtv_rgb_sh.level5"])
def test_cell_is_correct_on_the_card(cuda_device, capsys, workload):
    rc = run.main(["--workload", workload, "--seed", "2147483999",
                   "--seconds", "1", "--trace", "0"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    assert line["device"]["platform"] == "gpu"
