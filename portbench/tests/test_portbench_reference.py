"""The plain reference against the port at a tiny size on the CPU; the
control (the reference with float8 texel reads in the program's place)
and the planted faults come out not correct."""
import json

import pytest
import torch

from portbench import calibrate, correct, run
from portbench.reference import stage2 as ref

CELLS = ("mtv_direct.level5", "mtv_rgb_sh.level5")


def result(tiny, capsys, workload, seed=7):
    bench, root = tiny
    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", "0.2", "--trace", "0"],
                  device="cpu", bench_path=bench, root=root)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_port(tiny, capsys, workload):
    line = result(tiny, capsys, workload)
    assert line["correct"] is True
    for k, c in line["checks"].items():
        assert c["value"] <= 1e-5, (k, c)
    assert line["reference"]["slots"] < 16      # compaction is exercised


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tiny, workload):
    bench, root = tiny
    rows = calibrate.readings(workload, [11], 1, 0, "cpu",
                              open("/dev/null", "w"), root=root,
                              bench_path=bench)
    control = next(r for r in rows if r["kind"].startswith("control"))
    ok, _ = correct.judge(control, correct.load_limits(root, workload))
    assert not ok


@pytest.mark.parametrize("fault", ["half_batch", "frozen"])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_step_is_not_correct(tiny, capsys, workload, fault):
    ctx = {"half_batch": calibrate.half_patch_loss,
           "frozen": calibrate.frozen_state}[fault]
    with ctx():
        line = result(tiny, capsys, workload)
    assert line["correct"] is False


def test_adam_matches_torch():
    torch.manual_seed(0)
    p = {"a": torch.randn(50), "b": torch.randn(3, 7)}
    q = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    opt_t = torch.optim.Adam(list(q.values()), lr=0.01, eps=6e-8)
    opt_r = ref.Adam(p)
    for _ in range(3):
        g = {k: torch.randn_like(v) for k, v in p.items()}
        for k, v in q.items():
            v.grad = g[k].clone()
        opt_t.step()
        opt_r.step(p, g, 0.01)
    for k in p:
        assert torch.allclose(p[k], q[k].detach(), rtol=1e-6, atol=1e-7)


def test_numbers_take_the_worst_leaf():
    prog = {"losses": [1.0, 2.0], "grad_norms": {"a": 1.0, "b": 2.2},
            "change_norms": {"a": 3.0, "b": 0.0}}
    refr = {"losses": [1.0, 2.2], "grad_norms": {"a": 1.0, "b": 2.0},
            "change_norms": {"a": 3.0, "b": 5.0}}
    v = correct.numbers(prog, refr)
    assert v["loss_gap"] == pytest.approx(0.2 / 2.2)
    assert v["grad_gap"] == pytest.approx(0.2 / 2.0)
    assert v["change_gap"] == pytest.approx(1.0)
    # a leaf with no reference gradient is left out of the change
    refr["grad_norms"]["b"] = 1e-9
    assert correct.numbers(prog, refr)["change_gap"] == 0.0
