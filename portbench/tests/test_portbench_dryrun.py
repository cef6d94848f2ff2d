"""A tiny dry run of each cell on the CPU (the program's plain versions),
traced and untraced, parsing the result line."""
import json

import pytest

from portbench import run

CELLS = ("mtv_direct.level5", "mtv_rgb_sh.level5")


def last_json(text):
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_dry_run_prints_the_result_line(tiny, capsys, workload, trace):
    bench, root = tiny
    rc = run.main(["--workload", workload, "--seed", "2147483653",
                   "--seconds", "0.5", "--trace", str(trace)],
                  device="cpu", bench_path=bench, root=root)
    out = capsys.readouterr()
    assert rc == 0
    line = last_json(out.out)
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["attempted"] >= 2 and line["failed"] == 0
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    with open(bench) as f:
        spec = json.load(f)
    names = {m["name"] for m in run.cell_metrics(spec, workload, trace)}
    assert set(line["metrics"]) <= names
    cfg = workload.split(".")[0]
    if not trace:
        assert set(line["metrics"]) == {"setup_s", f"step_ms.{cfg}",
                                        "peak_mem_gib"}
    else:
        # no device trace on the CPU: the device readers find nothing
        assert f"step_enqueue_ms.{cfg}" in line["metrics"]
        assert f"step_mfu.{cfg}" not in line["metrics"]
    # the compared numbers end the standard error, each with its limit
    tail = out.err.strip().splitlines()[-3:]
    assert [t.split()[1] for t in tail] == ["loss_gap", "grad_gap",
                                           "change_gap"]
    assert all("limit" in t for t in tail)


def test_no_cuda_device_exits_without_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == ""


def test_unknown_workload_is_refused(tiny):
    bench, root = tiny
    with pytest.raises(SystemExit):
        run.main(["--workload", "no.such", "--seed", "1", "--seconds", "1"],
                 device="cpu", bench_path=bench, root=root)
