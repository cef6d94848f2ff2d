"""A configuration, a traffic mix, a per-layer metric and a stage's work
count added as files only are found by name."""
import json
import os
import shutil

from portbench import counts, metrics, run


def test_dummy_files_are_found(tiny, capsys):
    bench_path, root = tiny
    with open(bench_path) as f:
        bench = json.load(f)
    # a configuration: a copy of mtv_direct's file under another name
    shutil.copy(os.path.join(root, "configs", "mtv_direct.json"),
                os.path.join(root, "configs", "mtv_dummy.json"))
    bench["configs"].append(dict(bench["configs"][0], name="mtv_dummy",
                                 file="portbench/configs/mtv_dummy.json"))
    # a traffic mix: level 5 with another loss read interval
    with open(os.path.join(root, "traffic", "level5.json")) as f:
        traffic = json.load(f)
    traffic.update(name="dummy", loss_read_every=4)
    with open(os.path.join(root, "traffic", "dummy.json"), "w") as f:
        json.dump(traffic, f)
    bench["workloads"].append({"name": "mtv_dummy.dummy",
                               "config": "mtv_dummy", "traffic": "dummy",
                               "chips": 1, "why": "test"})
    # limits of the new cell, a metric reader and a stage count
    shutil.copy(os.path.join(root, "limits", "mtv_direct.level5.json"),
                os.path.join(root, "limits", "mtv_dummy.dummy.json"))
    with open(os.path.join(root, "metrics", "dummy_ms.py"), "w") as f:
        f.write("def read(ctx):\n    return 1.5 + len(ctx.steps) * 0\n")
    bench["per_layer"].append({"name": "dummy_ms", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "test", "moves": "step_ms",
                               "workloads": ["mtv_dummy.dummy"]})
    with open(os.path.join(root, "counts", "stage_dummy.py"), "w") as f:
        f.write("def count(s):\n    return {'ops': 1, 'bytes': 2, "
                "'peak': 'f32'}\n")
    with open(bench_path, "w") as f:
        json.dump(bench, f)

    assert "dummy" in counts.stages(os.path.join(root, "counts"))
    assert metrics.reader("dummy_ms", os.path.join(root, "metrics"))(
        type("C", (), {"steps": []})()) == 1.5
    rc = run.main(["--workload", "mtv_dummy.dummy", "--seed", "5",
                   "--seconds", "0.3", "--trace", "1"],
                  device="cpu", bench_path=bench_path, root=root)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["dummy_ms"]["value"] == 1.5
    # a metric of another cell is not read here
    assert "K15_roofline" not in line["metrics"]
