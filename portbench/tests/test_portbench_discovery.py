"""A configuration, a traffic mix and a metric added as new files (and new
entries in BENCHMARK.json) are found by name, with no file that is there
edited; BENCHMARK.json itself keeps the contract's shape."""

import json
import re
import shutil

from portbench import spec

ROOT = spec.ROOT


def test_benchmark_json_shape():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"] and bench["paths"] == ["portbench"]
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    metrics = bench["end_to_end"] + bench["per_layer"]
    cells = {c["name"] for c in bench["workloads"]}
    for m in metrics:
        assert name.match(m["name"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists(), m["name"]
        assert set(m.get("workloads", [])) <= cells
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists() and json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for cell in bench["workloads"]:
        assert name.match(cell["name"]) and cell["chips"] == 1 and len(cell["why"]) <= 200
        assert (ROOT / "portbench" / "traffic" / f"{cell['traffic']}.json").exists()
        e2e = spec.metrics(bench, cell["name"], traced=False)
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert spec.metrics(bench, cell["name"], traced=True)
    assert len(json.dumps(bench)) < 64 * 1024


def test_new_files_are_found_by_name(tmp_path):
    here = tmp_path / "portbench"
    for part in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "portbench" / part, here / part)
    bench = spec.benchmark()
    (here / "configs" / "att-4of7-2k.json").write_text(json.dumps({"name": "att-4of7-2k", "validators": 2048}))
    (here / "traffic" / "trickle.json").write_text(json.dumps({"name": "trickle", "spread_s": 4.0}))
    (here / "metrics" / "queue.depth.py").write_text("def read(record):\n    return record['window']['slots'] * 2\n")
    (here / "metrics" / "silent.py").write_text("def read(record):\n    return None\n")
    bench["configs"].append({"name": "att-4of7-2k", "file": "portbench/configs/att-4of7-2k.json"})
    bench["workloads"].append({"name": "att2k.trickle", "config": "att-4of7-2k", "traffic": "trickle", "chips": 1})
    bench["per_layer"] += [
        {"name": "queue.depth", "unit": "jobs", "moves": "slot_s", "workloads": ["att2k.trickle"]},
        {"name": "silent", "unit": "s", "moves": "slot_s"},
    ]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    bench = spec.benchmark(tmp_path)
    cell = spec.workload(bench, "att2k.trickle")
    assert spec.config(bench, cell["config"], tmp_path)["validators"] == 2048
    assert spec.traffic(cell["traffic"], here)["spread_s"] == 4.0
    record = {"window": {"slots": 3, "seconds": 60.0, "flushes": 3, "pack_s": 1.5, "programs_s": 50.0,
                         "launches": 30_000}, "trace": None, "setup_s": 100.0, "boot_s": 60.0}
    got = spec.read_metrics(bench, "att2k.trickle", True, record, here)
    assert got["queue.depth"] == {"value": 6, "unit": "jobs"}
    assert "silent" not in got and "kernels.launches_per_slot" not in got  # the latter lists only its own cells
    assert "queue.depth" not in spec.read_metrics(bench, "att1k.burst", True, record, here)
    # end-to-end: setup_s and verify_device_s list no cells, so a new cell reports them; slot_s lists its own
    record = {**record, "trace": {"busy_s": 1.2, "window_s": 10.0}}
    assert set(spec.read_metrics(bench, "att2k.trickle", False, record, here)) == {"setup_s", "verify_device_s"}
