"""BENCHMARK.json against the benchmark's contract, and a cell, a
configuration, a mix and a per-layer metric added by new files and
entries alone."""

import json
import re

from benchmark import cells, run
from benchmark.tests.conftest import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    assert b["command"] == ["python3", "-m", "benchmark.run"]
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (REPO / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert cells.metric_path(m["name"]).is_file()
    used = set()
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200 and w["config"] in configs
        used.add(w["config"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        cell = cells.load_cell(REPO, w["name"])
        assert cell.limits and "limits" not in cell.traffic
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert used == set(configs)


def test_a_new_cell_config_mix_and_metric_need_no_edit(tiny):
    root, bench = tiny
    committed = {p: p.read_bytes() for p in BENCH.rglob("*.py")}
    config = json.loads((bench / "configs" / "clip_vitb32_hub.json")
                        .read_text())
    config["tower"]["width"] = 128
    (bench / "configs" / "clip_wider.json").write_text(json.dumps(config))
    mix = json.loads((bench / "traffic" / "stl10_96.json").read_text())
    mix.update(images=50, raw_hw=[64, 80], batch=16, check_images=20)
    (bench / "traffic" / "small_64x80.json").write_text(json.dumps(mix))
    (bench / "metrics" / "images_per_pass.py").write_text(
        "def read(rec):\n    return float(sum(rec.info['slice_batches']))\n")
    (bench / "limits" / "wider.small.json").write_text(json.dumps(
        {"flip_share": 0.07, "worst_image_flip_share": 0.15}))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "clip_wider", "source": "x",
                         "file": "benchmark/configs/clip_wider.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "wider.small", "config": "clip_wider",
                           "traffic": "small_64x80", "chips": 1,
                           "why": "x"})
    for m in b["end_to_end"]:
        if m["name"] == "encode_img_per_s":
            m["workloads"].append("wider.small")
    b["per_layer"].append({"name": "images_per_pass", "unit": "img",
                           "better": "higher", "source": "program_counter",
                           "layer": "x", "moves": "encode_img_per_s",
                           "workloads": ["wider.small"]})
    # a new name of a quantity whose reader exists: no new reader
    b["per_layer"].append({"name": "images_per_pass.wider", "unit": "img",
                           "better": "higher", "source": "program_counter",
                           "layer": "x", "moves": "encode_img_per_s",
                           "workloads": ["wider.small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    result = run.run_cell(root, "wider.small", 7, 0.0, True, "cpu",
                          bench_dir=bench)
    assert result["correct"] is True
    assert result["metrics"]["images_per_pass"]["value"] == 50.0
    assert result["metrics"]["images_per_pass.wider"]["value"] == 50.0
    assert result["checks"]["flip_share"]["limit"] == 0.07
    assert "encode_mfu" not in result["metrics"]
    assert {p: p.read_bytes() for p in BENCH.rglob("*.py")} == committed


def test_a_roofline_whose_kernels_ran_unnamed_is_an_error():
    """The launch counters saw the kernel run, the trace names none of
    the reader's kernels: the reader raises, it does not fall silent."""
    import pytest

    from benchmark import trace

    cell = cells.load_cell(REPO, "bince.train")
    s = trace.Slice(0.0, 1000.0, [trace.Event("renamed_kernel", 0.0, 10.0,
                                              corr=1)], [])
    reader = cells.metric_reader("k3_roofline")
    rec = cells.Record(cell, {}, s, {"batch": 256, "slice_launches":
                                     {"eb_likelihood": 4}})
    with pytest.raises(RuntimeError):
        reader(rec)
    rec.info["slice_launches"] = {"eb_likelihood": 0}
    assert reader(rec) is None
    enc = cells.load_cell(REPO, "vitb32.encode_stl10")
    rec = cells.Record(enc, {}, s, {"slice_batches": [512], "slice_launches":
                                    {"fused_attention": 11}})
    with pytest.raises(RuntimeError):
        cells.metric_reader("attn_roofline")(rec)
