"""BENCHMARK.json keeps the benchmark contract's form: keys, names, units,
one-line texts, and a file for every name it gives."""

import json
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    b = manifest()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32 and all(map(line, b["command"]))
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_keep_their_keys_and_names(section, keys):
    entries = manifest()[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for k in ("why", "source", "layer"):
            if k in e:
                assert line(e[k]), (e["name"], k)


def test_configs_are_files_under_paths_with_no_reduced_width():
    b = manifest()
    used = {w["config"] for w in b["workloads"]}
    files = [c["file"] for c in b["configs"]]
    assert len(set(files)) == len(files)
    for c in b["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
        with open(os.path.join(ROOT, c["file"])) as f:
            data = json.load(f)
        assert data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(map(NAME.match, c["reduced"]))


def test_cells_name_their_files_and_chips():
    b = manifest()
    configs = {c["name"] for c in b["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in b["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        for part in ("traffic", "limits"):
            name = w["traffic"] if part == "traffic" else w["name"]
            assert os.path.exists(os.path.join(
                ROOT, "portbench", part, f"{name}.json")), (part, name)
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, len(b["workloads"]) // 4)


def test_metrics_have_bounds_readers_and_cells():
    b = manifest()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           f"{m['name']}.py")), m["name"]
        for cell in m["workloads"]:
            assert cell in set(e2e[m["moves"]].get("workloads", cells))
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in b["per_layer"]:
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_reports_setup_another_metric_and_a_layer():
    from portbench import run
    b = manifest()
    for w in b["workloads"]:
        e2e, layer = run.cell_metrics(b, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert layer, w["name"]


def test_check_time_fits():
    b = manifest()
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (b["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
