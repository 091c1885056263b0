"""What a run imports, and a cell, traffic and metric added as files."""

import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap

from conftest import ROOT, tiny_config, tiny_traffic

FORBIDDEN = {"jax", "jaxlib", "flax", "ucnerf_tpu"}


def _modules_after(code, cwd=ROOT):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=cwd, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_imports_no_jax_nor_the_jax_package():
    """Everything a CPU run of both kinds loads, with every per-layer
    reader and the tables of peaks; names compared whole."""
    code = textwrap.dedent("""
        import glob, importlib.util, os, sys
        sys.path.insert(0, "portbench/tests")
        from conftest import cpu_cell
        from portbench import roofline, run
        for kind in ("train", "render"):
            run.run_cell(cpu_cell(kind, seconds=0.1))
        import portbench.trace
        roofline.peaks("NVIDIA H100 80GB HBM3")
        for path in sorted(glob.glob("portbench/metrics/*.py")):
            name = os.path.basename(path)[:-3].replace(".", "_")
            spec = importlib.util.spec_from_file_location(
                "portbench.metrics." + name, path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
    """)
    found = _modules_after(code)
    assert "ucnerf_tpu_torch" in found
    assert not found & FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    found = _modules_after(
        "import portbench.reference.steps, portbench.reference.rays")
    assert not found & (FORBIDDEN | {"ucnerf_tpu_torch"})
    for name in os.listdir(os.path.join(ROOT, "portbench", "reference")):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ROOT, "portbench", "reference", name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else [node.module])
                for m in mods:
                    assert m.split(".")[0] in ("torch", "numpy", "math",
                                               "portbench", "__future__"), m


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    metric reader, their limits and entries; no file of it changes, and the
    new cell runs (on the CPU) and reads the new metric."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}

    cfg = {"name": "tiny", "source": "https://example.org/tiny",
           "reduced": [], "config": tiny_config()}
    (tmp_path / "portbench/configs/tiny.json").write_text(json.dumps(cfg))
    traffic = tiny_traffic("train")
    (tmp_path / "portbench/traffic/tiny_rig.json").write_text(
        json.dumps(traffic))
    (tmp_path / "portbench/limits/tiny.tiny_rig.json").write_text(
        json.dumps({"limits": {"loss_gap": 1e-4, "grad_gap": 1e-3,
                               "update_gap": 1e-3}}))
    (tmp_path / "portbench/metrics/steps_run.train.py").write_text(
        "def read(run):\n    return float(run.units)\n")
    bench["configs"].append({"name": "tiny", "source": cfg["source"],
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.tiny_rig", "config": "tiny",
                               "traffic": "tiny_rig", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "train_rays_per_s":
            m["workloads"].append("tiny.tiny_rig")
    bench["per_layer"].append({
        "name": "steps_run.train", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "a test", "moves":
        "train_rays_per_s", "workloads": ["tiny.tiny_rig"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = textwrap.dedent(f"""
        import json, sys, torch
        sys.path.append({ROOT!r})
        from portbench import run
        assert run.ROOT == {str(tmp_path)!r}, run.ROOT
        args = run.parse(["--workload", "tiny.tiny_rig", "--seed", "9",
                          "--seconds", "0.1"])
        out = run.execute(args, torch.device("cpu"))
        bench = json.load(open("BENCHMARK.json"))
        _, layer = run.cell_metrics(bench, "tiny.tiny_rig")
        class R: units = 2
        value = run.read_metric("steps_run.train", R)
        print(json.dumps([out["correct"], sorted(out["metrics"]),
                          [m["name"] for m in layer], value]))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert res.returncode == 0, res.stderr[-3000:]
    correct, metrics, layer, value = json.loads(
        res.stdout.strip().splitlines()[-1])
    assert correct
    assert metrics == ["peak_mem_gib", "setup_s", "train_rays_per_s"]
    assert "steps_run.train" in layer and value == 2.0
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_forbidden_names_are_compared_whole(monkeypatch):
    import types

    from portbench import run
    monkeypatch.setitem(sys.modules, "ucnerf_tpu_torch_x",
                        types.ModuleType("ucnerf_tpu_torch_x"))
    assert "ucnerf_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ucnerf_tpu.ops",
                        types.ModuleType("ucnerf_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert {"jax", "ucnerf_tpu"} <= set(run.forbidden_modules())
