"""Run one cell of the benchmark once and print its result line.

  python3 -m portbench.run --workload waymo.train --seed 7 --seconds 51 \
      --trace 0

Everything a cell is comes from files, by the names in ``BENCHMARK.json``:
the workload's configuration file (``configs/<config>.json``), its traffic
file (``traffic/<traffic>.json``, whose ``kind`` picks the driver in
``kinds/``), its limits (``limits/<workload>.json``) and, with ``--trace
1``, a reader a per-layer metric (``metrics/<metric>.py``).  Adding a cell
or a metric adds files and entries; no file here changes.

The run needs the cards the cell asks for and fails without them.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, the
card's name and power limit, and last ``checks``: each number compared
beside its limit, which also close standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402

# One process with few threads: the host's own thread pools stay small so
# that they take no cores from the thread that launches the card's work.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
# Top-level module names that a run may not hold once its window closed:
# the JAX stack and the JAX package (compared whole, so the port's
# ``ucnerf_tpu_torch`` is not one of them).
FORBIDDEN = ("jax", "jaxlib", "flax", "ucnerf_tpu")


def load_cell(workload: str):
    """(manifest, workload entry, configuration file, traffic file)."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        config_file = json.load(f)
    with open(os.path.join(HERE, "traffic", f"{entry['traffic']}.json")) as f:
        traffic = json.load(f)
    return bench, entry, config_file, traffic


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


class Cell:
    """One run's parameters and the device hooks the kinds call."""

    def __init__(self, name, cfg, traffic, seed, seconds, trace, device):
        from portbench.kinds.common import port_config
        self.name, self.cfg, self.traffic = name, cfg, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.config = port_config(cfg)
        self.setup_s = None
        self.notes, self.stages = [], []

    @property
    def cuda(self):
        return self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize(self.device)

    def peak_bytes(self) -> int:
        if not self.cuda:
            return 0
        import torch
        return int(torch.cuda.max_memory_allocated(self.device))

    def reset_peak(self):
        if self.cuda:
            import torch
            torch.cuda.reset_peak_memory_stats(self.device)

    def mark_setup_done(self):
        self.setup_s = time.perf_counter() - T_START
        self.note("set-up stages (s since start): " + ", ".join(
            self.stages + [f"done {self.setup_s:.2f}"]))

    def free(self):
        gc.collect()
        if self.cuda:
            import torch
            torch.cuda.empty_cache()

    def profile(self):
        import torch
        from portbench.trace import Profile
        return Profile(torch)

    def note(self, text):
        self.notes.append(text)

    def note_intervals(self, unit, stamps):
        """Note the host seconds between the window's units: a statistic
        beside the rate (the host runs at most a unit ahead of the card)."""
        import numpy as np
        d = np.diff(stamps)
        if len(d):
            self.note(f"{unit} seconds: n {len(d)}, median "
                      f"{np.median(d):.4f}, p90 {np.quantile(d, 0.9):.4f}, "
                      f"max {d.max():.4f}")

    def stage(self, label):
        """Note the seconds since the process started, at a stage of the
        set-up."""
        self.stages.append(f"{label} {time.perf_counter() - T_START:.2f}")


class Readings:
    """What a per-layer reader sees of a traced run."""

    def __init__(self, cell, result, peaks):
        self.kind = cell.traffic["kind"]
        self.cfg, self.traffic = cell.cfg, cell.traffic
        self.trace, self.units = result.trace, result.units
        self.unit_rays, self.unit_s = result.unit_rays, result.unit_s
        self.chunks_per_unit = result.chunks_per_unit
        self.host = result.host
        self.peak_flops = None if peaks is None else peaks["f32_flops"]
        self.peak_bw = None if peaks is None else peaks["hbm_bytes_per_s"]


def read_metric(name, readings):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(readings)


def cell_metrics(bench, workload):
    """The cell's end-to-end metric entries, and the per-layer entries that
    list it."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    layer = [m for m in bench["per_layer"] if workload in m["workloads"]]
    return e2e, layer


def run_cell(cell):
    """The kind's run on a prepared cell."""
    kind = importlib.import_module(f"portbench.kinds.{cell.traffic['kind']}")
    return kind.run(cell)


def card_line():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi unavailable: {e}"]


def execute(args, device, card=()):
    """Run the cell on `device` and return the result line's object."""
    import torch

    from portbench import roofline
    bench, entry, config_file, traffic = load_cell(args.workload)
    cell = Cell(args.workload, config_file["config"], traffic, args.seed,
                args.seconds, bool(args.trace), device)
    result = run_cell(cell)
    e2e, layer = cell_metrics(bench, args.workload)
    metrics = {}
    out = {"correct": bool(result.correct), "attempted": result.attempted,
           "failed": result.failed}
    device_info = {"platform": "gpu" if cell.cuda else device.type,
                   "kind": (torch.cuda.get_device_name(device) if cell.cuda
                            else device.type),
                   "count": entry["chips"],
                   "memory_peak_bytes": result.memory_peak_bytes}
    if args.trace:
        readings = Readings(cell, result, roofline.peaks(
            device_info["kind"]))
        for m in layer:
            value = read_metric(m["name"], readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = result.trace.busy_s()
        device_info["window_s"] = result.trace.window_s
    else:
        values = dict(result.end_to_end, setup_s=cell.setup_s)
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    out["metrics"] = metrics
    out["device"] = device_info
    if args.trace:
        out["breakdown"] = {"device_ops": result.trace.top_ops(),
                            "idle_gaps": result.trace.idle_gaps()}
    out["card"] = list(card)
    out["notes"] = cell.notes
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in result.checks.items()}
    return out


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    _, entry, _, _ = load_cell(args.workload)
    import torch
    chips = entry["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: {chips} CUDA device(s) needed, {found} found",
              file=sys.stderr)
        return 2
    # The configurations compute in float32 with TF32 off.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"portbench: card {card}, {chips} used", file=sys.stderr)
    out = execute(args, torch.device("cuda", 0), card)
    # Last, after all that the run imported (the kinds, the references and
    # the per-layer readers alike): no result from a process that holds
    # the JAX stack or package.
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for text in out["notes"]:
        print(f"portbench: {text}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
