"""``ucnerf_tpu_torch/tools/scaling_bench.py`` on the CPU: the tiny preset at
1 and 2 gloo ranks, weak and strong, with a batch of 204 rays in 4
microbatches (the strong batch's microbatches of 51 give the 2 ranks
shares of 25 and 26).  The JSON line
carries every field of each sweep point, is marked wiring only, and each
step issues one gradient all-reduce of exactly the parameters' bytes and
one small all-reduce of the stats, nothing else.  The rates are CPU
wiring, not measurements."""

import json

import pytest

from ucnerf_tpu_torch import configs
from ucnerf_tpu_torch.tools import scaling_bench
from ucnerf_tpu_torch.train import step as tstep

ARGS = ["--preset", "tiny", "--ranks", "1,2", "--device", "cpu",
        "--steps", "2", "-b", "Config.batch_size = 204",
        "-b", "Config.microbatches = 4"]
POINT_KEYS = {"mode", "ranks", "global_batch", "rays_per_rank", "shares",
              "step_ms", "rays_per_sec", "efficiency", "all_reduce_ms",
              "all_reduce_bytes", "all_reduce_share", "peak_bytes_per_rank",
              "collectives_per_step", "param_bytes", "audit_ok", "loss"}


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    out = tmp_path_factory.mktemp("scaling") / "scaling.json"
    assert scaling_bench.main(ARGS + ["--out", str(out)]) == 0
    return json.loads(out.read_text())


def test_the_line_describes_a_wiring_run(sweep):
    assert sweep["metric"] == "data_parallel_scaling"
    assert sweep["preset"] == "tiny" and sweep["device"] == "cpu"
    assert sweep["backend"] == "gloo" and sweep["wiring_only"] is True
    assert sweep["microbatches"] == 4 and sweep["audit_ok"] is True
    assert sweep["launch_seconds"] > 0  # one launch for the sweep
    assert [(r["mode"], r["ranks"]) for r in sweep["sweep"]] == [
        ("weak", 1), ("strong", 1), ("weak", 2), ("strong", 2)]


def test_every_point_has_its_fields(sweep):
    by = {(r["mode"], r["ranks"]): r for r in sweep["sweep"]}
    for (mode, world), r in by.items():
        assert set(r) == POINT_KEYS, (mode, world)
        assert r["rays_per_sec"] > 0 and r["step_ms"] > 0
        assert 0 < r["all_reduce_share"] < 1
        assert r["peak_bytes_per_rank"] == [None] * world  # not on the CPU
        assert r["global_batch"] == r["rays_per_rank"] * world
    assert by[("weak", 2)]["global_batch"] == 2 * 204
    assert by[("strong", 2)]["global_batch"] == 204
    assert by[("strong", 2)]["shares"] == [25, 26]
    assert by[("weak", 1)]["efficiency"] == by[("strong", 1)]["efficiency"] \
        == 1.0


def test_one_gradient_all_reduce_of_the_parameter_bytes(sweep):
    model = tstep.init_model(configs.tiny(microbatches=4), seed=0,
                             device="cpu")
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    for r in sweep["sweep"]:
        assert r["param_bytes"] == r["all_reduce_bytes"] == param_bytes
        grads, stats = r["collectives_per_step"]
        assert grads == {"op": "all_reduce", "bytes": param_bytes,
                         "dtype": "torch.float32"}
        assert stats["op"] == "all_reduce" and 0 < stats["bytes"] < 100
        assert r["audit_ok"] is True


def test_audit_refuses_other_collectives():
    ok = [{"op": "all_reduce", "bytes": 400}, {"op": "all_reduce", "bytes": 8}]
    assert scaling_bench.audit(ok, 400)
    assert not scaling_bench.audit(ok[:1], 400)
    assert not scaling_bench.audit(ok, 404)
    assert not scaling_bench.audit(
        ok + [{"op": "broadcast", "bytes": 4}], 400)
