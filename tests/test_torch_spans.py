"""The port's spans (``utils/spans.py``) on the CPU, at the tiny preset.

Without a profiler a span is one shared null context; under one, a train
step and a render hold each of their spans as often as their layers run,
nested as the layers are, and the spans change nothing the step computes.
"""

import collections
import json
import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ucnerf_tpu_torch
from ucnerf_tpu_torch import configs
from ucnerf_tpu_torch.cli import train as cli_train
from ucnerf_tpu_torch.data import datasets
from ucnerf_tpu_torch.train import state as state_lib
from ucnerf_tpu_torch.train import step as step_lib
from ucnerf_tpu_torch.utils import spans

torch.set_num_threads(2)

MICRO = 2
TRAIN_SPANS = ("ucnerf.data.sample", "ucnerf.data.to_device",
               "ucnerf.forward", "ucnerf.encode", "ucnerf.losses",
               "ucnerf.backward", "ucnerf.optimizer")


def _config():
    return configs.tiny(batch_size=32, microbatches=MICRO)


def _spans(prof, tmp_path):
    """The ``ucnerf.*`` events of the profile's Chrome trace."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("name", "").startswith("ucnerf.")]


def _inside(inner, outers):
    return any(o["tid"] == inner["tid"] and o["ts"] <= inner["ts"]
               and inner["ts"] + inner["dur"] <= o["ts"] + o["dur"]
               for o in outers)


def _step(cfg, dataset, profiled):
    """One train step from the seed-0 model: (loss, parameters, events)."""
    model = step_lib.init_model(cfg, seed=0, device="cpu")
    state = state_lib.create_train_state(cfg, model)
    train_step = step_lib.make_train_step(model, cfg)
    generator = torch.Generator()

    def run():
        batch = step_lib.batch_to_device(dataset.sample_batch(
            np.random.default_rng(3), cfg.batch_size), "cpu")
        generator.manual_seed(7)
        return train_step(state, batch, 0.5, generator=generator)[1]

    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            stats = run()
    else:
        prof, stats = None, run()
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    return stats["loss"], params, prof


@pytest.fixture(scope="module")
def train_dataset():
    return datasets.load_dataset("train", _config())


def test_span_without_a_profiler_is_one_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first = spans.span("ucnerf.forward")
    assert first is spans.span("ucnerf.encode") is spans.span("x")
    with first:
        pass
    # The decorator keeps the function's name and docstring.
    assert step_lib.batch_to_device.__name__ == "batch_to_device"
    assert "narrowed" in step_lib.batch_to_device.__doc__


def test_a_profiled_train_step_holds_each_span_as_its_layer_runs(
        train_dataset, tmp_path):
    cfg = _config()
    _, _, prof = _step(cfg, train_dataset, profiled=True)
    events = _spans(prof, tmp_path)
    assert all(e["cat"] == "user_annotation" for e in events)
    count = collections.Counter(e["name"] for e in events)
    levels = cfg.model.num_levels
    assert levels == 2
    assert count == {"ucnerf.data.sample": 1, "ucnerf.data.to_device": 1,
                     "ucnerf.forward": MICRO, "ucnerf.encode": MICRO * levels,
                     "ucnerf.losses": MICRO, "ucnerf.backward": MICRO,
                     "ucnerf.optimizer": 1}
    forwards = [e for e in events if e["name"] == "ucnerf.forward"]
    assert all(_inside(e, forwards) for e in events
               if e["name"] == "ucnerf.encode")
    # The layers follow one another: no other span inside a forward.
    for e in events:
        if e["name"] not in ("ucnerf.forward", "ucnerf.encode"):
            assert not _inside(e, forwards), e["name"]


def test_spans_leave_the_step_bitwise(train_dataset):
    cfg = _config()
    loss_off, params_off, _ = _step(cfg, train_dataset, profiled=False)
    loss_on, params_on, _ = _step(cfg, train_dataset, profiled=True)
    assert torch.equal(loss_on, loss_off)
    assert set(params_on) == set(params_off)
    init = dict(step_lib.init_model(cfg, seed=0,
                                    device="cpu").named_parameters())
    for k, p in params_off.items():
        assert torch.equal(params_on[k], p), k
    assert any(not torch.equal(p, init[k]) for k, p in params_off.items())


def test_a_render_holds_one_render_span_and_a_forward_a_chunk(tmp_path):
    cfg = configs.tiny(render_chunk_size=20)
    model = step_lib.init_model(cfg, seed=0, device="cpu")
    eval_step = step_lib.make_eval_step(model, cfg)
    batch = step_lib.dummy_batch(cfg, 48)
    batch = {k: v.reshape((6, 8) + v.shape[1:]) for k, v in batch.items()}
    plain = step_lib.render_image(eval_step, batch, cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = step_lib.render_image(eval_step, batch, cfg)
    for k in plain:
        np.testing.assert_array_equal(traced[k], plain[k], err_msg=k)
    events = _spans(prof, tmp_path)
    count = collections.Counter(e["name"] for e in events)
    chunks = 3  # 48 rays in chunks of 20
    assert count == {"ucnerf.render": 1, "ucnerf.data.to_device": chunks,
                     "ucnerf.forward": chunks,
                     "ucnerf.encode": chunks * cfg.model.num_levels}
    renders = [e for e in events if e["name"] == "ucnerf.render"]
    assert all(_inside(e, renders) for e in events)


def test_cli_train_profile_holds_the_eight_spans(tmp_path):
    """``--profile-steps 1`` traces step 5, which renders a test view."""
    exp = tmp_path / "exp"
    cli_train.main([
        "--tiny", "--device", "cpu", "--max-steps", "6",
        "--profile-steps", "1",
        "-b", f"Config.exp_name = {str(exp)!r}",
        "-b", "Config.train_render_every = 5",
        "-b", "Config.checkpoint_every = 6"])
    with open(exp / "profile" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("ucnerf.")}
    assert names == set(TRAIN_SPANS) | {"ucnerf.render"}


def test_spans_are_the_ports_one_call_of_record_function():
    root = os.path.dirname(ucnerf_tpu_torch.__file__)
    callers = []
    for folder, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(folder, name)
                with open(path) as f:
                    if re.search(r"record_function\s*\(", f.read()):
                        callers.append(os.path.relpath(path, root))
    assert callers == [os.path.join("utils", "spans.py")]
