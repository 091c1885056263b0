"""The train step's CUDA-graph path on the CPU, at the tiny preset.

A CUDA graph needs a card (``tests/test_card_train_graph.py`` holds the
real one against the eager step there).  Here: the forward reads the
schedule's values as 0-d tensors bit for bit as it reads them as Python
floats; the constants made once equal those built on each call; the sky's
cumulative product and its backward are torch's, bit for bit; the capture
policy (eager on CPU tensors, under a process group and where a call's key
differs from the previous call's; a capture where it repeats it; one graph
kept) with a stand-in for the graph that runs the captured loop on the CPU,
whose steps are bitwise the eager steps and whose gradients stay in the
eager call's ``.grad`` tensors; the benchmark's reader of the share of
replayed loops (``portbench/metrics/graphed_share.train.py``) on hand-made
traces; and the count of the port's kernels by their names in a profiler
trace (``tests/card_launches.py``), by which the card test counts what a
replay ran.
"""

import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench.run import read_metric
from portbench.trace import SPAN, Trace
from ucnerf_tpu_torch import configs
from ucnerf_tpu_torch.models import sky
from ucnerf_tpu_torch.ops import mathx, rendering
from ucnerf_tpu_torch.parallel import mesh as meshlib
from ucnerf_tpu_torch.train import losses as losses_lib
from ucnerf_tpu_torch.train import state as state_lib
from ucnerf_tpu_torch.train import step as step_lib

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _config(**over):
    return configs.tiny(batch_size=48, microbatches=3, **over)


def _batch(cfg, n, seed):
    """``dummy_batch`` with rays, targets and sky pixels varied by `seed`,
    as CPU tensors."""
    rng = np.random.default_rng(seed)
    b = step_lib.dummy_batch(cfg, n)
    b["origins"] = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    b["rgb"] = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    b["sky_segs"] = (rng.uniform(size=n) < 0.3).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _flat(tree, prefix=""):
    """The tensors of nested dicts and lists, by path."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple)) else ())
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def _assert_bitwise(got, want, what):
    assert set(got) == set(want), what
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    assert not differ, f"{what}: {differ} differ"


def _tensor_schedule(schedule):
    return {k: (tuple(step_lib._scalar(x, CPU) for x in v)
                if isinstance(v, tuple) else step_lib._scalar(v, CPU))
            for k, v in schedule.items()}


def _forward_and_grads(model, cfg, batch, train_frac, schedule):
    """The keyed training forward's outputs and the gradients of its total
    loss, from a generator seeded 7."""
    model.zero_grad(set_to_none=True)
    generator = torch.Generator().manual_seed(7)
    renderings, history = model(batch, train_frac, compute_extras=False,
                                train=True, generator=generator,
                                schedule=schedule)
    total, _, _ = losses_lib.compute_all_losses(batch, renderings, history,
                                                cfg)
    total.backward()
    grads = {f"grad {n}": p.grad.clone()
             for n, p in model.named_parameters() if p.grad is not None}
    out = _flat([renderings, history])
    out.update(grads)
    return out


@pytest.mark.parametrize("near_anneal_rate,train_frac",
                         [(None, 0.13), (None, 0.71), (2.0, 0.13),
                          (2.0, 0.71)])
def test_schedule_as_tensors_gives_the_float_forward_bitwise(
        near_anneal_rate, train_frac):
    cfg = _config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, near_anneal_rate=near_anneal_rate))
    model = step_lib.init_model(cfg, seed=0, device="cpu")
    batch = _batch(cfg, 16, 1)
    schedule = model.schedule(train_frac)
    if near_anneal_rate is not None:
        assert 0 < schedule["init_s_near"] < cfg.model.near_anneal_init
    assert 0 < schedule["anneal"] < 1
    want = _forward_and_grads(model, cfg, batch, train_frac, None)
    got = _forward_and_grads(model, cfg, batch, 0.5,
                             _tensor_schedule(schedule))
    _assert_bitwise(got, want, "forward with the schedule as tensors")


def test_hex_pattern_is_made_once_and_equals_a_per_call_build():
    made = rendering.hex_pattern(torch.float32, CPU)
    assert rendering.hex_pattern(torch.float32, CPU) is made
    per_call = torch.tensor(rendering._HEX_PATTERN,
                            dtype=torch.float32).reshape(6, 1, 1)
    assert made.dtype == per_call.dtype and torch.equal(made, per_call)


@pytest.mark.parametrize("start,stop,num",
                         [(0, 1 - 0.11, 17), (1 / 64, 1 - 1 / 64 - mathx.EPS,
                                              32), (0.0, 1.0, 120)])
def test_linspace_with_made_once_endpoints_equals_a_per_call_build(
        start, stop, num):
    f32 = torch.float32
    start_t = torch.tensor(start, dtype=f32)
    stop_t = torch.tensor(stop, dtype=f32)
    step = torch.arange(num - 1, dtype=f32) / (num - 1)
    want = torch.cat([start_t * (1 - step) + stop_t * step,
                      stop_t.reshape(1)])
    assert torch.equal(mathx.linspace(start, stop, num, CPU), want)
    assert mathx.constant(float(stop), CPU) is mathx.constant(float(stop),
                                                              CPU)


@pytest.mark.parametrize("seed", [0, 1])
def test_sky_cumprod_is_torch_cumprod_and_its_backward_bitwise(seed):
    """The sky's transmittance factors (1 - alpha + 1e-10 after a column of
    ones, alpha 1 where the terminal interval saturates)."""
    gen = torch.Generator().manual_seed(seed)
    alpha = torch.rand((64, 120), generator=gen)
    alpha[:, -1] = 1.0
    x = torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10],
                  dim=-1).requires_grad_()
    g = torch.randn(x.shape, generator=gen)
    want = torch.cumprod(x, dim=-1)
    got = sky.cumprod_nonzero(x)
    assert torch.equal(got, want)
    assert torch.equal(torch.autograd.grad(got, x, g)[0],
                       torch.autograd.grad(want, x, g)[0])


def test_graph_key_is_none_for_cpu_tensors():
    cfg = _config()
    model = step_lib.init_model(cfg, seed=0, device="cpu")
    batch = _batch(cfg, 48, 0)
    assert step_lib._graph_key(batch, [16, 16, 16], torch.Generator(), None,
                               list(model.parameters())) is None


class StandInGraph:
    """``_CudaGraph`` on the CPU: the capture runs the body once to make
    its output tensors and then puts the generator back, since a capture
    draws nothing; each replay runs the body again and copies its results
    into those tensors."""

    def __init__(self, body, generator):
        self.body = body
        state = None if generator is None else generator.get_state()
        self.outputs = body()
        if generator is not None:
            generator.set_state(state)

    def replay(self):
        got = _flat(self.body())
        for k, v in _flat(self.outputs).items():
            v.copy_(got[k])


@pytest.fixture
def stand_in(monkeypatch):
    """The graph path on the CPU: CPU calls have keys, and the stand-in
    captures their graphs."""
    monkeypatch.setattr(step_lib, "_graph_key", functools.partial(
        step_lib._graph_key, devices=("cpu",)))
    monkeypatch.setattr(step_lib, "_CudaGraph", StandInGraph)


def _run(cfg, graphs, sizes, group=None):
    """Steps of the seed-0 model on batches of `sizes` rays; per step the
    stats, the gradients as the optimizer gets them, and the parameters
    and Adam moments after it; and the train step, with the gradients'
    storage after each step as ``grad_ptrs``."""
    model = step_lib.init_model(cfg, seed=0, device="cpu")
    state = state_lib.create_train_state(cfg, model)
    train_step = step_lib.make_train_step(model, cfg, group, graphs=graphs)
    generator = torch.Generator()
    update = state.optimizer.update
    seen = {}

    def snap_update():
        seen.update({f"grad {n}": p.grad.clone()
                     for n, p in model.named_parameters()})
        update()

    state.optimizer.update = snap_update
    steps, grads = [], []
    for i, n in enumerate(sizes):
        generator.manual_seed(100 + i)
        state, stats = train_step(state, _batch(cfg, n, i), 0.1 * (i + 1),
                                  generator=generator)
        grads.append([p.grad.data_ptr() for p in model.parameters()])
        got = dict(seen)
        got.update(_flat(stats, "stats"))
        got.update({f"param {k}": p.detach().clone()
                    for k, p in model.named_parameters()})
        adam = state.optimizer.adam.state
        got.update({f"adam {k} {m}": adam[p][m].clone()
                    for k, p in model.named_parameters()
                    for m in ("exp_avg", "exp_avg_sq")})
        steps.append(got)
    train_step.grad_ptrs = grads
    return steps, train_step


def test_stand_in_graph_step_is_bitwise_the_eager_step(stand_in):
    cfg = _config()
    sizes = [48] * 4
    eager, eager_step = _run(cfg, False, sizes)
    graphed, step = _run(cfg, True, sizes)
    assert eager_step.captures == eager_step.replays == 0
    assert step.captures == 1 and step.replays == 3
    for i, (got, want) in enumerate(zip(graphed, eager)):
        _assert_bitwise(got, want, f"step {i + 1}")
    # One set of gradients: the graph keeps the first call's `.grad`.
    assert all(p == step.grad_ptrs[0] for p in step.grad_ptrs)


def test_stand_in_graph_with_a_rand_vec_and_annealed_near(stand_in):
    cfg = _config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, near_anneal_rate=0.8))
    results = []
    for graphs in (False, True):
        model = step_lib.init_model(cfg, seed=0, device="cpu")
        state = state_lib.create_train_state(cfg, model)
        train_step = step_lib.make_train_step(model, cfg, graphs=graphs)
        losses = []
        for i in range(3):
            rand_vec = torch.randn((48, 3),
                                   generator=torch.Generator().manual_seed(i))
            state, stats = train_step(state, _batch(cfg, 48, i), 0.2 * i,
                                      rand_vec=rand_vec)
            losses.append(stats["loss"].clone())
        results.append(torch.stack(losses + [p.detach().reshape(-1)[:64]
                                             .mean() for p in
                                             model.parameters()]))
    assert train_step.captures == 1 and train_step.replays == 2
    assert torch.equal(results[0], results[1])


@pytest.mark.parametrize("sizes,captures,replays", [
    # 48: eager, capture, replay; 24: eager; 48: replay; 24: eager (its
    # previous call was 48); 24: capture (the 48 graph goes), replay.
    ([48, 48, 48, 24, 48, 24, 24], 2, 4),
    # Sizes that alternate never repeat the previous call's key.
    ([48, 24, 48, 24, 48], 0, 0),
    # Each repeat of a new size captures anew; the graph before goes.
    ([48, 48, 24, 24, 48, 48], 3, 3),
])
def test_a_call_captures_when_it_repeats_the_previous_key(
        stand_in, sizes, captures, replays):
    cfg = _config()
    eager, _ = _run(cfg, False, sizes)
    graphed, step = _run(cfg, True, sizes)
    assert (step.captures, step.replays) == (captures, replays)
    for i, (got, want) in enumerate(zip(graphed, eager)):
        _assert_bitwise(got, want, f"step {i + 1}")


def test_a_process_group_keeps_the_step_eager(stand_in, monkeypatch):
    monkeypatch.setattr(meshlib, "world_size", lambda group: 1)
    monkeypatch.setattr(meshlib, "rank", lambda group: 0)
    monkeypatch.setattr(meshlib, "all_reduce_grads",
                        lambda params, group: None)
    monkeypatch.setattr(meshlib, "all_reduce_mean",
                        lambda tensors, group: list(tensors))
    cfg = _config()
    steps, step = _run(cfg, True, [48] * 3, group=object())
    eager, _ = _run(cfg, False, [48] * 3)
    assert step.captures == step.replays == 0 and step.graph is None
    for i, (got, want) in enumerate(zip(steps, eager)):
        _assert_bitwise(got, want, f"step {i + 1}")


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1}


def _traced(kind, names):
    """A run of `kind` whose traced span [0, 100] holds a host span of each
    of `names`, one every 10 us, and one outside the span."""
    events = [_x("user_annotation", SPAN, 0, 100)]
    events += [_x("user_annotation", n, 5 + 10 * i, 4)
               for i, n in enumerate(names)]
    events += [_x("user_annotation", "ucnerf.graph_replay", 150, 4)]
    return SimpleNamespace(kind=kind, trace=Trace(events), units=2)


@pytest.mark.parametrize("names,share", [
    # Two replayed steps.
    (["ucnerf.graph_replay", "ucnerf.optimizer"] * 2, 100.0),
    # Two eager steps of 3 microbatches: a forward span each.
    (["ucnerf.forward", "ucnerf.backward"] * 6, 0.0),
    # One replayed and one eager step: replays over replays and forwards.
    (["ucnerf.graph_replay"] + ["ucnerf.forward"] * 3, 25.0),
    # Neither span: nothing to read, as at a program without the graph.
    (["ucnerf.optimizer", "ucnerf.data.sample"], None),
])
def test_graphed_share_reader_on_hand_made_traces(names, share):
    assert read_metric("graphed_share.train",
                       _traced("train", names)) == share
    assert read_metric("graphed_share.train",
                       _traced("render", names)) is None


# Kernel names as a profiler trace gives them, by the wrapper whose launch
# they are (``tests/card_launches.py``); the others name no wrapper.
_KERNEL_NAMES = {
    "take_cm": "void (anonymous namespace)::take_kernel<4, float, true>"
               "(float const*, long, int const*, float*, long)",
    "take_wsum_cm": "void (anonymous namespace)::take_wsum_kernel<4, "
                    "float, false>(float const*, long, int const*)",
    "hash_corners": "(anonymous namespace)::hash_corners_kernel(float "
                    "const*, long, (anonymous namespace)::LevelGeometry)",
    "run_starts": "(anonymous namespace)::run_starts_kernel(int const*, "
                  "long, long, int*)",
    "scatter_add_cm": "void (anonymous namespace)::rows_kernel<(anonymous "
                      "namespace)::RunWalk<4, (anonymous namespace)::"
                      "F32Planes<4>, 8> >(RunWalk<4>, long, float*)",
    "scatter_add_wsum_cm": "void (anonymous namespace)::rows_kernel<"
                           "(anonymous namespace)::RunWalk<4, (anonymous "
                           "namespace)::WeightedRows<4>, 4> >(long)",
    "scatter_add_dense_cm": "void (anonymous namespace)::rows_kernel<"
                            "(anonymous namespace)::DenseWalk<4> >(long)",
    "scatter_add_packed_cm": "void (anonymous namespace)::rows_kernel<"
                             "(anonymous namespace)::RunWalk<4, (anonymous "
                             "namespace)::Bf16Pairs<4>, 8> >(long)",
    "scatter_add_wsum_packed_cm": "void (anonymous namespace)::rows_kernel<"
                                  "(anonymous namespace)::RunWalk<4, "
                                  "(anonymous namespace)::Bf16Records<4>, "
                                  "8> >(long)",
    "scatter_add_chunked_cm": "void (anonymous namespace)::"
                              "chunk_tiles_kernel<4>(float const*, long)",
    None: "void (anonymous namespace)::tier_kernel<(anonymous namespace)::"
          "RunWalk<4, (anonymous namespace)::WeightedRows<4>, 8> >(long) "
          "interleave_kernel<4> interleave_grads_kernel<4> "
          "form_records_kernel<4> dense_pack_kernel<4> "
          "gather_records_kernel<8> DeviceRadixSortOnesweepKernel",
}


@pytest.mark.parametrize("wrapper", list(_KERNEL_NAMES))
def test_card_launches_counts_each_kernel_under_its_wrapper(wrapper):
    import card_launches

    assert set(card_launches.KERNELS) == set(_KERNEL_NAMES) - {None}
    names = [_KERNEL_NAMES[wrapper]] * 3
    want = dict.fromkeys(card_launches.KERNELS, 0)
    if wrapper is not None:
        want[wrapper] = 3
    assert card_launches.count(names) == want
