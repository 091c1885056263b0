"""A train state of the port back in the JAX package: the port's
``convert.state_to_export`` npz goes through
``tools/import_port_checkpoint.py`` into an orbax checkpoint, which the
JAX package's own ``ucnerf_tpu.train.checkpoints.restore_checkpoint``
restores, on the committed tiny fixture's model
(``torch_jax_fixture.BINDINGS``), without and with camera refinement
(``cam_lr_mult`` 0.1 puts an empty link into the optax chain).

Each case's port state: the JAX run of ``torch_jax_fixture.run_case``
after 2 steps, imported into the port, then trained 2 more steps by the
port's own ``make_train_step`` (keyed draws from a seeded generator), so
that every parameter, moment and count is the port's.

Tolerances (those of ``tests/test_torch_jax_checkpoint.py``, the other
direction of the same bridge):
- the orbax checkpoint: every parameter, Adam moment and count and the
  step bitwise the port's, dtypes included; JAX -> port -> JAX bitwise;
- JAX's 64-ray render of the restored state against the port's:
  rtol 1e-4, atol 1e-5;
- JAX's next step from the restored state against the port's: the port's
  gradient within rtol 1e-4 and an atol of 1e-5 x max|grad| of the leaf
  (2e-5 for the tables) of JAX's, plus 4 x the port's own f32 error
  against float64, carried through the clips and Adam by
  ``torch_jax_fixture.adam_step_bound``; the port on JAX's side of every
  ReLU kink, at most 2 samples a unit.
Nothing here is skipped or loosened against that file.
"""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_jax_fixture as fx
from test_torch_jax_checkpoint import RENDER_TOL, _as_export, _t, \
    step_grad_tol
from ucnerf_tpu_torch import configs as tconfigs
from ucnerf_tpu_torch import convert
from ucnerf_tpu_torch.train import state as tstate
from ucnerf_tpu_torch.train import step as tstep

torch.set_num_threads(2)

ROOT = fx.ROOT
sys.path.insert(0, os.path.join(ROOT, "tools"))
import export_jax_checkpoint as exporter  # noqa: E402
import import_port_checkpoint as importer  # noqa: E402

CASES = ("plain", "cameras")
PORT_STEPS = 2
PORT_SEED = 21


def _tool_flags(bindings, exp):
    out = ["--tiny", "-b", f"Config.exp_name = {exp!r}"]
    for b in bindings:
        out += ["-b", b]
    return out


_RUNS = {}


def _run(name, tmp_path_factory):
    if name not in _RUNS:
        _RUNS[name] = _port_case(name, tmp_path_factory.mktemp(name))
    return _RUNS[name]


@pytest.fixture(scope="module", params=CASES)
def case(request, tmp_path_factory):
    return _run(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    return _run("plain", tmp_path_factory)


def _port_case(name, folder):
    """The JAX run of `name`, imported into the port and trained on by the
    port; its export written by the tool into an orbax folder, restored by
    the JAX package."""
    from ucnerf_tpu.train import checkpoints as jckpt
    from ucnerf_tpu.train import state as jstate

    cfg_j, export, expect = fx.run_case(name, str(folder))
    bindings = [str(b) for b in expect["bindings"]]
    cfg = tconfigs.load_config("tiny", bindings)
    state = convert.state_from_export(export, tstate.create_train_state(
        cfg, tstep.init_model(cfg, seed=0, device="cpu")))
    train_step = tstep.make_train_step(state.model, cfg)
    rng = np.random.default_rng(PORT_SEED)
    gen = torch.Generator().manual_seed(PORT_SEED)
    for _ in range(PORT_STEPS):
        batch = {k: _t(v) for k, v in
                 fx.ray_batch(cfg_j, rng, fx.TRAIN_RAYS).items()}
        state, _ = train_step(state, batch, fx.TRAIN_FRAC, generator=gen)
    npz = str(folder / "port.npz")
    convert.state_to_export(state, npz)
    back = str(folder / "back")
    importer.main(_tool_flags(bindings, back) + ["--export", npz])
    _, params, _, _ = fx.jax_model(bindings)
    restored, step = jckpt.restore_checkpoint(
        back, jstate.create_train_state(cfg_j, params))
    return dict(name=name, cfg=cfg, cfg_j=cfg_j, bindings=bindings,
                jax_export=export, expect=expect, folder=folder, state=state,
                npz=npz, back=back, restored=restored, step=step)


def test_orbax_holds_the_port_state_bitwise(case):
    state, restored = case["state"], case["restored"]
    assert case["step"] == state.step == fx.STEPS + PORT_STEPS
    want = convert.load_export(case["npz"], "nerf")
    got = exporter.nerf_arrays(case["back"])
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert np.array_equal(got[key], value), key
    assert int(restored.step) == state.step
    assert restored.step.dtype == np.int32
    adam_i, sched_i = importer.split_chain(restored.opt_state)
    assert int(restored.opt_state[adam_i].count) == fx.STEPS + PORT_STEPS
    assert int(restored.opt_state[sched_i].count) == state.optimizer.count
    if case["name"] == "cameras":
        # The empty cam_scale link sits between Adam and the schedule.
        assert sched_i == adam_i + 2
        assert np.asarray(restored.params["cam_refine"]["se3_deltas"]).any()


def test_jax_render_of_the_port_state_matches_the_port(case):
    expect = case["expect"]
    _, _, _, eval_step = fx.jax_model(case["bindings"])
    batch = {k[len("eval/batch/"):]: v for k, v in expect.items()
             if k.startswith("eval/batch/")}
    want = eval_step(case["restored"].params,
                     jax.tree.map(jax.numpy.asarray, batch), 1.0, 0)
    with torch.no_grad():
        got = tstep.make_eval_step(case["state"].model, case["cfg"])(
            {k: _t(v) for k, v in batch.items()}, 1.0, 0,
            _t(expect["eval/rand_vec"]))
    assert {"rgb", "depth", "acc"} <= set(want) <= set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                   err_msg=k, **RENDER_TOL)
    assert np.ptp(np.asarray(want["rgb"])) > 0.05


def test_jax_next_step_of_the_port_state_matches_the_port(case):
    """JAX's step from the restored state against the port's step from its
    own, within the bound the gradient tolerance gives each entry."""
    cfg, cfg_j = case["cfg"], case["cfg_j"]
    expect = case["expect"]
    _, _, grad_fn, _ = fx.jax_model(case["bindings"])
    batch = {k[len("train/batch/"):]: v for k, v in expect.items()
             if k.startswith("train/batch/")}
    after_j, grads_j, inter = fx.jax_step(cfg_j, grad_fn, case["restored"],
                                          batch)
    kink_arrays = fx._near_zero(inter)
    before = convert.export_arrays(case["state"])
    after = convert.flatten_tree(jax.tree.map(np.asarray, {
        "params": after_j.params, "adam": _adam_moments(after_j.opt_state)}))
    grads = convert.flatten_tree(jax.tree.map(np.asarray, grads_j))
    # The port's step from a copy of its state.
    state = convert.state_from_export(before, tstate.create_train_state(
        cfg, tstep.init_model(cfg, seed=0, device="cpu")))
    tbatch = {k: _t(v) for k, v in batch.items()}
    rand_vec = _t(expect["train/rand_vec"])
    f32_err = fx.f32_grad_error(state.model, cfg, tbatch, rand_vec)
    kinks = {}
    hooks = fx.jax_relu_branch(state.model, kink_arrays, kinks)
    try:
        new_state, _ = tstep.make_train_step(state.model, cfg)(
            state, tbatch, fx.TRAIN_FRAC, rand_vec=rand_vec)
    finally:
        for h in hooks:
            h.remove()
    assert len(kinks) == 4
    assert max(int(n.max()) for n in kinks.values()) <= fx.KINK_CAP, kinks
    bound = fx.adam_step_bound(cfg, grads, step_grad_tol(f32_err), before,
                                after)
    got = _as_export(new_state)
    assert set(got) == set(bound)
    tight = []
    for key, b in bound.items():
        err = np.abs(got[key].astype(np.float64) - after[key])
        assert (err <= b).all(), (key, float((err / b).max()))
        if key.startswith("params/"):
            moved = np.abs(after[key] - before[key].astype(np.float64))
            tight.append((b[moved > 0] < 1e-2 * moved[moved > 0]).mean())
    assert np.median(tight) > 0.5, tight
    assert int(after_j.step) == new_state.step == case["step"] + 1


def _adam_moments(opt_state):
    adam_i, _ = importer.split_chain(opt_state)
    return {"mu": opt_state[adam_i].mu, "nu": opt_state[adam_i].nu}


def _restore_tree(exp):
    """The newest orbax checkpoint under `exp` as nested dicts and lists of
    numpy arrays (the exporter's ``restore_numpy``)."""
    from ucnerf_tpu.train import checkpoints as jckpt

    step = jckpt.latest_checkpoint_step(exp)
    return exporter.restore_numpy(os.path.join(exp, "checkpoints",
                                               str(step)))


def _assert_same_tree(a, b, path="state"):
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}/{i}")
    elif a is not None:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path


def test_jax_port_jax_is_bitwise(case, tmp_path):
    """JAX's orbax state -> exporter -> port -> state_to_export -> the
    tool -> orbax: the same tree, every leaf bitwise, the chain's empty
    links included."""
    cfg = case["cfg"]
    state = convert.state_from_export(
        case["jax_export"], tstate.create_train_state(
            cfg, tstep.init_model(cfg, seed=1, device="cpu")))
    npz = str(tmp_path / "again.npz")
    convert.state_to_export(state, npz)
    again = str(tmp_path / "again")
    importer.main(_tool_flags(case["bindings"], again) + ["--export", npz])
    _assert_same_tree(_restore_tree(str(case["folder"] / "state")),
                      _restore_tree(again))


_KERNEL = "params/nerf_mlp/density_out/kernel"
# Mutations of the port's export, and what the refusal must name.
STRICT = {
    "missing_param": (lambda e: e.pop(_KERNEL), f"missing {_KERNEL}"),
    "extra_param": (lambda e: e.__setitem__(
        "params/nerf_mlp/extra/bias", np.zeros(3, np.float32)),
        "unexpected params/nerf_mlp/extra/bias"),
    "moment_shape": (lambda e: e.__setitem__(
        "adam/nu/nerf_mlp/density_out/kernel",
        e["adam/nu/nerf_mlp/density_out/kernel"][:, :-1]),
        "adam/nu/nerf_mlp/density_out/kernel: shape"),
    "param_dtype": (lambda e: e.__setitem__(_KERNEL, e[_KERNEL].astype(
        np.float64)), f"{_KERNEL}: dtype float64, expected float32"),
    "count_dtype": (lambda e: e.__setitem__("adam/count", np.int64(4)),
                    "adam/count: dtype int64, expected int32"),
    "missing_count": (lambda e: e.pop("schedule/count"),
                      "missing schedule/count"),
    "extra_key": (lambda e: e.__setitem__("junk", np.zeros(1)),
                  "unexpected junk"),
    "kind": (lambda e: e.__setitem__("kind", np.array("mvs")),
             "kind 'mvs', expected 'nerf'"),
    "format": (lambda e: e.__setitem__("format", np.array("other/1")),
               "format 'other/1'"),
}


@pytest.mark.parametrize("mutation", sorted(STRICT))
def test_tool_is_strict(plain, mutation, tmp_path):
    """A missing, unexpected, misshapen or mistyped array is refused,
    named, and nothing is written."""
    mutate, named = STRICT[mutation]
    export = convert.load_export(plain["npz"], "nerf")
    mutate(export)
    npz = str(tmp_path / "bad.npz")
    np.savez(npz, **export)
    exp = str(tmp_path / "exp")
    with pytest.raises(ValueError) as err:
        importer.main(_tool_flags(plain["bindings"], exp) + ["--export",
                                                             npz])
    assert named in str(err.value), str(err.value)
    assert not os.path.exists(os.path.join(exp, "checkpoints"))


def test_tool_lists_every_misfit(plain):
    export = convert.load_export(plain["npz"], "nerf")
    for name in ("missing_param", "extra_param", "count_dtype"):
        STRICT[name][0](export)
    with pytest.raises(ValueError, match="3 misfits") as err:
        importer.state_from_export(plain["cfg_j"], export)
    for name in ("missing_param", "extra_param", "count_dtype"):
        assert STRICT[name][1] in str(err.value)


def test_tool_refuses_other_chains():
    import optax

    empty, sched = optax.EmptyState(), optax.ScaleByScheduleState(count=1)
    adam = optax.ScaleByAdamState(count=1, mu={}, nu={})
    assert importer.split_chain((empty, adam, empty, sched, empty)) == (1, 3)
    for chain in ((empty, adam, empty), (empty, sched, adam),
                  (adam, sched, sched), (adam, sched,
                                         optax.ScaleByAdamState(1, {}, {})),
                  (adam, optax.MaskedState(inner_state=()), sched),
                  [adam, sched], adam):
        with pytest.raises(ValueError, match="unexpected optimizer chain"):
            importer.split_chain(chain)


def test_tool_refuses_a_folder_at_or_after_the_step(plain, tmp_path):
    exp = str(tmp_path / "exp")
    shutil.copytree(plain["back"], exp)
    ckpts = os.path.join(exp, "checkpoints")
    before = sorted(os.listdir(ckpts))
    with pytest.raises(ValueError, match="at or after"):
        importer.main(_tool_flags(plain["bindings"], exp)
                      + ["--export", plain["npz"]])
    os.rename(os.path.join(ckpts, before[0]),
              os.path.join(ckpts, str(plain["step"] + 3)))
    with pytest.raises(ValueError, match="at or after"):
        importer.main(_tool_flags(plain["bindings"], exp)
                      + ["--export", plain["npz"]])
    assert sorted(os.listdir(ckpts)) == [str(plain["step"] + 3)]


def test_jax_clis_restore_the_import(plain, tmp_path):
    """The JAX package's cli.eval renders the written checkpoint and its
    cli.train resumes from it (the tiny preset's synthetic scene)."""
    from ucnerf_tpu.cli import eval as jeval
    from ucnerf_tpu.cli import train as jtrain

    exp = str(tmp_path / "exp")
    shutil.copytree(plain["back"], exp)
    step = plain["step"]
    flags = _tool_flags(plain["bindings"], exp)
    jeval.main(flags + ["--limit", "1"])
    with open(os.path.join(exp, f"psnr_{step}.txt")) as f:
        assert np.isfinite(float(f.read().split()[0]))
    jtrain.main(flags + ["--max-steps", str(step + 1), "-b",
                         "Config.print_every = 1", "-b",
                         "Config.train_render_every = 0"])
    with open(os.path.join(exp, "log_train.txt")) as f:
        log = f.read()
    assert f"resumed from step {step}" in log
    assert f"step {step + 1}/{step + 1}" in log


def test_tool_imports_no_torch(plain, tmp_path):
    """The tool runs with torch unimportable and writes what it wrote in
    this process."""
    exp = str(tmp_path / "exp")
    code = (
        "import sys\n"
        "sys.modules['torch'] = None\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'tools')!r})\n"
        "import import_port_checkpoint\n"
        f"import_port_checkpoint.main({_tool_flags(plain['bindings'], exp)!r}"
        f" + ['--export', {plain['npz']!r}])\n"
        "assert sys.modules['torch'] is None\n"
        "assert not [m for m in sys.modules if m.startswith('torch.')]\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    _assert_same_tree(_restore_tree(plain["back"]), _restore_tree(exp))
