"""The JAX package's checkpoints on the port: a train state saved by
``ucnerf_tpu.train.checkpoints.save_checkpoint`` (real orbax) and a JAX MVS
msgpack file go through ``tools/export_jax_checkpoint.py`` and
``ucnerf_tpu_torch.cli.import_jax`` (or ``cli.mvs_depth``) into the port.

The JAX side (``torch_jax_fixture.run_case``) trains the tiny preset (its
bindings there) for 2 steps on the CPU in three optimizer chains: plain,
camera refinement with ``cam_lr_mult`` != 1, and both gradient clips; the
last two move Adam's entry in the chain's state.

Tolerances:
- the import: parameters, Adam's moments and count, the schedule's count
  and the step bitwise JAX's, after the layout change (a transpose);
- a 64-ray render of the imported state: ``tests/test_torch_model.py``'s
  rtol 1e-4, atol 1e-5;
- the next step (JAX's ``value_and_grad`` with key=None, its Pallas
  scatters in interpret mode as ``tests/test_torch_train.py`` runs them,
  and optax on the restored state, against the port's
  ``make_train_step``): the port's
  gradient lies within ``tests/test_torch_train.py``'s step tolerance of
  JAX's, rtol 1e-4 and an atol of 1e-5 x max|grad| of the leaf (2e-5 for
  the tables), plus 4 x the port's own f32 error against float64 on that
  step (``torch_jax_fixture.F64_FACTOR``: the camera deltas' gradient, a
  sum with cancellation, carries 4e-5 x max|grad| of f32 rounding on
  either side); ``torch_jax_fixture.adam_step_bound`` carries that through
  the clips and Adam to a bound on each next moment and parameter entry
  (plus the optimizer's own f32 rounding, that test's optimizer
  tolerance), and every entry must lie within it.  The port takes JAX's
  side of every ReLU kink (``torch_jax_fixture.jax_relu_branch``, at most
  2 samples a unit): on the camera case's draws one NeRF sample's
  ``density_hidden`` unit 7 sits at one (its kernel column, bias and the
  sample's table rows were 1.0e-3 x max|grad| off without it), as
  ``tests/test_torch_grad_draws.py`` shows on other draws;
- the MVS forward: ``tests/test_torch_mvs.py``'s network tolerance, rtol
  1e-4 and an atol of 1e-5 x max|disparity|.
Nothing here is skipped or loosened against those files.
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
from ucnerf_tpu_torch import configs as tconfigs
from ucnerf_tpu_torch import convert
from ucnerf_tpu_torch.cli import eval as cli_eval
from ucnerf_tpu_torch.cli import import_jax
from ucnerf_tpu_torch.cli import mvs_depth
from ucnerf_tpu_torch.cli import train as cli_train
from ucnerf_tpu_torch.train import checkpoints as tckpt
from ucnerf_tpu_torch.train import state as tstate
from ucnerf_tpu_torch.train import step as tstep

torch.set_num_threads(2)

ROOT = fx.ROOT
RENDER_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL = 1e-4
GRAD_ATOL_FRAC = {"table": 2e-5, "other": 1e-5}


def _t(x):
    return torch.from_numpy(np.array(x))


def _flags(bindings, exp):
    """The port CLIs' flags for the tiny preset with `bindings`, in `exp`,
    on the CPU."""
    out = ["--tiny", "--device", "cpu", "-b", f"Config.exp_name = {exp!r}"]
    for b in bindings:
        out += ["-b", b]
    return out


# Each case's run, made once for the module.
_RUNS = {}


def _run(name, tmp_path_factory):
    """Case `name`'s JAX run, its export imported by ``cli.import_jax``
    into a port experiment folder, and ``fresh()``: the port's train state
    restored from that folder."""
    if name not in _RUNS:
        _RUNS[name] = _import_case(name, tmp_path_factory.mktemp(name))
    return _RUNS[name]


@pytest.fixture(scope="module", params=sorted(fx.CASES))
def case(request, tmp_path_factory):
    return _run(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    return _run("plain", tmp_path_factory)


def _import_case(name, folder):
    cfg_j, export, expect = fx.run_case(name, str(folder))
    bindings = [str(b) for b in expect["bindings"]]
    port_exp = str(folder / "port")
    flags = _flags(bindings, port_exp)
    import_jax.main(flags + ["--export",
                             str(folder / "state" / "export.npz")])
    cfg = tconfigs.load_config("tiny", bindings)

    def fresh():
        model = tstep.init_model(cfg, seed=0, device="cpu")
        state, step = tckpt.restore_checkpoint(
            port_exp, tstate.create_train_state(cfg, model))
        assert step == fx.STEPS
        return state

    return dict(name=name, cfg=cfg, cfg_j=cfg_j, export=export,
                expect=expect, folder=folder, port_exp=port_exp,
                flags=flags, fresh=fresh)


def _as_export(state):
    """The port state's parameters and moments by export key."""
    return {k: v for k, v in convert.export_arrays(state).items()
            if k.startswith(("params/", "adam/mu/", "adam/nu/"))}


def _adam_step_like_torch():
    """The per-parameter ``step`` entry that torch's Adam itself creates,
    read off one real step of the port's optimizer on the CPU."""
    cfg = tconfigs.tiny()
    model = tstep.init_model(cfg, seed=0, device="cpu")
    opt = tstate.create_optimizer(cfg, model.parameters())
    opt.update()
    return opt.adam.state[next(model.parameters())]["step"]


def test_import_is_bitwise_jax(case):
    state = case["fresh"]()
    export = case["export"]
    got = _as_export(state)
    want = {k: v for k, v in export.items()
            if k.startswith(("params/", "adam/mu/", "adam/nu/"))}
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype == np.float32, key
        assert np.array_equal(got[key], value), key
    like = _adam_step_like_torch()
    count = int(export["adam/count"])
    assert count == fx.STEPS
    for p, st in state.optimizer.adam.state.items():
        assert st["step"].dtype == like.dtype
        assert st["step"].device == like.device
        assert float(st["step"]) == count
    assert state.optimizer.count == int(export["schedule/count"]) == fx.STEPS
    assert state.step == int(export["step"]) == fx.STEPS
    groups = state.optimizer.adam.param_groups
    if case["name"] == "cameras":
        # The camera deltas are Adam's second param group, at cam_lr_mult x
        # the rate of the last update.
        assert groups[1]["params"] == [state.model.cam_refine.se3_deltas]
        assert np.isclose(groups[1]["lr"], 0.1 * groups[0]["lr"])
        assert export["params/cam_refine/se3_deltas"].any()
    else:
        assert len(groups) == 1


def test_imported_render_matches_jax(case):
    state = case["fresh"]()
    expect = case["expect"]
    batch = {k[len("eval/batch/"):]: _t(v) for k, v in expect.items()
             if k.startswith("eval/batch/")}
    with torch.no_grad():
        got = tstep.make_eval_step(state.model, case["cfg"])(
            batch, 1.0, 0, _t(expect["eval/rand_vec"]))
    want = {k[len("eval/out/"):]: v for k, v in expect.items()
            if k.startswith("eval/out/")}
    assert {"rgb", "depth", "acc"} <= set(want) <= set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, err_msg=k,
                                   **RENDER_TOL)
    assert np.ptp(want["rgb"]) > 0.05 and np.ptp(want["depth"]) > 0.05


def step_grad_tol(f32_err):
    """The gradient tolerance of leaf `key`: ``tests/test_torch_train.py``'s
    step tolerance, plus F64_FACTOR x the port's own f32 error against
    float64 on the step's batch (`f32_err`, by key)."""
    def tol(key, g):
        frac = GRAD_ATOL_FRAC["table" if key.endswith("table") else "other"]
        return (GRAD_RTOL * np.abs(g) + frac * np.abs(g).max()
                + fx.F64_FACTOR * f32_err[key])
    return tol


def test_imported_step_matches_jax(case):
    """The next step from the imported state against JAX's, within the
    bound the gradient tolerance gives each entry; the bound is tight
    enough to see a wrong update (below 1 % of the step's change on most
    moved entries)."""
    state = case["fresh"]()
    expect, export = case["expect"], case["export"]
    cfg = case["cfg"]
    batch = {k[len("train/batch/"):]: _t(v) for k, v in expect.items()
             if k.startswith("train/batch/")}
    assert cfg.microbatches == 1
    f32_err = fx.f32_grad_error(state.model, cfg, batch,
                                _t(expect["train/rand_vec"]))
    kinks = {}
    hooks = fx.jax_relu_branch(state.model, expect, kinks)
    try:
        new_state, _ = tstep.make_train_step(state.model, cfg)(
            state, batch, float(expect["train_frac"]),
            rand_vec=_t(expect["train/rand_vec"]))
    finally:
        for h in hooks:
            h.remove()
    assert len(kinks) == 4
    assert max(int(n.max()) for n in kinks.values()) <= fx.KINK_CAP, kinks
    assert sum(int(n.sum()) for n in kinks.values()) == (
        case["name"] == "cameras"), kinks
    after = {k[len("next/"):]: v for k, v in expect.items()
             if k.startswith("next/")}
    grads = {k[len("grads/"):]: v for k, v in expect.items()
             if k.startswith("grads/")}
    bound = fx.adam_step_bound(cfg, grads, step_grad_tol(f32_err),
                                export, after)
    got = _as_export(new_state)
    assert set(got) == set(bound)
    ratios, tight = [], []
    for key, b in bound.items():
        err = np.abs(got[key].astype(np.float64) - after[key])
        assert (err <= b).all(), (key, float((err / b).max()))
        ratios.append(float((err / b).max()))
        if key.startswith("params/"):
            moved = np.abs(after[key] - export[key].astype(np.float64))
            tight.append((b[moved > 0] < 1e-2 * moved[moved > 0]).mean())
    assert max(ratios) > 0
    assert np.median(tight) > 0.5, tight
    assert new_state.step == int(after["step"]) == fx.STEPS + 1
    assert new_state.optimizer.count == int(after["schedule/count"])
    for st in new_state.optimizer.adam.state.values():
        assert float(st["step"]) == int(after["adam/count"])
    if case["name"] == "clipped":
        # Both clips bite: the value clip, then the global norm.
        g = np.concatenate([v.ravel() for v in grads.values()])
        assert np.abs(g).max() > cfg.grad_max_val
        norm = np.linalg.norm(np.clip(g, -cfg.grad_max_val,
                                      cfg.grad_max_val))
        assert norm > cfg.grad_max_norm


def test_export_round_trips_bitwise(case, tmp_path):
    """The port's export of the imported state equals the JAX export,
    and port -> export -> port is bitwise, moments, counts and learning
    rates included."""
    state = case["fresh"]()
    path = tmp_path / "port.npz"
    convert.state_to_export(state, path)
    again = convert.load_export(path, "nerf")
    want = case["export"]
    assert set(again) == set(want)
    for key, value in want.items():
        assert again[key].dtype == value.dtype, key
        assert np.array_equal(again[key], value), key
    other = tstate.create_train_state(
        case["cfg"], tstep.init_model(case["cfg"], seed=1, device="cpu"))
    other = convert.state_from_export(again, other)
    assert _as_export(other).keys() == _as_export(state).keys()
    for key, value in _as_export(state).items():
        assert np.array_equal(_as_export(other)[key], value), key
    assert (other.step, other.optimizer.count) == (
        state.step, state.optimizer.count)
    assert [g["lr"] for g in other.optimizer.adam.param_groups] == [
        g["lr"] for g in state.optimizer.adam.param_groups]


def test_fixture_is_current(plain):
    """The committed fixture of ``chip_smoke.py`` is the plain case's
    export and expectations, regenerated here (1e-6 relative), 2 MB at
    most."""
    assert os.path.getsize(fx.EXPORT) + os.path.getsize(fx.EXPECT) \
        <= 2 * 2**20
    for path, arrays in ((fx.EXPORT, plain["export"]),
                         (fx.EXPECT, plain["expect"])):
        with np.load(path) as data:
            assert set(data.files) == set(arrays), path
            for key in data.files:
                if arrays[key].dtype.kind in "iuU":
                    assert np.array_equal(data[key], arrays[key]), key
                else:
                    np.testing.assert_allclose(data[key], arrays[key],
                                               rtol=1e-6, atol=0,
                                               err_msg=key)


def _strict_case(case, mutate):
    """state_from_export on a mutated copy of the export: the error, and
    whether the model and optimizer were left as they were."""
    export = dict(case["export"])
    mutate(export)
    state = tstate.create_train_state(
        case["cfg"], tstep.init_model(case["cfg"], seed=0, device="cpu"))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    with pytest.raises(ValueError) as err:
        convert.state_from_export(export, state)
    untouched = (all(torch.equal(v, state.model.state_dict()[k])
                     for k, v in before.items())
                 and not state.optimizer.adam.state
                 and state.optimizer.count == 0)
    return str(err.value), untouched


_KERNEL = "nerf_mlp/density_out/kernel"
# Mutations of an export, and what the error must name.
STRICT = {
    "missing_param": (lambda e: e.pop(f"params/{_KERNEL}"),
                      f"missing params/{_KERNEL}"),
    "extra_moment": (lambda e: e.__setitem__("adam/mu/nerf_mlp/extra/bias",
                                             np.zeros(3, np.float32)),
                     "unexpected adam/mu/nerf_mlp/extra/bias"),
    "moment_shape": (lambda e: e.__setitem__(
        f"adam/nu/{_KERNEL}", e[f"adam/nu/{_KERNEL}"][:, :-1]),
        f"adam/nu/{_KERNEL}: shape"),
    "missing_count": (lambda e: e.pop("schedule/count"), "schedule/count"),
    "extra_key": (lambda e: e.__setitem__("junk", np.zeros(1)), "junk"),
}


@pytest.mark.parametrize("mutation", sorted(STRICT))
def test_import_is_strict(plain, mutation):
    """A removed key, an extra key or a wrong shape raises, naming it, and
    leaves the model and optimizer as they were."""
    mutate, named = STRICT[mutation]
    msg, untouched = _strict_case(plain, mutate)
    assert named in msg and untouched, msg


def test_exporter_refuses_an_unknown_chain():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import export_jax_checkpoint as exporter

    adam = {"count": 1, "mu": {}, "nu": {}}
    assert exporter.split_opt_state(
        [None, None, adam, None, {"count": 1}, None])[1] == 1
    for chain in ([None, adam, None], [None, {"count": 1}, adam],
                  [None, adam, {"count": 1}, {"count": 1}],
                  [adam, {"count": 1}, {"scale": 2.0}], {"count": 1}):
        with pytest.raises(ValueError, match="unexpected optimizer state"):
            exporter.split_opt_state(chain)


def test_cli_eval_and_resume_after_import(plain, tmp_path):
    """``cli.eval`` renders the imported scene, and ``cli.train`` resumes
    from it ("resumed from step 2") and ends at ``max_steps``."""
    case = plain
    exp = str(tmp_path / "exp")
    shutil.copytree(case["port_exp"], exp)
    bindings = [str(b) for b in case["expect"]["bindings"]]
    cli_eval.main(_flags(bindings, exp) + ["--limit", "1"])
    assert os.path.exists(os.path.join(exp, f"psnr_{fx.STEPS}.txt"))
    cli_train.main(_flags(bindings, exp) + [
        "--max-steps", str(fx.STEPS + 2), "-b", "Config.print_every = 1",
        "-b", "Config.train_render_every = 0"])
    log = open(os.path.join(exp, "log_train.txt")).read()
    assert f"resumed from step {fx.STEPS}" in log
    assert f"step {fx.STEPS + 2}/{fx.STEPS + 2}" in log
    assert tckpt.latest_checkpoint_step(exp) == fx.STEPS + 2
    log = open(os.path.join(exp, "log_import.txt")).read()
    assert f"imported step {fx.STEPS}" in log and "parameters" in log


def test_cli_refuses_and_explains_jax_checkpoints(plain, tmp_path):
    """The importer refuses a folder holding a JAX checkpoint at the
    export's step (which survives), and the port's ``cli.eval`` on a JAX
    folder names the exporter and the importer."""
    case = plain
    jax_exp = str(case["folder"] / "state")
    ckpt = os.path.join(jax_exp, "checkpoints", str(fx.STEPS))
    files = sorted(os.listdir(ckpt))
    bindings = [str(b) for b in case["expect"]["bindings"]]
    with pytest.raises(ValueError, match="holds a JAX checkpoint"):
        import_jax.main(_flags(bindings, jax_exp) + [
            "--export", os.path.join(jax_exp, "export.npz")])
    assert sorted(os.listdir(ckpt)) == files
    assert "_CHECKPOINT_METADATA" in files
    with pytest.raises(ValueError, match="export_jax_checkpoint.py.*"
                                         "ucnerf_tpu_torch.cli.import_jax"):
        cli_eval.main(_flags(bindings, jax_exp))
    # A later checkpoint in the folder would shadow the import.
    later = str(tmp_path / "later")
    shutil.copytree(case["port_exp"], later)
    os.rename(os.path.join(later, "checkpoints", str(fx.STEPS)),
              os.path.join(later, "checkpoints", str(fx.STEPS + 5)))
    with pytest.raises(ValueError, match="later than"):
        import_jax.main(_flags(bindings, later) + [
            "--export", os.path.join(jax_exp, "export.npz")])


def test_exporter_imports_no_torch(plain, tmp_path):
    """The exporter runs with torch unimportable and writes what it wrote
    in this process."""
    case = plain
    out = tmp_path / "again.npz"
    code = (
        "import sys\n"
        "sys.modules['torch'] = None\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'tools')!r})\n"
        "import export_jax_checkpoint\n"
        f"export_jax_checkpoint.main(['--exp', "
        f"{str(case['folder'] / 'state')!r}, '-o', {str(out)!r}])\n"
        "assert sys.modules['torch'] is None\n"
        "assert not [m for m in sys.modules if m.startswith('torch.')]\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    with np.load(out) as data:
        assert set(data.files) == set(case["export"])
        for key in data.files:
            assert np.array_equal(data[key], case["export"][key]), key


def _mvs_export(tmp_path, params):
    """`params` written as ``cli.mvs_train --out`` writes them
    (``to_bytes``), then exported: the npz's path."""
    from flax.serialization import to_bytes

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import export_jax_checkpoint as exporter

    msgpack = tmp_path / "params.msgpack"
    msgpack.write_bytes(to_bytes(params))
    npz = tmp_path / "mvs.npz"
    exporter.main(["--mvs", str(msgpack), "-o", str(npz)])
    return str(npz)


def test_mvs_msgpack_loads_strictly_at_full_width(tmp_path):
    """The JAX CLIs' full-width ``RAFTMVS`` tree (shapes from its init,
    random values), exported, loads strictly into ``cli.mvs_depth``'s
    model, every tensor bitwise in place; a missing leaf names itself."""
    from ucnerf_tpu.models.mvs import raft as jraft
    from ucnerf_tpu_torch.models.mvs import datasets as tdatasets

    images, poses, intr, _ = tdatasets.SyntheticMVSWindows(
        num_views=5).window(0)
    shapes = jax.eval_shape(jraft.RAFTMVS().init, jax.random.PRNGKey(0),
                            images[:, :32, :48], poses, intr)
    rng = np.random.default_rng(5)
    params = jax.tree.map(
        lambda s: rng.normal(0, 0.1, s.shape).astype(np.float32), shapes)
    npz = _mvs_export(tmp_path, params)
    model = mvs_depth.load_model(npz, "HR", "cpu")
    want = convert.params_from_jax(params["params"])
    got = model.state_dict()
    assert set(got) == set(want) and len(want) > 50
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    export = convert.load_export(npz, "mvs")
    del export["params/fnet/conv1/kernel"]
    bad = tmp_path / "bad.npz"
    np.savez(bad, **export)
    with pytest.raises(RuntimeError, match="Missing key.*fnet.conv1.weight"):
        mvs_depth.load_model(str(bad), "HR", "cpu")
    with pytest.raises(ValueError, match="kind 'mvs', expected 'nerf'"):
        convert.load_export(npz, "nerf")


def test_mvs_export_forward_matches_jax(tmp_path, monkeypatch):
    """A tiny JAX ``RAFTMVS`` init (the ``--tiny`` cascade of
    ``cli.mvs_train``), exported and loaded by ``cli.mvs_depth``'s
    ``load_model`` (built at that cascade here), runs the forward JAX runs
    (``tests/test_torch_mvs.py``'s network tolerance; the full cascade's 16
    iterations amplify f32 rounding past it)."""
    import functools

    from ucnerf_tpu.models.mvs import raft as jraft
    from ucnerf_tpu_torch.cli import mvs_train
    from ucnerf_tpu_torch.models.mvs import datasets as tdatasets
    from ucnerf_tpu_torch.models.mvs import raft as traft

    images, poses, intr, _ = tdatasets.SyntheticMVSWindows(
        num_views=5).window(0)
    images = np.ascontiguousarray(images[:, :32, :48])
    model = jraft.RAFTMVS(**mvs_train.TINY)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), images, poses, intr)
    # Move the zero-initialised leaves off zero, so every leaf shapes the
    # output.
    rng = np.random.default_rng(3)

    def off_zero(x):
        x = np.asarray(x)
        return x if x.any() else rng.normal(0, 1e-2, x.shape).astype(
            np.float32)

    params = jax.tree.map(off_zero, params)
    npz = _mvs_export(tmp_path, params)
    want = np.asarray(jax.jit(model.apply)(params, images, poses, intr))
    monkeypatch.setattr(traft, "RAFTMVS", functools.partial(
        traft.RAFTMVS, **mvs_train.TINY))
    port = mvs_depth.load_model(npz, "HR", "cpu")
    with torch.no_grad():
        got = port(_t(images), _t(poses), _t(intr)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))
