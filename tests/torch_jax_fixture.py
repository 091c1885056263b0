"""The JAX side of the checkpoint bridge's tests, and the generator of the
card's fixture.

``run_case`` trains the tiny preset for 2 steps with the JAX package on the
CPU (parameters from ``init_model``, randomised as the parity tests do;
``value_and_grad`` with key=None, then the optax chain), saves the state
with ``ucnerf_tpu.train.checkpoints.save_checkpoint`` (real orbax) and
exports it with ``tools/export_jax_checkpoint.py``; then renders 64 rays
with JAX's eval step and takes one more step on a training batch, whose
next state it exports the same way.

``python tests/torch_jax_fixture.py`` (from the repository root) writes
the plain case as the fixture that ``chip_smoke.py`` imports on the card:
``tests/fixtures/jax_tiny_export.npz`` (the export of the state after 2
steps) and ``tests/fixtures/jax_tiny_expect.npz`` (the bindings, the
eval rays with their hex basis and JAX's outputs, the training batch with
its hex basis, JAX's gradient on it and its next state, as ``next/`` +
the export's keys).  ``tests/test_torch_jax_checkpoint.py`` regenerates
both and compares them with these files.

``adam_step_bound`` turns a gradient tolerance into one on Adam's next
moments and parameters; ``chip_smoke.py`` uses it too, so this module
imports numpy alone at its top (JAX inside the functions that run it).
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(ROOT, "tests", "fixtures")
EXPORT = os.path.join(FIXTURE_DIR, "jax_tiny_export.npz")
EXPECT = os.path.join(FIXTURE_DIR, "jax_tiny_expect.npz")
# The tiny preset with the dense levels' table gradient per sample (K2 on
# the card, beside K1's fused entry for the hashed levels) and a base grid
# resolution of 8 on both fields, whose first level is then dense (the
# preset's 16^3 cells overflow its hash maps, so it has no dense level);
# and the NeRF field's hash map cut from 2^12 to 2^10 rows a level, so that
# the fixture's two files (the state, and the next state with the
# gradient) stay under 2 MB.
BINDINGS = ("NerfMLP.grid_bwd_dense_sample = True",
            "PropMLP.grid_bwd_dense_sample = True",
            "NerfMLP.grid_base_resolution = 8",
            "PropMLP.grid_base_resolution = 8",
            "NerfMLP.grid_log2_hashmap_size = 10")
# The optimizer chains: plain; camera deltas in a scaled link; both clips
# (each moves Adam's entry in the chain's state).
CASES = {
    "plain": (),
    "cameras": ("Config.optimize_cameras = True", "Config.cam_lr_mult = 0.1"),
    "clipped": ("Config.grad_max_val = 0.01",
                "Config.grad_max_norm = 0.05"),
}
STEPS = 2
TRAIN_RAYS = 64
EVAL_RAYS = 64
TRAIN_FRAC = 0.5
SEED = 11


def randomize(params, rng):
    """Tables and the zero-initialised leaves (brightness output layer,
    latent codes) at scale ~0.1-1, so every parameter shapes the loss
    (``tests/test_torch_train.py``'s ``_randomize``)."""
    import jax

    def fill(path, x):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        x = np.asarray(x)
        if name.endswith("table"):
            return rng.normal(0, 0.5, x.shape).astype(np.float32)
        if "output_linear" in name or "latent_code" in name:
            return rng.normal(0, 0.3, x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(fill, params)


def ray_batch(cfg, rng, n):
    """``dummy_batch``'s layout with rays, colours and sky pixels drawn
    from `rng`."""
    from ucnerf_tpu.train import step as jstep

    b = {k: np.asarray(v) for k, v in jstep.dummy_batch(cfg, n).items()}
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    b.update(origins=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
             directions=d, viewdirs=d.copy(), cam_dirs=d.copy(),
             rgb=rng.uniform(0, 1, (n, 3)).astype(np.float32),
             sky_segs=(rng.uniform(size=n) < 0.3).astype(np.float32))
    return b


def rand_vec(n):
    """The hex basis JAX's model draws with key=None for `n` rays."""
    import jax
    import jax.numpy as jnp

    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n, 3),
                                        jnp.float32))


def export_state(state, exp):
    """Save the JAX TrainState `state` under `exp` with the JAX package's
    checkpointing (orbax) and return its export's arrays, written by
    ``tools/export_jax_checkpoint.py`` to ``exp/export.npz``."""
    import jax

    from ucnerf_tpu.train import checkpoints

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import export_jax_checkpoint

    checkpoints.save_checkpoint(exp, jax.device_get(state), int(state.step))
    out = os.path.join(exp, "export.npz")
    export_jax_checkpoint.main(["--exp", exp, "-o", out])
    with np.load(out) as data:
        return {k: data[k] for k in data.files}


# Compiled JAX functions by model bindings: (initial parameters, jitted
# gradient, eval step).
_MODELS = {}


def jax_model(bindings):
    """(config, initial parameters, jitted gradient with the captured
    pre-activations of the ReLU-fed layers, eval step) of the tiny preset
    with `bindings`, compiled once for each model."""
    import jax

    from ucnerf_tpu import configs
    from ucnerf_tpu.train import losses
    from ucnerf_tpu.train import step as jstep

    cfg = configs.load_config("tiny", bindings)
    # The clips shape the optimizer alone: cases that differ in them share
    # the model and its compiled functions.
    key = tuple(b for b in bindings if not b.startswith("Config.grad_max"))
    if key not in _MODELS:
        model, params = jstep.init_model(cfg, jax.random.PRNGKey(0))

        def loss_fn(p, b):
            (renderings, ray_history), inter = model.apply(
                {"params": p}, None, b, TRAIN_FRAC, compute_extras=False,
                train=True, capture_intermediates=_relu_fed,
                mutable=["intermediates"])
            return losses.compute_all_losses(
                b, renderings, ray_history, cfg)[0], inter["intermediates"]

        _MODELS[key] = (params, jax.jit(jax.grad(loss_fn, has_aux=True)),
                        jstep.make_eval_step(model, cfg))
    return (cfg,) + _MODELS[key]


def jax_step(cfg, grad_fn, state, batch):
    """One JAX training step of `state` on `batch` (key=None): (next
    state, gradient, captured pre-activations)."""
    import jax
    import jax.numpy as jnp

    from ucnerf_tpu.ops import hashgrid as jhash
    from ucnerf_tpu.train import state as jstate

    # The gradient runs the Pallas scatters in interpret mode, as
    # tests/test_torch_train.py does (it is traced at the first call):
    # the dense levels' table gradient then rounds the fractional
    # coordinates to bf16, as K2 does, where the CPU's default XLA
    # scatter differentiates the f32 forward.
    impl, jhash.SCATTER_IMPL = jhash.SCATTER_IMPL, "pallas_interpret"
    try:
        grads, inter = grad_fn(state.params,
                               jax.tree.map(jnp.asarray, batch))
    finally:
        jhash.SCATTER_IMPL = impl
    update = _UPDATES.get(repr(cfg))
    if update is None:
        update = _UPDATES[repr(cfg)] = jax.jit(
            jstate.create_optimizer(cfg).update)
    updates, opt_state = update(grads, state.opt_state, state.params)
    params = jax.tree.map(lambda p, u: p + u, state.params, updates)
    return state.replace(step=state.step + 1, params=params,
                         opt_state=opt_state), grads, inter


# The jitted optax update of each config, by its repr.
_UPDATES = {}


def run_case(case, folder):
    """The JAX run of `case` (a key of CASES) in `folder`: returns the
    config, the export of the state after STEPS steps (at
    ``folder/state/export.npz``) and the expectations (eval and training
    inputs and JAX's outputs) as one dict of numpy arrays."""
    import jax
    import jax.numpy as jnp

    from ucnerf_tpu.train import state as jstate
    from ucnerf_tpu_torch import convert

    bindings = BINDINGS + CASES[case]
    cfg, params, grad_fn, eval_step = jax_model(bindings)
    rng = np.random.default_rng(SEED)
    params = randomize(params, rng)
    state = jstate.create_train_state(cfg, params)

    def take_step(state, batch):
        return jax_step(cfg, grad_fn, state, batch)

    for _ in range(STEPS):
        state, _, _ = take_step(state, ray_batch(cfg, rng, TRAIN_RAYS))
    export = export_state(state, os.path.join(folder, "state"))

    expect = {"bindings": np.array(bindings), "train_frac":
              np.array(TRAIN_FRAC, np.float32)}
    eval_batch = ray_batch(cfg, rng, EVAL_RAYS)
    out = eval_step(state.params, jax.tree.map(jnp.asarray, eval_batch),
                    1.0, 0)
    expect.update({f"eval/batch/{k}": v for k, v in eval_batch.items()})
    expect["eval/rand_vec"] = rand_vec(EVAL_RAYS)
    expect.update({f"eval/out/{k}": np.asarray(v) for k, v in out.items()})

    train_batch = ray_batch(cfg, rng, TRAIN_RAYS)
    state, grads, inter = take_step(state, train_batch)
    expect.update(_near_zero(inter))
    expect.update({f"train/batch/{k}": v for k, v in train_batch.items()})
    expect["train/rand_vec"] = rand_vec(TRAIN_RAYS)
    grads = convert.flatten_tree(jax.tree.map(np.asarray, grads))
    expect.update({f"grads/{k}": v for k, v in grads.items()})
    expect.update({f"next/{k}": v for k, v in
                   export_state(state, os.path.join(folder, "next")).items()})
    return cfg, export, expect


# ReLU kinks.  Where a ReLU-fed unit's pre-activation lies within rounding
# of 0, JAX and the port can put it on opposite sides, and the ReLU passes
# that sample's gradient on one side only (tests/test_torch_grad_draws.py
# shows it; chip_smoke.py's replay_relu_branch handles it between the card
# and the CPU).  The JAX run keeps its pre-activations that lie within
# KINK_FRAC of their unit's largest |value| (``kink/<layer>/<call>/index``
# and ``.../value``), and ``jax_relu_branch`` puts the port on JAX's side
# there, at most KINK_CAP samples a unit.  The fields' ReLU-fed layers, by
# the start of their names:
RELU_FED = ("density_hidden", "lin_second_stage_")
KINK_FRAC = 1e-4
KINK_CAP = 2


def _relu_fed(module, method):
    return method == "__call__" and (module.name or "").startswith(RELU_FED)


def _near_zero(inter):
    """The kink/ arrays of the captured pre-activations `inter`."""
    from ucnerf_tpu_torch import convert

    out = {}
    for path, calls in convert.flatten_tree(inter).items():
        name = ".".join(path.split("/")[:-1])  # drop "__call__"
        for i, pre in enumerate(calls):
            pre = np.asarray(pre)
            a = pre.reshape(pre.shape[0], -1)
            near = np.abs(a) <= KINK_FRAC * np.abs(a).max(axis=1,
                                                            keepdims=True)
            index = np.flatnonzero(near).astype(np.int64)
            out[f"kink/{name}/{i}/index"] = index
            out[f"kink/{name}/{i}/value"] = a.reshape(-1)[index]
    return out


def jax_relu_branch(model, expect, kinks):
    """Forward hooks that put the port's `model` on JAX's side of every
    ReLU kink of the training batch: where a ReLU-fed layer's
    pre-activation and JAX's (the ``kink/`` arrays of `expect`) have
    opposite signs and both lie within KINK_FRAC of the unit's largest
    |value|, JAX's value replaces the port's, the gradient passing
    unchanged.  kinks[name] counts the replaced samples by unit."""
    import torch

    calls = {}

    def hook(name):
        def forward(module, args, out):
            i = calls[name] = calls.get(name, -1) + 1
            index = torch.from_numpy(expect[f"kink/{name}/{i}/index"]).to(
                out.device)
            b = torch.from_numpy(expect[f"kink/{name}/{i}/value"]).to(
                out.device, out.dtype)
            a = out.detach().reshape(out.shape[0], -1)
            unit = index // a.shape[1]
            av = a.reshape(-1)[index]
            lim = KINK_FRAC * a.abs().amax(dim=1)[unit]
            flip = ((av > 0) != (b > 0)) & (av.abs() <= lim) & (
                b.abs() <= lim)
            n = torch.bincount(unit[flip], minlength=a.shape[0]).cpu()
            kinks[name] = n if name not in kinks else kinks[name] + n
            if not bool(flip.any()):
                return out
            delta = torch.zeros_like(a).reshape(-1).index_put(
                (index[flip],), (b - av)[flip])
            return out + delta.reshape(out.shape)
        return forward

    return [module.register_forward_hook(hook(name))
            for name, module in model.named_modules()
            if name.rpartition(".")[2].startswith(RELU_FED)]


# How far a gradient leaf of one f32 implementation may lie from another's
# beyond the step tolerance: this many times the port's own f32 error
# against float64 (``chip_smoke.py``'s F64_FACTOR).  The camera deltas'
# rotation gradient is a sum over the rays with cancellation: on the plain
# case's draws with 2 steps taken, JAX's f32 gradient lies 3.80e-7 from the
# port's float64 one and the port's f32 3.80e-7 (max|grad| 9.4e-3), 4e-5 x
# max|grad|, above the step tolerance's 1e-5.
F64_FACTOR = 4.0


def f32_grad_error(model, cfg, batch, rand_vec):
    """{export key: max |f32 - float64|} of the port's loss gradient on
    `batch` (tensors) with the hex basis `rand_vec`, from CPU copies of
    `model` in float32 and float64."""
    import copy

    import torch

    from ucnerf_tpu_torch import convert
    from ucnerf_tpu_torch.train import losses

    grads = []
    for dtype in (torch.float32, torch.float64):
        m = copy.deepcopy(model).to("cpu", dtype)
        b = {k: v.to("cpu", dtype) if v.is_floating_point() else v.cpu()
             for k, v in batch.items()}
        renderings, history = m(b, TRAIN_FRAC, rand_vec.to("cpu", dtype),
                                train=True)
        losses.compute_all_losses(b, renderings, history, cfg)[0].backward()
        grads.append({n: p.grad.double() for n, p in m.named_parameters()})
    diff = {n: (grads[0][n] - grads[1][n]).abs() for n in grads[0]}
    return {k: float(v.max()) for k, v in
            convert.flatten_tree(convert.params_to_jax(diff)).items()}


def adam_step_bound(cfg, grads, grad_tol, before, after):
    """Per-entry bounds on |other - JAX| of Adam's next moments and
    parameters, for an implementation whose gradient lies within
    ``grad_tol(key, g)`` (an array of per-entry bounds) of JAX's `grads`
    (export path -> array) and which starts from the same state `before`
    (an export's arrays).  `after` is JAX's next state (same keys).

    The gradient error e goes through the chain as the JAX package takes
    it: the value clip is 1-Lipschitz; the global-norm clip scales by
    c = min(1, L / |g|), which moves by at most |e| / (|g| - |e|) (norms
    over every leaf); then Adam: dm = (1 - b1) e, dv = (1 - b2) (2 |g| e +
    e^2), both over their bias corrections, dsqrt(v) <= min(dv / 2 sqrt(v),
    sqrt(dv)), and the update m / (sqrt(v) + eps) moves by dm / (s_lo +
    eps) + |m| ds / ((s + eps) (s_lo + eps)), with s_lo = sqrt(v) - ds;
    times the learning rate (and the camera deltas' multiplier).  Each
    bound adds the optimizer's own f32 rounding (torch's Adam divides by
    sqrt(v) / sqrt(1 - b2^t) where optax takes sqrt(v / (1 - b2^t))):
    1e-6 relative, and 1e-8 for the parameters
    (``tests/test_torch_train.py``'s optimizer tolerance).

    Returns {key: bound} for every ``params/``, ``adam/mu/`` and
    ``adam/nu/`` key of `after`."""
    from ucnerf_tpu_torch.ops import mathx

    g = {k: np.asarray(v, np.float64) for k, v in grads.items()}
    e = {k: np.asarray(grad_tol(k, v), np.float64) for k, v in g.items()}
    if cfg.grad_max_val > 0:
        g = {k: np.clip(v, -cfg.grad_max_val, cfg.grad_max_val)
             for k, v in g.items()}
    if cfg.grad_max_norm > 0:
        norm = np.sqrt(sum(float(np.sum(v * v)) for v in g.values()))
        err = np.sqrt(sum(float(np.sum(v * v)) for v in e.values()))
        c = min(1.0, cfg.grad_max_norm / norm)
        if norm + err >= cfg.grad_max_norm:
            dc = err / max(norm - err, 1e-30)
            e = {k: e[k] + np.abs(g[k]) * dc for k in g}
        g = {k: v * c for k, v in g.items()}
    count = int(before["adam/count"]) + 1
    b1, b2, eps = cfg.adam_beta1, cfg.adam_beta2, cfg.adam_eps
    bc1, bc2 = 1 - b1**count, 1 - b2**count
    lr = mathx.learning_rate_decay(int(before["schedule/count"]),
                                   cfg.lr_init, cfg.lr_final, cfg.max_steps,
                                   cfg.lr_delay_steps, cfg.lr_delay_mult)
    out = {}
    for key in g:
        m = np.asarray(after[f"adam/mu/{key}"], np.float64)
        v = np.asarray(after[f"adam/nu/{key}"], np.float64)
        p = np.asarray(after[f"params/{key}"], np.float64)
        dm = (1 - b1) * e[key]
        dv = (1 - b2) * (2 * np.abs(g[key]) * e[key] + e[key] ** 2)
        out[f"adam/mu/{key}"] = dm + 1e-6 * np.abs(m)
        out[f"adam/nu/{key}"] = dv + 1e-6 * np.abs(v)
        mh, dmh = np.abs(m) / bc1, dm / bc1
        s, dvh = np.sqrt(v / bc2), dv / bc2
        with np.errstate(divide="ignore", invalid="ignore"):
            ds = np.minimum(np.where(s > 0, dvh / (2 * s), np.inf),
                            np.sqrt(dvh))
        s_lo = np.maximum(s - ds, 0)
        du = dmh / (s_lo + eps) + mh * ds / ((s + eps) * (s_lo + eps))
        mult = cfg.cam_lr_mult if key.startswith("cam_refine/") else 1.0
        out[f"params/{key}"] = lr * mult * du + 1e-6 * np.abs(p) + 1e-8
    return out


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory() as folder:
        _, export, expect = run_case("plain", folder)
    np.savez(EXPORT, **export)
    np.savez_compressed(EXPECT, **expect)
    for path in (EXPORT, EXPECT):
        print(f"wrote {path}: {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
