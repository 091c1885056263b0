"""Camera refinement through the real field on a miscalibrated rig (port of
``tools/cam_refine_quality.py``).

Trains the REAL UCNeRF model on the synthetic scene with a deliberately
miscalibrated rig and records the rig error left after training and the
test PSNR, for each arm:

- ``off``: no camera refinement;
- ``on``: the per-camera se(3) deltas train with the field;
- ``on_og``: the same with ``contract_origin_grads``, so the sample
  positions carry a gradient and the translation half of the deltas is
  learnable.

Setup: the synthetic views alternate between two rig slots (view % 2).
Camera 1's poses are perturbed by a fixed rigid Delta before ray
generation; the supervision images stay rendered from the TRUE poses (an
under-calibrated rig: the rays do not point where the pixels say).  Camera
0 anchors the gauge.  With refinement on, the deltas should converge so
that Exp(xi_0)^-1 Exp(xi_1) Delta ~ identity (``residual_error``), and the
test PSNR should beat the frozen-pose run.  Bindings apply to every arm:
``-b "Config.virtual_poses = True"`` adds a virtual fifth to each batch,
``-b "NerfMLP.hex_single_query = True"`` (and ``PropMLP.``) the
single-query encoding.

The host side draws what the JAX tool draws, bit for bit: the same
datasets, the perturbation applied to both splits before the first batch
(so the lazily built correspondence pool of the virtual views sees the
perturbed poses) and the batch stream ``np.random.default_rng(1234 +
seed)``.  The keyed draws of each step (jitter, hex patterns) come from a
``torch.Generator`` on the device seeded from ``(5678 + seed, step)`` as
``cli/train.py`` seeds its own; the JAX tool folds the step into
``PRNGKey(5678 + seed)``, which draws other numbers, so the two tools'
runs agree in distribution, not value by value.

Each arm's JSON line adds to the JAX tool's keys the training's wall
seconds and steps/s, and the kernel launches of the training by entry
point (zero on the CPU, where every wrapper runs its plain version).  The
log lines of the arms with refinement also print the residual rig error.

Usage:
  python -m ucnerf_tpu_torch.tools.cam_refine_quality --device cpu \
      --steps 4 --arms off,on_og              # CPU-scale smoke
  python -m ucnerf_tpu_torch.tools.cam_refine_quality \
      --preset synthetic_quality --steps 1500 --rot-deg 1.0 --trans 0.03 \
      -b "NerfMLP.hex_single_query = True" \
      -b "PropMLP.hex_single_query = True" --arms off,on,on_og
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

# The kernel wrappers' launch counters: (module under ucnerf_tpu_torch.ops,
# entry point).
KERNEL_ENTRIES = (("gather", "take_cm"), ("gather", "take_wsum_cm"),
                  ("scatter", "scatter_add_cm"),
                  ("scatter", "scatter_add_wsum_cm"),
                  ("scatter", "scatter_add_dense_cm"),
                  ("scatter", "scatter_add_packed_cm"),
                  ("scatter", "scatter_add_wsum_packed_cm"),
                  ("scatter", "scatter_add_chunked_cm"),
                  ("scatter", "run_starts"))


def _rigid(rot_deg, trans):
    from scipy.spatial.transform import Rotation

    m = np.eye(4, dtype=np.float32)
    axis = np.array([0.3, 1.0, 0.2])
    axis /= np.linalg.norm(axis)
    m[:3, :3] = Rotation.from_rotvec(
        np.radians(rot_deg) * axis).as_matrix()
    m[:3, 3] = trans
    return m


def _perturb(ds, delta):
    sel = (np.arange(ds.n_examples) % 2) == 1
    ds.camtoworlds = ds.camtoworlds.copy()
    ds.camtoworlds[sel] = (delta[None] @ ds.camtoworlds[sel]).astype(
        np.float32)
    return ds


def residual_error(se3_deltas, delta):
    """Residual relative miscalibration after refinement: the rig-relative
    transform Exp(xi_0)^-1 Exp(xi_1) Delta should be identity.  Returns
    (rotation in degrees, translation norm).  The rotations come from the
    port's ``so3_exp`` in float32, as the JAX tool's do."""
    import torch
    from scipy.spatial.transform import Rotation

    from ucnerf_tpu_torch.models import cam_refine

    def exp(xi):
        m = np.eye(4)
        m[:3, :3] = cam_refine.so3_exp(torch.as_tensor(
            np.asarray(xi[:3]), dtype=torch.float32)).numpy()
        m[:3, 3] = xi[3:]
        return m

    fix0 = exp(np.asarray(se3_deltas[0]))
    fix1 = exp(np.asarray(se3_deltas[1]))
    resid = np.linalg.inv(fix0) @ fix1 @ delta
    rot = np.degrees(np.linalg.norm(
        Rotation.from_matrix(resid[:3, :3]).as_rotvec()))
    return rot, float(np.linalg.norm(resid[:3, 3]))


def reset_launches():
    from ucnerf_tpu_torch.ops import gather, scatter

    mods = {"gather": gather, "scatter": scatter}
    for mod, name in KERNEL_ENTRIES:
        getattr(mods[mod], name).launches = 0


def read_launches():
    """Launches of each kernel entry point since ``reset_launches``."""
    from ucnerf_tpu_torch.ops import gather, scatter

    mods = {"gather": gather, "scatter": scatter}
    return {name: getattr(mods[mod], name).launches
            for mod, name in KERNEL_ENTRIES}


@dataclasses.dataclass
class Arm:
    """One arm's setup: its config, the perturbed datasets, the model and
    its train state, and the seed of its draws."""
    cfg: object
    train: object
    test: object
    model: object
    state: object
    seed: int
    device: object


def setup(cfg, delta, steps, optimize, seed=0, origin_grads=False,
          device="cuda"):
    """The arm's config (camera refinement as asked, two rig slots,
    `steps` as the schedule's length), its train and test datasets with
    camera 1 perturbed by `delta`, and a model with weights from `seed`."""
    import torch

    from ucnerf_tpu_torch.data import datasets
    from ucnerf_tpu_torch.train import state as state_lib
    from ucnerf_tpu_torch.train import step as step_lib

    device = torch.device(device)
    cfg = dataclasses.replace(cfg, optimize_cameras=optimize,
                              num_phys_cams=2, max_steps=steps,
                              contract_origin_grads=origin_grads)
    train = datasets.load_dataset("train", cfg)
    test = datasets.load_dataset("test", cfg)
    for ds in (train, test):
        ds.cam_num = 2  # alternate views across two logical rig slots
        _perturb(ds, delta)
    model = step_lib.init_model(cfg, seed=seed, device=device)
    state = state_lib.create_train_state(cfg, model)
    return Arm(cfg, train, test, model, state, seed, device)


def train(arm, steps, log_every=0, delta=None, draws=None):
    """`steps` training steps on the arm's batch stream.  Each step's
    keyword draws for the train step are ``draws(step, batch)`` (e.g.
    ``{"rand_vec": ...}``), by default a device generator seeded from
    ``(5678 + seed, step)``.  With `delta` the log lines also print the
    residual rig error.  Returns the last step's stats."""
    import torch

    from ucnerf_tpu_torch.cli.train import _step_seed
    from ucnerf_tpu_torch.train import step as step_lib

    cfg = arm.cfg
    train_step = step_lib.make_train_step(arm.model, cfg)
    rng = np.random.default_rng(1234 + arm.seed)
    generator = torch.Generator(device=arm.device)
    stats = None
    t0 = time.time()
    for step in range(1, steps + 1):
        batch = step_lib.batch_to_device(
            arm.train.sample_batch(rng, cfg.batch_size), arm.device)
        frac = float(np.clip((step - 1) / max(steps - 1, 1), 0, 1))
        if draws is None:
            generator.manual_seed(_step_seed(5678 + arm.seed, step))
            kwargs = {"generator": generator}
        else:
            kwargs = draws(step, batch)
        arm.state, stats = train_step(arm.state, batch, frac, **kwargs)
        if log_every and step % log_every == 0:
            line = f"  step {step}: loss={float(stats['loss']):.4f}"
            if delta is not None and cfg.optimize_cameras:
                rot, tr = residual_error(se3_deltas(arm), delta)
                line += f" residual={rot:.4f}deg/{tr:.5f}"
            print(f"{line} ({time.time() - t0:.0f}s)", flush=True)
    return stats


def se3_deltas(arm):
    return arm.model.cam_refine.se3_deltas.detach().cpu().numpy()


def evaluate(arm):
    """PSNR of every test view, rendered with ``eval_camidx`` = the view's
    index (as the JAX tool renders them), so the learned delta of camera 1
    moves its test rays."""
    from ucnerf_tpu_torch.train import step as step_lib
    from ucnerf_tpu_torch.utils import image as image_lib

    eval_step = step_lib.make_eval_step(arm.model, arm.cfg,
                                        compute_extras=False)
    psnrs = []
    for i in range(arm.test.n_examples):
        rendering = step_lib.render_image(eval_step, arm.test.image_batch(i),
                                          arm.cfg, train_frac=1.0,
                                          eval_camidx=i)
        mse = float(np.mean((rendering["rgb"] - arm.test.images[i]) ** 2))
        psnrs.append(float(image_lib.mse_to_psnr(mse)))
    return psnrs


def run(cfg, delta, steps, optimize, seed=0, log_every=0,
        origin_grads=False, device="cuda"):
    import torch

    arm = setup(cfg, delta, steps, optimize, seed=seed,
                origin_grads=origin_grads, device=device)
    cuda = arm.device.type == "cuda"
    reset_launches()
    t0 = time.time()
    stats = train(arm, steps, log_every=log_every, delta=delta)
    if cuda:
        torch.cuda.synchronize(arm.device)
    secs = time.time() - t0
    launches = read_launches()
    psnrs = evaluate(arm)

    out = dict(optimize=optimize, steps=steps,
               train_loss=float(stats["loss"]),
               psnr_mean=float(np.mean(psnrs)), psnr=psnrs,
               train_seconds=secs, steps_per_s=steps / secs,
               launches=launches)
    if optimize:
        se3 = se3_deltas(arm)
        rot, tr = residual_error(se3, delta)
        out.update(residual_rot_deg=rot, residual_trans=tr,
                   se3_deltas=se3.tolist())
    return out


ARMS = {
    "off": dict(optimize=False),
    "on": dict(optimize=True),
    # Origin gradients opened so the translation is learnable
    # (Config.contract_origin_grads).
    "on_og": dict(optimize=True, origin_grads=True),
}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--preset", default=None,
                        help="config preset; default = CPU-scale smoke")
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--rot-deg", type=float, default=1.0)
    parser.add_argument("--trans", type=float, default=0.02)
    parser.add_argument("--binding", "-b", action="append", default=[])
    parser.add_argument("--log-every", type=int, default=100)
    parser.add_argument("--arms", default="off,on",
                        help="comma list from {off, on, on_og} (on_og = "
                             "refinement + contract_origin_grads)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda | cpu)")
    args = parser.parse_args(argv)

    from ucnerf_tpu_torch import configs
    from ucnerf_tpu_torch.cli import common

    device = common.resolve_device(args.device)
    if args.preset:
        cfg = configs.load_config(args.preset, args.binding)
    else:
        cfg = configs.parse_bindings(
            configs.tiny(training_views=12, batch_size=256), args.binding)

    delta = _rigid(args.rot_deg, [args.trans, -args.trans, args.trans / 2])
    rot0 = args.rot_deg
    tr0 = float(np.linalg.norm([args.trans, -args.trans, args.trans / 2]))
    print(f"injected miscalibration: rot={rot0:.2f} deg trans={tr0:.4f}")
    if device.type == "cuda":
        import torch
        print(f"device: {torch.cuda.get_device_name(device)}")

    arms = [a.strip() for a in args.arms.split(",")]
    unknown = [a for a in arms if a not in ARMS]
    if unknown:
        parser.error(f"unknown arms {unknown}; choose from {list(ARMS)}")
    results = {}
    for name in arms:
        print(f"--- refine_{name}", flush=True)
        results[name] = run(cfg, delta, args.steps, log_every=args.log_every,
                            device=device, **ARMS[name])
        print(json.dumps({k: v for k, v in results[name].items()
                          if k != "se3_deltas"}), flush=True)

    summary = {"injected_rot_deg": rot0, "injected_trans": tr0}
    for name in arms:
        r = results[name]
        summary[f"psnr_{name}"] = round(r["psnr_mean"], 3)
        if r.get("residual_rot_deg") is not None:
            summary[f"residual_rot_deg_{name}"] = round(
                r["residual_rot_deg"], 4)
            summary[f"residual_trans_{name}"] = round(r["residual_trans"], 5)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
