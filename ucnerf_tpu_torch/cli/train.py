"""Training CLI (port of ``ucnerf_tpu/cli/train.py``): the reference's train
loop, on one card or data-parallel over processes.

One train step per iteration; the host does only ray sampling and logging.
Per-``print_every`` stats (loss breakdown, rays/s over the steps since the
last log line, test renders and saves in between included), per-
``train_render_every`` test render with PSNR and SSIM, per-
``checkpoint_every`` checkpoints (``torch.save``) with keep-last-N and
resume.

Usage:
  python -m ucnerf_tpu_torch.cli.train --preset waymo \
      -b "Config.data_dir = '/path/to/segment'" \
      -b "Config.exp_name = 'checkpoints/run1'"
  python -m ucnerf_tpu_torch.cli.train --preset synthetic_quality \
      -b 'NerfMLP.grid_bwd_value_dtype = "bfloat16"' \
      -b 'PropMLP.grid_bwd_value_dtype = "bfloat16"'
  python -m ucnerf_tpu_torch.cli.train --tiny --device cpu   # smoke run
  torchrun --nproc-per-node 8 -m ucnerf_tpu_torch.cli.train --multihost \
      --preset waymo -b "Config.exp_name = '...'"   # one rank per card

Every step draws its ray batch from
``np.random.default_rng((1234, step, rank))`` and its jitter and hex
patterns from a ``torch.Generator`` seeded from ``(5678, step, rank)``
(rank 0 on one process, where these are the ``(1234, step)`` and
``(5678, step)`` draws: numpy pads the entropy with zeros), so a run resumed from a checkpoint takes the steps an
uninterrupted run would have taken, bit for bit on one device; the test
renders draw their hex basis from the chunk's size alone
(``step.make_eval_step``), so they and their PSNR match too.  (The JAX
loop folds the step into its device key the same way, but seeds one host
stream from ``1234 + init_step``, so its resumed runs draw other batches.)

With ``--multihost`` (under torchrun) each of W ranks draws its own
batch_size / W rays and patterns from those seeds (the JAX loop folds the
process index into its host seed), the gradients are averaged over the
ranks in the step, and only rank 0 writes the log file, TensorBoard and
checkpoints.  W must divide batch_size, and so must the microbatch count;
a rank's batch_size / W rays need not split into the microbatches, as each
rank takes a floor or ceil share of every global microbatch
(``step.microbatch_shares``): ``--preset waymo`` on 8 cards runs its
10 microbatches of 1500 rays as shares of 187 and 188 a rank.  Every rank
reads the checkpoint it resumes from, and rank 0's parameters are
broadcast after it.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np


def _step_seed(*entropy: int) -> int:
    """A 63-bit seed mixed from the entropy words.  numpy's SeedSequence
    pads its entropy with zeros, so (base, step, 0) mixes what (base, step)
    mixes: rank 0's seeds are the ones a single process drew before ranks
    had a seed word."""
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def main(argv=None):
    from ucnerf_tpu_torch.cli import common

    parser = common.make_parser(__doc__)
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--profile-steps", type=int, default=0,
                        help="capture a torch.profiler trace over N steps: "
                             "the kernels and the ucnerf.* spans (written "
                             "to <exp>/profile/trace.json)")
    parser.add_argument("--multihost", action="store_true",
                        help="train data-parallel over the processes "
                             "torchrun started (parallel/mesh.py)")
    common.add_device_arg(parser)
    common.add_dist_args(parser)
    args = parser.parse_args(argv)
    config = common.load_config_from_args(args)
    if args.max_steps is not None:
        config = dataclasses.replace(config, max_steps=args.max_steps)

    from ucnerf_tpu_torch.parallel import mesh

    if mesh.launched() and not args.multihost:
        raise RuntimeError(
            f"WORLD_SIZE={os.environ['WORLD_SIZE']} without --multihost: "
            f"that many independent runs would write one experiment "
            f"folder; pass --multihost to train data-parallel")
    device, group = common.join_processes(args, args.multihost)
    exp, logger = common.setup_experiment(config, "train")
    common.log_processes(device, group, logger)
    rank, world = mesh.rank(group), mesh.world_size(group)
    main_process = rank == 0

    import torch

    from ucnerf_tpu_torch.cli.eval import _eval_camidx
    from ucnerf_tpu_torch.data import datasets
    from ucnerf_tpu_torch.train import checkpoints as ckpt_lib
    from ucnerf_tpu_torch.train import state as state_lib
    from ucnerf_tpu_torch.train import step as step_lib
    from ucnerf_tpu_torch.utils import image as image_lib

    if config.batch_size % world:
        raise ValueError(f"batch_size {config.batch_size} must divide "
                         f"evenly across {world} processes")
    local_batch_size = config.batch_size // world

    dataset = datasets.load_dataset("train", config)
    test_dataset = datasets.load_dataset("test", config)
    logger.info("train views: %d, test views: %d, %dx%d",
                dataset.n_examples, test_dataset.n_examples,
                dataset.width, dataset.height)

    if (config.brightness_correction
            and dataset.n_examples > config.training_views):
        # Each training view owns a brightness latent; too few latents would
        # alias views onto clamped indices.
        raise ValueError(
            f"brightness_correction: {dataset.n_examples} training views "
            f"but Config.training_views={config.training_views}; raise "
            f"training_views to at least the train-split size.")

    if config.optimize_cameras and dataset.cam_num > config.num_phys_cams:
        raise ValueError(
            f"optimize_cameras: dataset has {dataset.cam_num} physical "
            f"cameras but Config.num_phys_cams={config.num_phys_cams}; set "
            f"num_phys_cams={dataset.cam_num} (e.g. cam_type=7 -> 5).")

    model = step_lib.init_model(config, seed=0, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("parameters: %.2fM", n_params / 1e6)

    state = state_lib.create_train_state(config, model)
    init_step = 0
    if config.resume_from_checkpoint:
        state, init_step = ckpt_lib.restore_checkpoint(exp, state)
        if init_step:
            logger.info("resumed from step %d", init_step)
    # The replicas start equal: rank 0's parameters, after init or resume.
    mesh.broadcast_parameters(model, group)

    train_step = step_lib.make_train_step(model, config, group)
    eval_step = step_lib.make_eval_step(model, config)
    metric_harness = image_lib.MetricHarness()

    # TensorBoard scalars/images, when tensorboardX is installed.
    writer = None
    if main_process:
        try:
            from tensorboardX import SummaryWriter
            writer = SummaryWriter(exp)
        except ImportError:
            pass

    def save(step):
        if main_process:
            ckpt_lib.save_checkpoint(exp, state, step,
                                     config.checkpoints_total_limit)
        mesh.barrier(group)

    generator = torch.Generator(device=device)
    profiler = None
    profile_start = init_step + 5  # skip the warm-up steps
    profile_stop = profile_start + args.profile_steps
    t_start = time.perf_counter()
    t_window = time.perf_counter()
    window_start = init_step  # the last step of the previous log window
    try:
        for step in range(init_step + 1, config.max_steps + 1):
            if args.profile_steps and main_process \
                    and step == profile_start:
                # Trace steady-state steps: the trace shows where each
                # step's time goes.
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU]
                if device.type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                profiler = profile(activities=acts)
                profiler.start()
            if profiler is not None and step == profile_stop:
                profiler = _stop_profiler(profiler, exp, logger)
            batch = step_lib.batch_to_device(dataset.sample_batch(
                np.random.default_rng((1234, step, rank)),
                local_batch_size), device)
            train_frac = float(np.clip(
                (step - 1) / max(config.max_steps - 1, 1), 0, 1))
            generator.manual_seed(
                _step_seed(5678, step, rank))
            state, stats = train_step(state, batch, train_frac,
                                      generator=generator)

            if step % config.print_every == 0 or step == init_step + 1:
                loss = float(stats["loss"])
                losses = {k: float(v) for k, v in stats["losses"].items()}
                dt = time.perf_counter() - t_window
                t_window = time.perf_counter()
                # The window after a start or a resume holds fewer steps
                # than print_every: the rate counts the steps it holds.
                steps_per_sec = (step - window_start) / max(dt, 1e-9)
                window_start = step
                rays_per_sec = config.batch_size * steps_per_sec
                psnr = float(image_lib.mse_to_psnr(
                    float(stats["mses"][-1])))
                loss_str = " ".join(f"{k}={v:.4f}"
                                    for k, v in sorted(losses.items()))
                logger.info(
                    "step %d/%d: loss=%.4f psnr=%.2f %.0f rays/s (%s)",
                    step, config.max_steps, loss, psnr, rays_per_sec,
                    loss_str)
                if writer is not None:
                    writer.add_scalar("train_loss", loss, step)
                    writer.add_scalar("train_psnr", psnr, step)
                    writer.add_scalar("train_rays_per_sec", rays_per_sec,
                                      step)
                    writer.add_scalar(
                        "learning_rate",
                        state.optimizer.adam.param_groups[0]["lr"], step)
                    for k, v in losses.items():
                        writer.add_scalar(f"train_losses/{k}", v, step)

            if (config.train_render_every > 0
                    and step % config.train_render_every == 0):
                idx = (step // config.train_render_every) % \
                    test_dataset.n_examples
                img_batch = test_dataset.image_batch(idx)
                t0 = time.perf_counter()
                # Test-index -> training-latent remap for the brightness
                # correction.
                rendering = step_lib.render_image(
                    eval_step, img_batch, config,
                    train_frac=train_frac,
                    eval_camidx=_eval_camidx(config, idx,
                                             test_dataset.cam_num),
                    group=group)
                if main_process:
                    _log_test_render(metric_harness, rendering, img_batch,
                                     idx, step, time.perf_counter() - t0,
                                     logger, writer)

            if step % config.checkpoint_every == 0:
                save(step)
                logger.info("checkpoint saved at step %d", step)
    finally:
        if profiler is not None:
            _stop_profiler(profiler, exp, logger)
        if writer is not None:
            writer.close()

    save(config.max_steps)
    logger.info("done in %.1fs", time.perf_counter() - t_start)
    if group is not None:
        mesh.shutdown()


def _log_test_render(metric_harness, rendering, img_batch, idx, step, secs,
                     logger, writer):
    metrics = metric_harness(rendering["rgb"], img_batch["rgb"])
    logger.info("test render %d: psnr=%.2f ssim=%.3f (%.1fs)",
                idx, metrics["psnr"], metrics["ssim"], secs)
    if writer is not None:
        writer.add_scalar("test_psnr", metrics["psnr"], step)
        writer.add_scalar("test_ssim", metrics["ssim"], step)
        writer.add_image("test_render",
                         np.clip(rendering["rgb"], 0, 1).transpose(2, 0, 1),
                         step)


def _stop_profiler(profiler, exp, logger):
    profiler.stop()
    os.makedirs(os.path.join(exp, "profile"), exist_ok=True)
    profiler.export_chrome_trace(os.path.join(exp, "profile", "trace.json"))
    logger.info("profiler trace written to %s/profile", exp)
    return None


if __name__ == "__main__":
    main()
