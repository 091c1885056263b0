"""The data-parallel train step and render (``train/step.py`` with a process
group, ``parallel/mesh.py``) on 2 real gloo ranks on the CPU, at the tiny
preset, against the JAX package and against one process.

Tolerances:
- the 2-rank step against the JAX step on the concatenated 64-ray batch
  (``jax.value_and_grad`` with the Pallas scatters in interpret mode, as
  ``tests/test_torch_train.py::_step_case`` builds it; each rank takes 32
  rays): ``test_torch_train``'s whole-step tolerances, every loss term and
  the total at rtol 1e-4, every reduced gradient at rtol 1e-4 with an atol
  of 1e-5 x max|grad| of the leaf (2e-5 for the tables).  The mean of the
  two ranks' 32-ray gradients is the 64-ray gradient up to f32 rounding,
  since every loss term is a ray mean (``tests/test_multiprocess.py`` shows
  the JAX package's 2-process step equal to its 1-process step the same
  way).
- bitwise: the two ranks' parameters after every step, two 2-rank runs of
  2 keyed steps from one state, and a 1-rank group against no group.
- the 2-rank render against ``render_image`` in one process: rtol 1e-5,
  atol 1e-6 (f32; each ray is rendered with the same hex basis at both
  world sizes, but in sub-chunks of other sizes and on another thread
  count, whose batched arithmetic rounds otherwise: not bitwise, measured
  up to 1.2e-7 in rgb and 9.5e-7 in a depth percentile).
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from ucnerf_tpu_torch import configs as tconfigs
from ucnerf_tpu_torch import convert
from ucnerf_tpu_torch.cli import train as cli_train
from ucnerf_tpu_torch.train import state as tstate
from ucnerf_tpu_torch.train import step as tstep

from test_torch_parallel import launch_ranks, rendezvous

RAYS = 64  # the global batch; 32 a rank
IMAGE = (7, 7)  # the render: chunks of 18, 18 and 13 rays
KEYED_STEPS = 2


def _config(lib, **over):
    """test_torch_train's step config: the tiny preset with 2^16-row hash
    maps and the dense-level backward (K2) on both fields; renders in
    chunks of 18 rays, 2 sub-chunks each, so that the last chunk pads at
    one process (13 -> 14) and at two (13 -> 16), and the others at two."""
    cfg = lib.tiny(render_chunk_size=18, render_subchunks=2, **over)
    mlp = dict(grid_log2_hashmap_size=16, grid_bwd_dense_sample=True)
    return dataclasses.replace(
        cfg, nerf_mlp=dataclasses.replace(cfg.nerf_mlp, **mlp),
        prop_mlp=dataclasses.replace(cfg.prop_mlp, **mlp))


def _snapshot(model, state):
    """Parameters and Adam's moments, cloned."""
    out = {f"param {n}": p.detach().clone()
           for n, p in model.named_parameters()}
    for i, s in state.optimizer.adam.state_dict()["state"].items():
        for k, v in s.items():
            out[f"adam {i} {k}"] = torch.as_tensor(v).clone()
    return out


def _keyed_run(cfg, weights, batch, group, rank):
    """KEYED_STEPS steps from `weights` with the CLI's per-rank draws: the
    local batch and the generator seeded from (5678, step, rank).  Returns
    a snapshot after each step and the losses."""
    model = tstep.init_model(cfg, seed=0, device="cpu")
    model.load_state_dict(weights, strict=True)
    state = tstate.create_train_state(cfg, model)
    train_step = tstep.make_train_step(model, cfg, group)
    gen = torch.Generator()
    snaps, losses = [], []
    for step in range(1, KEYED_STEPS + 1):
        gen.manual_seed(cli_train._step_seed(5678, step, rank))
        state, stats = train_step(state, batch, 0.5, generator=gen)
        snaps.append(_snapshot(model, state))
        losses.append(stats["loss"].clone())
    return snaps, losses


def _worker(spec_path):
    """One rank: every data-parallel case on the same group; writes its
    results to <out>/rank<r>.pt."""
    from ucnerf_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    group = mesh.initialize_multihost("gloo", torch.device("cpu"),
                                      spec["init"])
    rank, world = mesh.rank(group), mesh.world_size(group)
    inputs = torch.load(spec["inputs"], weights_only=True)
    weights, batch = inputs["weights"], inputs["batch"]
    lo, hi = mesh.process_slice(RAYS)
    local = {k: v[lo:hi] for k, v in batch.items()}
    res = {}

    if world == 1:
        # A 1-rank group against no group: the reduce is the identity.
        cfg = _config(tconfigs, microbatches=2)
        for name, g in (("group", group), ("none", None)):
            res[name] = _keyed_run(cfg, weights, local, g, rank)
        torch.save(res, os.path.join(spec["out"], f"rank{rank}.pt"))
        mesh.shutdown()
        return

    # The fixed-basis step, microbatches=1: the reduced gradients.
    cfg = _config(tconfigs)
    model = tstep.init_model(cfg, seed=0, device="cpu")
    model.load_state_dict(weights, strict=True)
    state = tstate.create_train_state(cfg, model)
    _, stats = tstep.make_train_step(model, cfg, group)(
        state, local, 0.5, rand_vec=inputs["rand_vec"][lo:hi])
    res["grads"] = {n: p.grad.clone() for n, p in model.named_parameters()}
    res["params"] = {n: p.detach().clone()
                     for n, p in model.named_parameters()}
    res["stats"] = {"loss": stats["loss"].clone(),
                    "losses": {k: v.clone()
                               for k, v in stats["losses"].items()}}
    # The render, split over the ranks.
    ev = tstep.make_eval_step(model, cfg)
    image = {k: v.numpy() for k, v in inputs["image"].items()}
    res["render"] = tstep.render_image(ev, image, cfg, eval_camidx=1,
                                       group=group)

    # Two keyed runs of 2 steps, 2 microbatches a rank.
    cfg2 = _config(tconfigs, microbatches=2)
    res["keyed"] = [_keyed_run(cfg2, weights, local, group, rank)
                    for _ in range(2)]

    # A batch that does not split into W x M microbatches: 48 rays over 2
    # ranks in 16 microbatches (48 % 16 == 0, 48 % 32 != 0).
    cfg16 = _config(tconfigs, microbatches=16)
    model16 = tstep.init_model(cfg16, seed=0, device="cpu")
    try:
        tstep.make_train_step(model16, cfg16, group)(
            tstate.create_train_state(cfg16, model16),
            {k: v[:24] for k, v in local.items()}, 0.5,
            rand_vec=inputs["rand_vec"][:24])
    except ValueError as e:
        res["ragged"] = str(e)

    # A rank that starts from other weights is set right by the broadcast.
    other = tstep.init_model(cfg, seed=rank, device="cpu")
    mesh.broadcast_parameters(other, group)
    res["broadcast"] = {n: p.detach().clone()
                        for n, p in other.named_parameters()}

    torch.save(res, os.path.join(spec["out"], f"rank{rank}.pt"))
    mesh.shutdown()


def _launch(tmp_path, name, world, inputs):
    folder = tmp_path / name
    folder.mkdir()
    spec = folder / "spec.json"
    spec.write_text(json.dumps({"init": rendezvous(folder),
                                "inputs": inputs, "out": str(folder)}))
    code = ("import sys; from test_torch_dp import _worker; "
            "_worker(sys.argv[1])")
    tests = os.path.dirname(os.path.abspath(__file__))
    launch_ranks([sys.executable, "-c", f"import sys; sys.path.insert(0, "
                  f"{tests!r}); {code}", str(spec)], world)
    return [torch.load(folder / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _jax_reference(cfg_t):
    """JAX's value_and_grad of the train loss on the 64-ray batch with
    randomized weights (test_torch_train's recipe), and the inputs."""
    import jax
    import jax.numpy as jnp

    from ucnerf_tpu import configs as jconfigs
    from ucnerf_tpu.ops import hashgrid as jhash
    from ucnerf_tpu.train import losses as jlosses
    from ucnerf_tpu.train import step as jstep
    from test_torch_train import _randomize

    rng = np.random.default_rng(7)
    cfg_j = _config(jconfigs)
    model_j, params = jstep.init_model(cfg_j, jax.random.PRNGKey(0))
    params = _randomize(params, rng)
    batch = tstep.dummy_batch(cfg_t, RAYS)
    batch["rgb"] = rng.uniform(0, 1, (RAYS, 3)).astype(np.float32)
    batch["sky_segs"] = (rng.uniform(size=RAYS) < 0.3).astype(np.float32)

    def loss_fn(p, b):
        renderings, ray_history = model_j.apply(
            {"params": p}, None, b, 0.5, compute_extras=False, train=True)
        total, losses, _ = jlosses.compute_all_losses(b, renderings,
                                                      ray_history, cfg_j)
        return total, losses

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhash, "SCATTER_IMPL", "pallas_interpret")
        (total, losses), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
                params, jax.tree.map(jnp.asarray, batch))
    rand_vec = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                            (RAYS, 3), jnp.float32))
    weights = convert.params_from_jax(jax.tree.map(np.asarray, params))
    return dict(weights=weights, batch=batch, rand_vec=rand_vec,
                total=float(total),
                losses={k: float(v) for k, v in losses.items()},
                grads=convert.params_from_jax(
                    jax.tree.map(np.asarray, grads)))


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The JAX reference, then one 2-rank launch and one 1-rank launch on
    its inputs (~25 s in all, mostly the JAX side's compile)."""
    tmp = tmp_path_factory.mktemp("dp")
    cfg = _config(tconfigs)
    ref = _jax_reference(cfg)
    image = {k: v.reshape(IMAGE + v.shape[1:]) for k, v in
             tstep.dummy_batch(cfg, IMAGE[0] * IMAGE[1]).items()}
    inputs = str(tmp / "inputs.pt")
    torch.save({"weights": ref["weights"],
                "batch": {k: torch.from_numpy(v)
                          for k, v in ref["batch"].items()},
                "rand_vec": torch.from_numpy(ref["rand_vec"].copy()),
                "image": {k: torch.from_numpy(v) for k, v in image.items()}},
               inputs)
    two = _launch(tmp, "two", 2, inputs)
    one = _launch(tmp, "one", 1, inputs)
    return dict(ref=ref, two=two, one=one, image=image, cfg=cfg)


def test_two_rank_step_matches_jax_on_the_whole_batch(dp):
    ref = dp["ref"]
    for res in dp["two"]:
        stats = res["stats"]
        assert set(stats["losses"]) == set(ref["losses"])
        for k, v in stats["losses"].items():
            np.testing.assert_allclose(float(v), ref["losses"][k], rtol=1e-4,
                                       err_msg=k)
        np.testing.assert_allclose(float(stats["loss"]), ref["total"],
                                   rtol=1e-4)
        assert set(res["grads"]) == set(ref["grads"])
        for name, g in res["grads"].items():
            w = ref["grads"][name].numpy()
            scale = float(np.abs(w).max())
            assert scale > 0, name
            atol = (2e-5 if name.endswith("table") else 1e-5) * scale
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=atol,
                                       err_msg=name)


def test_each_rank_alone_is_not_the_whole_batch(dp):
    """The reduce matters: one rank's own 32-ray gradient misses the
    64-ray gradient (so the match above is the all-reduce's)."""
    ref = dp["ref"]
    cfg = dp["cfg"]
    model = tstep.init_model(cfg, seed=0, device="cpu")
    model.load_state_dict(ref["weights"], strict=True)
    half = {k: torch.from_numpy(v[:RAYS // 2]) for k, v in ref["batch"].items()}
    tstep.make_train_step(model, cfg)(
        tstate.create_train_state(cfg, model), half, 0.5,
        rand_vec=torch.from_numpy(ref["rand_vec"][:RAYS // 2].copy()))
    g = model.nerf_mlp.density_hidden.weight.grad.numpy()
    w = ref["grads"]["nerf_mlp.density_hidden.weight"].numpy()
    assert not np.allclose(g, w, rtol=1e-4,
                           atol=1e-5 * float(np.abs(w).max()))


def test_ranks_are_bitwise_equal(dp):
    a, b = dp["two"]
    for key in ("grads", "params", "broadcast"):
        for n in a[key]:
            assert torch.equal(a[key][n], b[key][n]), (key, n)
    for run in range(2):
        for step in range(KEYED_STEPS):
            sa, sb = a["keyed"][run][0][step], b["keyed"][run][0][step]
            assert set(sa) == set(sb)
            for k in sa:
                assert torch.equal(sa[k], sb[k]), (run, step, k)
        for la, lb in zip(a["keyed"][run][1], b["keyed"][run][1]):
            assert torch.equal(la, lb)


def test_two_runs_are_bitwise_equal(dp):
    for res in dp["two"]:
        first, second = res["keyed"]
        assert len(first[0]) == KEYED_STEPS
        moments = [k for k in first[0][-1] if k.startswith("adam ")
                   and not k.endswith(" step")]
        assert moments
        for s1, s2 in zip(first[0], second[0]):
            for k in s1:
                assert torch.equal(s1[k], s2[k]), k
        assert all(torch.equal(x, y) for x, y in zip(first[1], second[1]))
        # The steps did something.
        assert not torch.equal(first[0][0]["param nerf_mlp.table"],
                               first[0][1]["param nerf_mlp.table"])


def test_world_one_group_is_bitwise_no_group(dp):
    (res,) = dp["one"]
    (snaps_g, losses_g), (snaps_n, losses_n) = res["group"], res["none"]
    for sg, sn in zip(snaps_g, snaps_n):
        assert set(sg) == set(sn)
        for k in sg:
            assert torch.equal(sg[k], sn[k]), k
    assert all(torch.equal(x, y) for x, y in zip(losses_g, losses_n))


def test_two_rank_render_matches_one_process(dp):
    cfg = dp["cfg"]
    model = tstep.init_model(cfg, seed=0, device="cpu")
    model.load_state_dict(dp["ref"]["weights"], strict=True)
    want = tstep.render_image(tstep.make_eval_step(model, cfg), dp["image"],
                              cfg, eval_camidx=1)
    for res in dp["two"]:
        got = res["render"]
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape == IMAGE + want[k].shape[2:]
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_render_would_differ_with_a_per_rank_basis(dp):
    """The trap the render avoids: a rank that drew the basis for its own
    slice would render other pixels."""
    cfg = dp["cfg"]
    model = tstep.init_model(cfg, seed=0, device="cpu")
    model.load_state_dict(dp["ref"]["weights"], strict=True)
    ev = tstep.make_eval_step(model, cfg)
    rays = {k: torch.from_numpy(v.reshape((-1,) + v.shape[2:])[:18])
            for k, v in dp["image"].items()}
    whole = ev(rays, 1.0, 1)["rgb"][:10]
    alone = ev({k: v[:10] for k, v in rays.items()}, 1.0, 1)["rgb"]
    assert not torch.allclose(whole, alone, rtol=1e-5, atol=1e-6)


def test_a_batch_that_does_not_split_raises(dp):
    for res in dp["two"]:
        assert "48 rays over 2 rank(s)" in res["ragged"]
        assert "16 microbatches" in res["ragged"]


def test_broadcast_sets_every_rank_to_rank_0(dp):
    want = tstep.init_model(dp["cfg"], seed=0, device="cpu")
    other = tstep.init_model(dp["cfg"], seed=1, device="cpu")
    for res in dp["two"]:
        for n, p in want.named_parameters():
            assert torch.equal(res["broadcast"][n], p.detach()), n
    assert not torch.equal(other.nerf_mlp.table, want.nerf_mlp.table)


def test_per_rank_seeds():
    """The CLI seeds every step from (base, step, rank).  At W = 1 (rank 0)
    these are the (base, step) seeds one process drew before ranks had a
    seed word: numpy's SeedSequence pads the entropy with zeros.  At W = 2
    each rank draws its own rays and patterns."""
    for step in (1, 5, 1000):
        assert cli_train._step_seed(5678, step, 0) == \
            cli_train._step_seed(5678, step)
        np.testing.assert_array_equal(
            np.random.default_rng((1234, step, 0)).integers(0, 1 << 30, 8),
            np.random.default_rng((1234, step)).integers(0, 1 << 30, 8))
    seeds = {cli_train._step_seed(5678, 5, r) for r in range(2)}
    assert len(seeds) == 2
    draws = [np.random.default_rng((1234, 5, r)).integers(0, 1 << 30, 8)
             for r in range(2)]
    assert not np.array_equal(*draws)
