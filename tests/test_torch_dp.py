"""The data-parallel train step and render (``train/step.py`` with a process
group, ``parallel/mesh.py``) on 2 and 3 real gloo ranks on the CPU, at the
tiny preset, against the JAX package and against one process.

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
- uneven shares (``step.microbatch_shares``): 48 rays over 2 ranks in 16
  microbatches (shares 2 and 1) against JAX's step on the 48 rays in one
  piece, and 48 rays over 3 ranks in 3 microbatches (shares 5, 5 and 6)
  and in 24 (N = 2 < W: every rank has empty shares) against the JAX
  package's own sharded step on a 3-device mesh (its gradients read off a
  stand-in optimizer that keeps them as its state; its model called with
  ``key=None``, so every global microbatch of N rays takes the basis
  ``normal(PRNGKey(0), (N, 3))`` and the port gets that basis ray by ray):
  the tolerances of the 2-rank step above.  The weighted shares sum each
  global microbatch's rays in another order than one process, so these
  agree to f32 rounding, not bitwise.
- bitwise: the two ranks' parameters after every step, two 2-rank runs of
  2 keyed steps from one state, and a 1-rank group against no group; the
  three ranks' reduced gradients and stats.
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
UNEVEN = 48  # the uneven cases' global batch: the first 48 of the 64 rays
THREE_MICRO = (3, 24)  # 16 rays a rank: shares 5/5/6, and 0/1 (N = 2 < W)
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


def _fixed_step(cfg, weights, local, rand_vec, group):
    """One fixed-basis step; returns the reduced gradients (read where the
    optimizer starts, before its clean and clips) and the stats."""
    model = tstep.init_model(cfg, seed=0, device="cpu")
    model.load_state_dict(weights, strict=True)
    state = tstate.create_train_state(cfg, model)
    grads = {}
    update = state.optimizer.update

    def keep_then_update():
        grads.update({n: p.grad.clone()
                      for n, p in model.named_parameters()})
        update()

    state.optimizer.update = keep_then_update
    _, stats = tstep.make_train_step(model, cfg, group)(
        state, local, 0.5, rand_vec=rand_vec)
    return {"grads": grads, "loss": stats["loss"].clone(),
            "losses": {k: v.clone() for k, v in stats["losses"].items()}}


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
    res = {}
    if world == 3:
        # 48 rays, 16 a rank, in 3 and in 24 global microbatches, each with
        # JAX's per-microbatch basis.
        lo, hi = mesh.process_slice(UNEVEN)
        local = {k: v[lo:hi] for k, v in batch.items()}
        for micro in THREE_MICRO:
            cfg = _config(tconfigs, microbatches=micro)
            res[micro] = _fixed_step(cfg, weights, local,
                                     inputs[f"rand_vec_m{micro}"][lo:hi],
                                     group)
            res[micro]["shares"] = tstep.microbatch_shares(
                UNEVEN, world, micro)[rank].tolist()
        torch.save(res, os.path.join(spec["out"], f"rank{rank}.pt"))
        mesh.shutdown()
        return

    lo, hi = mesh.process_slice(RAYS)
    local = {k: v[lo:hi] for k, v in batch.items()}

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

    # Uneven shares: 48 rays over 2 ranks in 16 microbatches of 3 (shares
    # 2 and 1), each rank on its 24.
    lo48, hi48 = mesh.process_slice(UNEVEN)
    res["uneven"] = _fixed_step(
        _config(tconfigs, microbatches=16), weights,
        {k: v[lo48:hi48] for k, v in batch.items()}, inputs["rand_vec_48"][
            lo48:hi48], group)

    # Batches that do not split: 50 rays (25 a rank) into 16 microbatches,
    # and 47 rays over the 2 ranks.
    cfg16 = _config(tconfigs, microbatches=16)
    model16 = tstep.init_model(cfg16, seed=0, device="cpu")
    res["ragged"] = []
    for call in (lambda: tstep.make_train_step(model16, cfg16, group)(
                     tstate.create_train_state(cfg16, model16),
                     {k: v[:25] for k, v in local.items()}, 0.5,
                     rand_vec=inputs["rand_vec"][:25]),
                 lambda: mesh.process_slice(47)):
        try:
            call()
        except ValueError as e:
            res["ragged"].append(str(e))

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


def _jax_sharded_grads(jax, jnp, jstep, model_j, params, cfg_j, batch,
                       devices):
    """The JAX package's own sharded train step (``make_train_step`` with a
    mesh of `devices`) on the global `batch`, its model called with
    ``key=None``.  Its optimizer is a stand-in that applies no update and
    keeps the gradients as its state: returns (stats, gradients)."""
    import optax

    from ucnerf_tpu.parallel import mesh as jmesh
    from ucnerf_tpu.train import state as jstate

    class Keyless:
        def apply(self, variables, key, *args, **kwargs):
            return model_j.apply(variables, None, *args, **kwargs)

    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstate, "create_optimizer", lambda config: keep)
        mesh = jmesh.create_mesh(devices)
        train_step = jstep.make_train_step(Keyless(), cfg_j, mesh=mesh)
        state = jstate.TrainState(step=jnp.zeros((), jnp.int32),
                                  params=params, opt_state=keep.init(params))
        state, stats = train_step(state, jmesh.shard_batch(batch, mesh),
                                  jax.random.PRNGKey(1), jnp.float32(0.5))
    return stats, state.opt_state


def _jax_reference(cfg_t):
    """JAX's value_and_grad of the train loss on the 64-ray batch and on its
    first 48 rays, with randomized weights (test_torch_train's recipe); the
    JAX package's sharded step on the 48 rays over 3 devices in each of
    THREE_MICRO microbatches; and the inputs."""
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
    uneven = {k: v[:UNEVEN] for k, v in batch.items()}

    def loss_fn(p, b):
        renderings, ray_history = model_j.apply(
            {"params": p}, None, b, 0.5, compute_extras=False, train=True)
        total, losses, _ = jlosses.compute_all_losses(b, renderings,
                                                      ray_history, cfg_j)
        return total, losses

    def numpy_tree(tree):
        return convert.params_from_jax(jax.tree.map(np.asarray, tree))

    def basis(n):
        return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n, 3),
                                            jnp.float32))

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhash, "SCATTER_IMPL", "pallas_interpret")
        grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        for name, b in (("whole", batch), ("whole_48", uneven)):
            (total, losses), grads = grad_fn(params,
                                             jax.tree.map(jnp.asarray, b))
            out[name] = dict(total=float(total),
                             losses={k: float(v) for k, v in losses.items()},
                             grads=numpy_tree(grads))
        for micro in THREE_MICRO:
            stats, grads = _jax_sharded_grads(
                jax, jnp, jstep, model_j, params,
                dataclasses.replace(cfg_j, microbatches=micro), uneven,
                jax.devices()[:3])
            out[f"sharded_m{micro}"] = dict(
                total=float(stats["loss"]),
                losses={k: float(v) for k, v in stats["losses"].items()},
                grads=numpy_tree(grads))
    rand_vecs = {"rand_vec": basis(RAYS), "rand_vec_48": basis(UNEVEN)}
    for micro in THREE_MICRO:
        rand_vecs[f"rand_vec_m{micro}"] = np.tile(basis(UNEVEN // micro),
                                                  (micro, 1))
    whole = out.pop("whole")
    return dict(weights=numpy_tree(params), batch=batch,
                rand_vec=rand_vecs["rand_vec"], rand_vecs=rand_vecs,
                total=whole["total"], losses=whole["losses"],
                grads=whole["grads"], **out)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The JAX references, then one 2-rank, one 1-rank and one 3-rank
    launch on their inputs."""
    tmp = tmp_path_factory.mktemp("dp")
    cfg = _config(tconfigs)
    ref = _jax_reference(cfg)
    image = {k: v.reshape(IMAGE + v.shape[1:]) for k, v in
             tstep.dummy_batch(cfg, IMAGE[0] * IMAGE[1]).items()}
    inputs = str(tmp / "inputs.pt")
    torch.save({"weights": ref["weights"],
                "batch": {k: torch.from_numpy(v)
                          for k, v in ref["batch"].items()},
                **{k: torch.from_numpy(v.copy())
                   for k, v in ref["rand_vecs"].items()},
                "image": {k: torch.from_numpy(v) for k, v in image.items()}},
               inputs)
    two = _launch(tmp, "two", 2, inputs)
    one = _launch(tmp, "one", 1, inputs)
    three = _launch(tmp, "three", 3, inputs)
    return dict(ref=ref, two=two, one=one, three=three, image=image, cfg=cfg)


def _assert_step_matches(res, ref):
    """A port step's loss terms and reduced gradients against JAX's, at the
    2-rank step's tolerances."""
    assert set(res["losses"]) == set(ref["losses"])
    for k, v in res["losses"].items():
        np.testing.assert_allclose(float(v), ref["losses"][k], rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(res["loss"]), ref["total"], rtol=1e-4)
    assert set(res["grads"]) == set(ref["grads"])
    for name, g in res["grads"].items():
        w = ref["grads"][name].numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, name
        atol = (2e-5 if name.endswith("table") else 1e-5) * scale
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=atol,
                                   err_msg=name)


def test_two_rank_step_matches_jax_on_the_whole_batch(dp):
    for res in dp["two"]:
        _assert_step_matches(dict(res["stats"], grads=res["grads"]),
                             dp["ref"])


def test_uneven_shares_match_jax_on_the_whole_batch(dp):
    """48 rays over 2 ranks in 16 microbatches of 3: each rank takes 2 rays
    of half the microbatches and 1 of the others, weighted by W n / N."""
    for res in dp["two"]:
        _assert_step_matches(res["uneven"], dp["ref"]["whole_48"])
    a, b = (res["uneven"] for res in dp["two"])
    for n in a["grads"]:
        assert torch.equal(a["grads"][n], b["grads"][n]), n
    assert torch.equal(a["loss"], b["loss"])


def _misses(got, want, name):
    """Entries of `got` outside the 2-rank step's tolerance of `want`."""
    scale = float(np.abs(want).max())
    atol = (2e-5 if name.endswith("table") else 1e-5) * scale
    return np.abs(got - want) > 1e-4 * np.abs(want) + atol


@pytest.mark.parametrize("micro", THREE_MICRO)
def test_three_ranks_match_the_jax_sharded_step(dp, micro):
    """48 rays over 3 ranks (16 a rank, (B / W) % M != 0) against the JAX
    package's sharded step on a 3-device mesh, and against the port's own
    step in one process on the same 48 rays and microbatches.  At 24
    microbatches of 2 rays each rank runs 16 of them and skips 8.

    The 3 ranks agree with the one process at the 2-rank tolerances
    everywhere.  Against JAX the one process (and so the 3 ranks) misses a
    few entries of a table's dense levels, where the backward rounds each
    sample's frac to bf16 and a position that differs in its last f32 bit
    can round to the neighbouring bf16 value (measured at 3 microbatches:
    2 entries of the NeRF table's level 1, 3.6e-5 x max|grad|, beside the
    2e-5 tolerance).  So every entry outside the tolerance of JAX must be
    one the one-process step misses too, a dense-level row, and at most
    2 a table."""
    ref = dp["ref"][f"sharded_m{micro}"]
    shares = [res[micro]["shares"] for res in dp["three"]]
    assert np.array_equal(np.sum(shares, axis=0),
                          [UNEVEN // micro] * micro)
    assert all(sum(s) == UNEVEN // 3 for s in shares)
    if micro == 24:
        assert all(s.count(0) == 8 for s in shares)
    cfg = _config(tconfigs, microbatches=micro)
    batch = {k: torch.from_numpy(v[:UNEVEN])
             for k, v in dp["ref"]["batch"].items()}
    one = _fixed_step(cfg, dp["ref"]["weights"], batch, torch.from_numpy(
        dp["ref"]["rand_vecs"][f"rand_vec_m{micro}"].copy()), None)
    model = tstep.init_model(cfg, seed=0, device="cpu")
    dense_rows = {f"{n}.table": m.grid_spec.offsets[m.grid_spec.dense_prefix]
                  for n, m in model.named_modules()
                  if hasattr(m, "grid_spec")}
    for res in dp["three"]:
        got = res[micro]
        assert set(got["losses"]) == set(ref["losses"])
        for k, v in got["losses"].items():
            np.testing.assert_allclose(float(v), ref["losses"][k],
                                       rtol=1e-4, err_msg=k)
            np.testing.assert_allclose(float(v), float(one["losses"][k]),
                                       rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(float(got["loss"]), ref["total"],
                                   rtol=1e-4)
        assert set(got["grads"]) == set(ref["grads"]) == set(one["grads"])
        for name, g in got["grads"].items():
            g, o = g.numpy(), one["grads"][name].numpy()
            w = ref["grads"][name].numpy()
            assert float(np.abs(w).max()) > 0, name
            assert not _misses(g, o, name).any(), name
            miss = _misses(g, w, name)
            assert not (miss & ~_misses(o, w, name)).any(), name
            if miss.any():
                assert name in dense_rows, name
                assert miss.sum() <= 1e-4 * miss.size, (name, miss.sum())
                assert (np.argwhere(miss)[:, 1] < dense_rows[name]).all(), \
                    (name, np.argwhere(miss))
    first = dp["three"][0][micro]
    for res in dp["three"][1:]:
        for n in first["grads"]:
            assert torch.equal(res[micro]["grads"][n], first["grads"][n]), n
        assert torch.equal(res[micro]["loss"], first["loss"])


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
    """B % M != 0 raises in the step; B % W != 0 raises in process_slice
    (and in microbatch_shares), as in the JAX package."""
    for res in dp["two"]:
        step_err, slice_err = res["ragged"]
        assert "50 rays do not split into 16 microbatches" in step_err
        assert "global batch 47 not divisible by 2 processes" in slice_err
    with pytest.raises(ValueError, match="not divisible by 2 processes"):
        tstep.microbatch_shares(47, 2, 1)


SHARE_GRID = [(15000, 8, 10), (15000, 3, 15), (15000, 6, 15), (15000, 4, 10),
              (48, 2, 16), (48, 3, 3), (48, 3, 24), (48, 3, 48), (64, 2, 64),
              (12, 4, 12), (102, 3, 6), (256, 1, 4), (1200, 16, 15),
              (30, 5, 2)]


@pytest.mark.parametrize("batch,world,micro", SHARE_GRID)
def test_microbatch_shares(batch, world, micro):
    shares = tstep.microbatch_shares(batch, world, micro)
    n = batch // micro
    assert shares.shape == (world, micro)
    assert (shares.sum(axis=0) == n).all()
    assert (shares.sum(axis=1) == batch // world).all()
    assert set(np.unique(shares)) <= {n // world, -(-n // world)}
    if n % world == 0:
        # Equal shares: the contiguous split the step always made.
        assert (shares == n // world).all()


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
