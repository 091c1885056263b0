"""The train step replayed from a CUDA graph against the eager step, on the
card: over steps with a reseeded CUDA generator and a batch of its own each,
every step's loss, loss terms and stats, every ``.grad`` as the optimizer
gets it, and every parameter and Adam moment after the update, bit for bit;
the graph captured once and replayed on every later step of the same shapes,
into the ``.grad`` tensors of the eager call before the capture; the
hand-written kernels a replay runs, counted on the card from a profiler
trace, those of the eager step, while the wrappers' launch counters (the
host's launches) stay still; and a new batch size captured only when it
repeats.  At ``configs.waymo()`` and
``configs.waymo_tpu()`` with a reduced batch, and at ``configs.waymo()``
with camera refinement and contracted origin gradients (the path whose K4
launches are ``take_cm``).  Besides, the sky's cumulative product
(``models/sky.py``) against torch's, with its backward, bit for bit.

These tests need a CUDA card (a CUDA graph has no CPU mode) and skip without
one.  This file imports no JAX, so that it runs on the card's machine:

  python -m pytest --noconftest -p no:cacheprovider -s \\
      tests/test_card_train_graph.py

(``--noconftest``: ``tests/conftest.py`` sets JAX up.)  ``chip_smoke.py``
runs it as a gate.
"""

import copy

import numpy as np
import pytest
import torch

import card_launches
from ucnerf_tpu_torch import configs
from ucnerf_tpu_torch.models import sky
from ucnerf_tpu_torch.train import state as state_lib
from ucnerf_tpu_torch.train import step as step_lib

pytestmark = pytest.mark.card

RAYS = 3000
SMALL = 1500
# Four steps at RAYS (eager, capture, replay, replay), then SMALL twice
# (eager, capture).
SIZES = [RAYS] * 4 + [SMALL] * 2
# The step whose launches are counted on the card, in the eager run (an
# eager step) and in the graphed run (a replay; a capture's call runs its
# first replay inside).
ON_DEVICE = {False: 0, True: 2}
CONFIGS = {
    "waymo": lambda: configs.waymo(batch_size=RAYS, lr_delay_steps=0),
    "waymo_tpu": lambda: configs.waymo_tpu(batch_size=RAYS,
                                           lr_delay_steps=0),
    "cameras": lambda: configs.waymo(batch_size=RAYS, lr_delay_steps=0,
                                     optimize_cameras=True,
                                     contract_origin_grads=True),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def _batch(cfg, n, seed, device):
    """Random rays in the scene's box with random targets, sky pixels and
    camera ids, seeded."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    b = step_lib.dummy_batch(cfg, n)
    b.update(origins=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
             directions=d, viewdirs=d.copy(), cam_dirs=d.copy(),
             rgb=rng.uniform(0, 1, (n, 3)).astype(np.float32),
             sky_segs=(rng.uniform(size=n) < 0.3).astype(np.float32),
             cam_idx=rng.integers(0, cfg.training_views, n).astype(np.int32),
             phys_cam_idx=rng.integers(0, cfg.num_phys_cams,
                                       n).astype(np.int32))
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _counts():
    from ucnerf_tpu_torch.ops import gather, hashgrid, scatter
    return {k: getattr(mod, k).launches for k in card_launches.KERNELS
            for mod in (gather, hashgrid, scatter) if hasattr(mod, k)}


def _run(model, cfg, graphs, device):
    """SIZES steps of `model`; per step the stats, the gradients as the
    optimizer gets them, the parameters and Adam moments after it, the
    launch counters' advance, the kernels the card ran (counted on the
    step ON_DEVICE names) and the gradients' storage; and the train
    step."""
    state = state_lib.create_train_state(cfg, model)
    train_step = step_lib.make_train_step(model, cfg, graphs=graphs)
    generator = torch.Generator(device=device)
    update = state.optimizer.update
    seen = {}

    def snap_update():
        seen.update({f"grad {n}": p.grad.clone()
                     for n, p in model.named_parameters()})
        update()

    state.optimizer.update = snap_update
    steps = []
    for i, n in enumerate(SIZES):
        batch = _batch(cfg, n, 10 + i, device)
        generator.manual_seed(4_000_000_000 + i)
        before = _counts()

        def call():
            return train_step(state, batch, 0.05 * (i + 1),
                              generator=generator)

        if i == ON_DEVICE[graphs]:
            (state, stats), ran = card_launches.on_device(call)
        else:
            (state, stats), ran = call(), None
        torch.cuda.synchronize()
        after = _counts()
        got = dict(seen)
        got["loss"] = stats["loss"].clone()
        got.update({f"losses {k}": v.clone()
                    for k, v in stats["losses"].items()})
        got.update({f"stats {k}": v.clone() for k, v in stats.items()
                    if k not in ("loss", "losses")})
        got.update({f"param {k}": p.detach().clone()
                    for k, p in model.named_parameters()})
        adam = state.optimizer.adam.state
        got.update({f"adam {k} {m}": adam[p][m].clone()
                    for k, p in model.named_parameters()
                    for m in ("exp_avg", "exp_avg_sq")})
        launches = {k: after[k] - before[k] for k in after}
        grads = [p.grad.data_ptr() for p in model.parameters()]
        steps.append((got, launches, ran, grads))
    return steps, train_step


@pytest.mark.parametrize("name", list(CONFIGS))
def test_graphed_step_is_bitwise_the_eager_step(cuda, name):
    cfg = CONFIGS[name]()
    eager_model = step_lib.init_model(cfg, seed=0, device=cuda)
    graph_model = copy.deepcopy(eager_model)
    eager, eager_step = _run(eager_model, cfg, False, cuda)
    del eager_model
    graphed, step = _run(graph_model, cfg, True, cuda)
    assert eager_step.captures == eager_step.replays == 0
    # RAYS: eager, capture, replay, replay; SMALL: eager, capture.
    assert step.captures == 2 and step.replays == 4, (step.captures,
                                                      step.replays)
    for i, (got, want) in enumerate(zip(graphed, eager)):
        (got, got_n, got_dev, _), (want, want_n, want_dev, _) = got, want
        assert set(got) == set(want)
        differ = [k for k in want if not torch.equal(got[k], want[k])]
        assert not differ, f"{name} step {i + 1}: {differ} differ"
        assert sum(want_n.values()) > 0
        if i == ON_DEVICE[False]:
            # The name patterns count what the eager step's wrappers
            # launched.
            assert want_dev == want_n, f"{name} step {i + 1}: on the " \
                f"card {want_dev}, the wrappers counted {want_n}"
        if i == ON_DEVICE[True]:
            # A replay runs the kernels the eager step launches.
            assert got_dev == want_n, f"{name} step {i + 1}: on the " \
                f"card {got_dev} against eager {want_n}"
        if i in (2, 3):
            assert not any(got_n.values()), f"{name} step {i + 1}: a " \
                f"replay's host launches {got_n}"
        else:
            # An eager call, or a capture (its Python issues each launch
            # once, into the graph).
            assert got_n == want_n, f"{name} step {i + 1}: launches " \
                f"{got_n} against eager {want_n}"
    # One set of gradients: the capture keeps the eager call's `.grad`.
    ptrs = [g[3] for g in graphed]
    assert ptrs[1] == ptrs[2] == ptrs[3] == ptrs[0]
    assert ptrs[5] == ptrs[4]
    print(f"[train_graph] {name}: {len(SIZES)} steps ({SIZES}) bitwise the "
          f"eager step; captures {step.captures}, replays {step.replays}; "
          f"kernels of a replayed {RAYS}-ray step on the card "
          f"{graphed[2][2]}; loss "
          f"{[float(g[0]['loss']) for g in graphed]}", flush=True)


def test_sky_cumprod_backward_is_torchs_on_the_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    alpha = torch.rand((15000, 120), generator=gen, device=cuda)
    alpha[:, -1] = 1.0
    x = torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10],
                  dim=-1).requires_grad_()
    g = torch.randn(x.shape, generator=gen, device=cuda)
    want = torch.cumprod(x, dim=-1)
    got = sky.cumprod_nonzero(x)
    assert torch.equal(got, want)
    assert torch.equal(torch.autograd.grad(got, x, g)[0],
                       torch.autograd.grad(want, x, g)[0])
