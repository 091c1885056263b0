"""The port's roofline accounting (``ucnerf_tpu_torch/utils/roofline.py``
and ``ops/traffic.py``) on the CPU: the gather model against the JAX
package's, the scoreboard's arithmetic, and the FLOP and byte counts of a
tiny train step.

FLOPs are held to a hand count of the four MLPs' products (the proposal
and NeRF fields, the sky NeRF, the brightness MLP): 2 x rows x in x out a
layer forward, twice that backward (the input's gradient and the
weight's).  The count also holds the hex basis's rotation (a batched
3x3 product) and skips the backward of the sky NeRF's first layer, whose
input needs no gradient: within 0.5 %.
"""

import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from ucnerf_tpu import configs as jconfigs
from ucnerf_tpu.utils import roofline as jroofline
from ucnerf_tpu_torch import configs as tconfigs
from ucnerf_tpu_torch.ops import gather, scatter, traffic
from ucnerf_tpu_torch.train import state as tstate
from ucnerf_tpu_torch.train import step as tstep
from ucnerf_tpu_torch.utils import roofline

torch.set_num_threads(2)

FLOP_RTOL = 5e-3


@pytest.mark.parametrize("preset", ["waymo", "waymo_tpu", "synthetic_quality",
                                    "tiny"])
def test_gather_model_matches_jax(preset):
    got = roofline.gather_model(getattr(tconfigs, preset)())
    want = jroofline.gather_model(getattr(jconfigs, preset)())
    assert got["lookups"] == want["lookups"] > 0
    assert got["ideal_bytes"] == want["ideal_bytes"]
    # One 32-byte sector a lookup, where the TPU model reads a 4 KiB tile.
    assert got["sector_bytes"] == 32 * got["lookups"]
    assert want["tile_bytes"] == 128 * got["sector_bytes"]


def test_metrics_math():
    m = roofline.metrics(dt=0.5, flops=roofline.PEAK_FLOPS * 0.05,
                         bytes_=roofline.PEAK_BW * 0.2,
                         gm=dict(lookups=10,
                                 sector_bytes=roofline.PEAK_BW * 0.1))
    assert m["mfu"] == pytest.approx(0.1)  # 5% of peak work in half the time
    assert m["f32_share"] == pytest.approx(
        0.1 * roofline.PEAK_FLOPS / roofline.PEAK_FLOPS_F32)
    assert m["hbm_util"] == pytest.approx(0.4)
    assert m["hbm_util_gather_sector"] == pytest.approx(0.2)
    assert m["gather_lookups_per_step"] == 10


def _flagship_tiny(batch_size=64, value_dtype=None):
    """The tiny preset with the flagship's encoder knobs: single-query hex
    lookups and the dense levels' per-sample backward (K2), on 2^16-row
    hash maps (which have dense levels)."""
    cfg = tconfigs.tiny(batch_size=batch_size)
    mlp = dict(hex_single_query=True, grid_bwd_dense_sample=True,
               grid_log2_hashmap_size=16,
               grid_bwd_value_dtype=value_dtype)
    return dataclasses.replace(
        cfg, nerf_mlp=dataclasses.replace(cfg.nerf_mlp, **mlp),
        prop_mlp=dataclasses.replace(cfg.prop_mlp, **mlp))


def _step_cost(cfg):
    model = tstep.init_model(cfg, seed=0, device="cpu")
    state = tstate.create_train_state(cfg, model)
    batch = tstep.batch_to_device(tstep.dummy_batch(cfg, cfg.batch_size),
                                  "cpu")
    return roofline.train_step_cost(cfg, model, state, batch), model


def test_train_step_cost_positive_and_grows():
    (f1, b1, _), _ = _step_cost(tconfigs.tiny(batch_size=64))
    (f2, b2, _), _ = _step_cost(tconfigs.tiny(batch_size=128))
    assert f1 > 0 and b1 > 0
    assert f2 > f1 and b2 > b1


def _products(module):
    """Sum of in x out over the 2-D weights of a module's linear layers."""
    return sum(p.shape[0] * p.shape[1] for n, p in module.named_parameters()
               if n.endswith("weight") and p.dim() == 2)


def test_train_step_flops_match_hand_count():
    cfg = tconfigs.tiny(batch_size=64, microbatches=2)
    (flops, _, _), model = _step_cost(cfg)
    n = cfg.batch_size // cfg.microbatches
    m = cfg.model
    rows = {"prop_mlp_0": n * m.num_prop_samples,
            "nerf_mlp": n * m.num_nerf_samples,
            "skynerf": n * m.sky_num_samples,
            # The view's latent and its sky latent.
            "brightness_corr": 2 * n}
    forward = sum(2 * r * _products(getattr(model, name))
                  for name, r in rows.items())
    hand = 3 * forward * cfg.microbatches
    assert flops == pytest.approx(hand, rel=FLOP_RTOL)


def test_byte_counter_counts_each_operand_once():
    x = torch.randn(1000)
    with traffic.ByteCounter() as counter:
        y = x + x
        y.view(10, 100).t()
        torch.empty(5000)
    assert counter.bytes == 2 * 4000
    table = torch.randn(4, 100)
    idx = torch.tensor([3, 3, 7, 200], dtype=torch.int32)
    with traffic.ByteCounter() as counter:
        gather.take_cm(table, idx)
    # 4 indices, [4, 4] out, 2 distinct rows (200 is a sentinel).
    assert counter.bytes == gather.take_cm_bytes(4, 4, 2) == 4 * 4 + 64 + 32
    assert dict(counter.kernels) == {"take_cm": counter.bytes}


def _opaque(fn):
    """fn run where no dispatch mode sees it, as a ctypes launch is."""
    def run(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)
    return run


@pytest.mark.parametrize("value_dtype", [None, "bfloat16"])
def test_byte_count_does_not_depend_on_the_route(value_dtype, monkeypatch):
    """On the CPU the kernel wrappers run their plain versions, which a
    dispatch mode sees; on the card, ctypes launches, which it does not.
    The step's count is the same with every plain version hidden, so it
    holds each kernel at its byte model whichever route ran."""
    cfg = _flagship_tiny(value_dtype=value_dtype)
    (flops, nbytes, kernels), _ = _step_cost(cfg)
    fused = ("scatter_add_wsum_packed_cm" if value_dtype
             else "scatter_add_wsum_cm")
    # The kernels the step reached, each counted by its byte model.
    assert set(kernels) == {"take_wsum_cm", fused, "scatter_add_dense_cm"}
    assert all(v > 0 for v in kernels.values())
    assert nbytes > sum(kernels.values())
    for module, name in (
            (gather, "take_cm_plain"), (gather, "take_wsum_cm_plain"),
            (scatter, "scatter_add_cm_plain"),
            (scatter, "scatter_add_wsum_cm_plain"),
            (scatter, "scatter_add_dense_cm_plain"),
            (scatter, "scatter_add_packed_cm_plain"),
            (scatter, "scatter_add_wsum_packed_cm_plain")):
        monkeypatch.setattr(module, name, _opaque(getattr(module, name)))
    assert _step_cost(cfg)[0] == (flops, nbytes, kernels)
