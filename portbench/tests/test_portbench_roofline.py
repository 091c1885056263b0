"""The frozen FLOP and byte models against what the port computes and
moves at a tiny size on the CPU."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import tiny_config
from portbench import roofline
from portbench.kinds.common import port_config


def _batch(cfg, n, seed=0):
    from ucnerf_tpu_torch.train import step
    rays = step.dummy_batch(port_config(cfg), n)
    rng = np.random.default_rng(seed)
    rays["rgb"] = rng.random((n, 3), dtype=np.float32)
    rays["sky_segs"] = (rng.random(n) < 0.3).astype(np.float32)
    rays["origins"] = rays["origins"] * 0.2
    return step.batch_to_device(rays, "cpu")


def _model(cfg):
    from ucnerf_tpu_torch.train import step
    return step.init_model(port_config(cfg), seed=3, device="cpu")


@pytest.mark.parametrize("single_query", [False, True])
def test_train_flops_are_the_counted_matmuls(single_query):
    from ucnerf_tpu_torch.train import state as state_lib
    from ucnerf_tpu_torch.train import step
    cfg = tiny_config(single_query)
    config = port_config(cfg)
    model = _model(cfg)
    st = state_lib.create_train_state(config, model)
    train_step = step.make_train_step(model, config)
    batch = _batch(cfg, cfg["batch_size"])
    with FlopCounterMode(display=False) as counter:
        train_step(st, batch, 0.5, generator=torch.Generator().manual_seed(1))
    assert roofline.flops(cfg, cfg["batch_size"], train=True) \
        == counter.get_total_flops()


@pytest.mark.parametrize("single_query", [False, True])
def test_render_flops_are_the_counted_matmuls(single_query):
    from ucnerf_tpu_torch.train import step
    cfg = tiny_config(single_query)
    eval_step = step.make_eval_step(_model(cfg), port_config(cfg))
    batch = _batch(cfg, 300)
    with FlopCounterMode(display=False) as counter:
        eval_step(batch, 1.0, 0)
    assert roofline.flops(cfg, 300, train=False) \
        == counter.get_total_flops()


def test_byte_models_are_the_kernels_inputs_and_outputs(monkeypatch):
    """Each K4 launch reads its indices and weights and writes its
    features; each K1 fused and K2 launch reads its positions (int64, as
    the sort hands them over), weights or fracs, grads and run starts and
    writes its rows.  The models count exactly that, and no touched row."""
    from ucnerf_tpu_torch.ops import gather, scatter
    from ucnerf_tpu_torch.train import state as state_lib
    from ucnerf_tpu_torch.train import step
    seen = {"gather": 0, "scatter": 0}
    take, wsum, dense = (gather.take_wsum_cm, scatter.scatter_add_wsum_cm,
                         scatter.scatter_add_dense_cm)

    def take_counted(table, idx, w, bf16=False):
        out = take(table, idx, w, bf16)
        seen["gather"] += 2 * idx.numel() * 4 + out.numel() * 4
        return out

    def wsum_counted(g, w, keys, num_rows, out=None):
        m = keys.numel()
        seen["scatter"] += (m * 8 + w.numel() * 4 + g.numel() * 4
                            + (num_rows + 1) * 4 + g.shape[1] * num_rows * 4)
        return wsum(g, w, keys, num_rows, out=out)

    def dense_counted(gvals, fracs, base_idx, num_rows, **kw):
        m = base_idx.numel()
        seen["scatter"] += (m * 8 + 3 * m * 4 + gvals.numel() * 4
                            + (num_rows + 1) * 4
                            + gvals.shape[0] * num_rows * 4)
        return dense(gvals, fracs, base_idx, num_rows, **kw)
    monkeypatch.setattr(gather, "take_wsum_cm", take_counted)
    monkeypatch.setattr(scatter, "scatter_add_wsum_cm", wsum_counted)
    monkeypatch.setattr(scatter, "scatter_add_dense_cm", dense_counted)

    cfg = tiny_config()
    config = port_config(cfg)
    model = _model(cfg)
    st = state_lib.create_train_state(config, model)
    step.make_train_step(model, config)(
        st, _batch(cfg, cfg["batch_size"]), 0.5,
        generator=torch.Generator().manual_seed(1))
    assert seen["gather"] == roofline.gather_bytes(cfg, cfg["batch_size"])
    assert seen["scatter"] == roofline.scatter_bytes(
        cfg, cfg["batch_size"], cfg["microbatches"])
