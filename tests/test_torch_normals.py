"""The port's density and predicted normals with their losses against the
JAX package on the CPU: the ref-NeRF losses (``orientation_loss`` with
either target, ``predicted_normal_loss``), the second derivative through
the hash grid (``hashgrid._GatherWSumBackward``) that the normals' losses
need, the tiny preset's training step with normals on every field, both
losses and ``contract_origin_grads`` against ``jax.value_and_grad``, the
normals of a render (taken under a local grad mode inside the eval step's
no_grad), and the JAX package's zero normals with the contraction's
gradients stopped.

Tolerances:
- losses alone: rtol 1e-5, atol 1e-7 (the same f32 formulas).
- the field's normals-only loss: the normals and every gradient at atol
  1e-3 x max|.| and rtol 1e-4.  The density normals are normalized
  gradients of the density, sums of table differences across a cell scaled
  by the grid resolution: their f32 cancellation leaves errors up to
  2.6e-5 in the unit vectors (3.5e-5 for either side against a float64 run
  of the port), ~100x the forward's.
- the training step: losses rtol 1e-4; every gradient rtol 1e-4 with atol
  1e-3 x max|grad| of the leaf, for the same reason (measured worst 2.8e-4,
  the proposal field's ``normal_layer`` bias).  Both fields take the exact
  f32 table backward (``grid_bwd_dense_sample`` off): the JAX package's
  Pallas scatters have no second derivative (``pallas_call`` has no JVP
  rule), so its normals step runs the XLA route, whose dense levels do not
  round fractional coords to bf16 as K2 does.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucnerf_tpu import configs as jconfigs
from ucnerf_tpu.models import fields as jfields
from ucnerf_tpu.train import losses as jlosses
from ucnerf_tpu_torch import configs as tconfigs
from ucnerf_tpu_torch import convert
from ucnerf_tpu_torch.models import fields as tfields
from ucnerf_tpu_torch.ops import hashgrid as thash
from ucnerf_tpu_torch.train import losses as tlosses
from ucnerf_tpu_torch.train import step as tstep

import test_torch_field_options as tfo
import test_torch_train as tt

torch.set_num_threads(2)

NORMALS = dict(disable_density_normals=False, enable_pred_normals=True)
# The ref-NeRF weights of the normals' losses.
NORMAL_LOSSES = dict(orientation_loss_mult=0.1,
                     orientation_coarse_loss_mult=0.01,
                     predicted_normal_loss_mult=3e-4,
                     predicted_normal_coarse_loss_mult=3e-5)


def _normals_configs():
    return [tfo.with_mlps(tt._train_config(lib, contract_origin_grads=True,
                                       **NORMAL_LOSSES),
                      grid_bwd_dense_sample=False, **NORMALS)
            for lib in (jconfigs, tconfigs)]


@pytest.fixture(scope="module")
def normals_step():
    return tfo.run_step(*_normals_configs())


def test_normals_step_matches_jax(normals_step):
    """Losses and every gradient, the tables included, of the tiny step
    with density and predicted normals on both fields, both normals' losses
    and contract_origin_grads."""
    tfo.check_step(normals_step, 1e-3, names=("orientation",
                                          "predicted_normals"))
    for v in normals_step["stats"]["losses"].values():
        assert float(v) > 0


def test_normals_losses_match_jax(rng):
    """orientation_loss (both targets) and predicted_normal_loss, values
    and the gradients w.r.t. the weights and both normals."""
    r, s, levels = 6, 7, 2
    hist = []
    for _ in range(levels):
        n = rng.normal(size=(3, r, s)).astype(np.float32)
        n_pred = rng.normal(size=(3, r, s)).astype(np.float32)
        hist.append(dict(weights=rng.uniform(0, 0.3, (r, s)).astype(
            np.float32), normals=n / np.linalg.norm(n, axis=0),
            normals_pred=n_pred / np.linalg.norm(n_pred, axis=0)))
    vd = rng.normal(size=(r, 3)).astype(np.float32)
    for target in ("normals", "normals_pred"):
        cfg_j, cfg_t = (lib.tiny(orientation_loss_target=target,
                                 **NORMAL_LOSSES)
                        for lib in (jconfigs, tconfigs))
        for name in ("orientation", "predicted"):
            def loss_j(h):
                if name == "orientation":
                    return jlosses.orientation_loss(
                        {"viewdirs": jnp.asarray(vd)}, h, cfg_j, levels)
                return jlosses.predicted_normal_loss(h, cfg_j, levels)
            hj = jax.tree.map(jnp.asarray, hist)
            want, gj = jax.value_and_grad(loss_j)(hj)
            ht = [{k: torch.from_numpy(v.copy()).requires_grad_()
                   for k, v in h.items()} for h in hist]
            got = (tlosses.orientation_loss(
                {"viewdirs": torch.from_numpy(vd)}, ht, cfg_t, levels)
                if name == "orientation"
                else tlosses.predicted_normal_loss(ht, cfg_t, levels))
            got.backward()
            np.testing.assert_allclose(float(got.detach()), float(want),
                                       rtol=1e-5)
            assert float(got.detach()) > 0
            for h_t, h_j in zip(ht, gj):
                for k, v in h_t.items():
                    w = np.asarray(h_j[k])
                    g = np.zeros_like(w) if v.grad is None else v.grad.numpy()
                    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7,
                                               err_msg=f"{name} {k}")


def _normals_field(contract=True):
    """The tiny NeRF field with density and predicted normals on both
    sides, random tables, and the field-options test's inputs."""
    cfg_j, cfg_t = (tfo._mlp_config(lib, contract_grads=contract, **NORMALS)
                    for lib in (jconfigs, tconfigs))
    rng, means, stds, vd, _ = tfo._inputs()
    mlp_j = jfields.ZipMLP(cfg_j)
    params = tfo._randomize(mlp_j.init(
        jax.random.PRNGKey(0), None, jnp.asarray(means), jnp.asarray(stds),
        viewdirs=jnp.asarray(vd))["params"], rng)
    mlp_t = tfields.ZipMLP(cfg_t, torch.Generator().manual_seed(0))
    mlp_t.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    probe = rng.normal(size=(3, tfo.R, tfo.S)).astype(np.float32)
    return mlp_j, params, mlp_t, (means, stds, vd), probe


def _normals_table_grad(mlp_t, inputs, probe):
    means, stds, vd = (torch.from_numpy(a) for a in inputs)
    mlp_t.zero_grad(set_to_none=True)
    out = mlp_t(means, stds, viewdirs=vd)
    (out["normals"] * torch.from_numpy(probe)).sum().backward()
    return out["normals"].detach().numpy(), mlp_t.table.grad.numpy().copy()


def test_double_backward_table_term(monkeypatch):
    """A loss of the density normals alone reaches the tables mostly
    through the second derivative: its table gradient matches JAX's, and
    with the table term of ``_GatherWSumBackward``'s backward dropped the
    comparison fails.  What is left is the first-order term of the erf
    weights, which depend on the contracted stds and so on the means: a few
    % of the table gradient (measured 1.1 %)."""
    mlp_j, params, mlp_t, inputs, probe = _normals_field()
    means, stds, vd = (jnp.asarray(a) for a in inputs)

    def loss_j(p):
        out = mlp_j.apply({"params": p}, None, means, stds, viewdirs=vd)
        return jnp.sum(out["normals"] * probe), out["normals"]

    (_, n_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(params)
    want = np.asarray(g_j["table"])
    scale = float(np.abs(want).max())
    assert scale > 0

    n_t, got = _normals_table_grad(mlp_t, inputs, probe)
    np.testing.assert_allclose(n_t, np.asarray(n_j), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3 * scale)

    backward = thash._GatherWSumBackward.backward

    def without_table_term(ctx, dd_table, dd_w):
        return (None,) + backward(ctx, dd_table, dd_w)[1:]

    monkeypatch.setattr(thash._GatherWSumBackward, "backward",
                        staticmethod(without_table_term))
    _, dropped = _normals_table_grad(mlp_t, inputs, probe)
    assert not np.allclose(dropped, want, rtol=1e-4, atol=1e-3 * scale)
    assert np.abs(dropped).max() < 0.1 * scale


@pytest.mark.parametrize("contract", [True, False])
def test_inner_gradient_skips_the_table_gradient(contract, monkeypatch):
    """The normals' inner gradient (the encoder's first backward, marked by
    the field) computes no table gradient; the loss's backward then
    computes it once, and the table's gradient is that of a forward whose
    normals are detached plus the second derivative's term.  Without the
    contraction's gradients the inner gradient never reaches the encoder,
    and the loss's backward still fills the table gradient."""
    _, _, mlp_t, inputs, probe = _normals_field(contract)
    calls = []
    table_grad = thash._table_grad

    def counted(*args, **kwargs):
        calls.append(1)
        return table_grad(*args, **kwargs)

    monkeypatch.setattr(thash, "_table_grad", counted)
    means, stds, vd = (torch.from_numpy(a) for a in inputs)
    out = mlp_t(means, stds, viewdirs=vd)
    assert not calls
    loss = out["density"].sum() + (out["normals"]
                                   * torch.from_numpy(probe)).sum()
    loss.backward()
    assert len(calls) == 1
    assert float(mlp_t.table.grad.abs().max()) > 0


def test_zero_normals_without_contraction_grads():
    """The JAX package stops gradients at the contraction's output
    (track_linearize_cm), so d raw_density / d means is zero and so are its
    density normals, unless contract_grads is on; the port matches both."""
    for contract in (False, True):
        mlp_j, params, mlp_t, inputs, _ = _normals_field(contract)
        out_j = mlp_j.apply({"params": params}, None,
                            *(jnp.asarray(a) for a in inputs[:2]),
                            viewdirs=jnp.asarray(inputs[2]))
        out_t = mlp_t(*(torch.from_numpy(a) for a in inputs[:2]),
                      viewdirs=torch.from_numpy(inputs[2]))
        n_j, n_t = np.asarray(out_j["normals"]), out_t["normals"].detach()
        if contract:
            np.testing.assert_allclose(np.linalg.norm(n_j, axis=0), 1.0,
                                       rtol=1e-5)
            np.testing.assert_allclose(n_t.numpy(), n_j, rtol=1e-4,
                                       atol=1e-3)
        else:
            assert not n_j.any() and not n_t.any()


def test_render_takes_the_normals_gradient_under_no_grad(normals_step,
                                                         monkeypatch):
    """The eval step (no_grad) renders the normals: the field takes the
    means' gradient under a local grad mode with the weights' gradient
    alone (no scatter runs), every K4 lookup keeps its rows (take_cm, not
    the fused take_wsum_cm), and the composited normals equal those of a
    forward in grad mode."""
    cfg = normals_step["cfg"]
    model = tstep.init_model(cfg, seed=0, device="cpu")
    model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, normals_step["params"])), strict=True)
    batch = {k: tt._t(v) for k, v in normals_step["batch"].items()}
    rand_vec = tt._t(normals_step["rand_vec"])
    renderings, _ = model(batch, 1.0, rand_vec, compute_extras=True,
                          eval_camidx=0)

    def boom(*args, **kwargs):
        raise AssertionError("a scatter or the fused gather ran")
    for name in ("scatter_add_cm", "scatter_add_wsum_cm",
                 "scatter_add_dense_cm", "scatter_add_wsum_packed_cm"):
        monkeypatch.setattr(thash.scatter, name, boom)
    monkeypatch.setattr(thash.gather, "take_wsum_cm", boom)
    out = tstep.make_eval_step(model, cfg)(batch, 1.0, 0, rand_vec)
    for k in ("normals", "normals_pred"):
        assert out[k].shape == (tt.RAYS, 3) and not out[k].requires_grad
        np.testing.assert_allclose(out[k].numpy(),
                                   renderings[-1][k].detach().numpy(),
                                   rtol=1e-6, atol=1e-7)
        assert out[k].abs().max() > 0
