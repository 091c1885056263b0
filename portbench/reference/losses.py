"""Plain PyTorch UC-NeRF training losses of the benchmark's configurations:
the Charbonnier data term, the sky BCE, the affine identity pull, Zip-NeRF's
anti-aliased interlevel loss, mip-NeRF 360's distortion loss and the hash
decay, each times its configuration weight."""

from __future__ import annotations

import torch

from portbench.reference.model import sorted_interp_quad


def blur_stepfun(x, y, r):
    xr, order = torch.sort(torch.cat([x - r, x + r], dim=-1), dim=-1,
                           stable=True)
    zeros = torch.zeros_like(y[..., :1])
    y1 = (torch.cat([y, zeros], dim=-1) - torch.cat([zeros, y], dim=-1)) \
        / (2 * r)
    y2 = torch.gather(torch.cat([y1, -y1], dim=-1), -1, order[..., :-1])
    yr = torch.clamp(torch.cumsum((xr[..., 1:] - xr[..., :-1])
                                  * torch.cumsum(y2, dim=-1), dim=-1),
                     min=0.0)
    return xr, torch.cat([torch.zeros_like(yr[..., :1]), yr], dim=-1)


def distortion(t, w):
    ut = (t[..., 1:] + t[..., :-1]) / 2
    dut = torch.abs(ut[..., :, None] - ut[..., None, :])
    inter = torch.sum(w * torch.sum(w[..., None, :] * dut, dim=-1), dim=-1)
    intra = torch.sum(w**2 * (t[..., 1:] - t[..., :-1]), dim=-1) / 3
    return inter + intra


def all_losses(cfg, rays, renderings, history):
    """{term: scalar} in the port's order."""
    unused = [k for k in ("interlevel_loss_mult", "opacity_loss_mult",
                          "orientation_loss_mult",
                          "orientation_coarse_loss_mult",
                          "predicted_normal_loss_mult",
                          "predicted_normal_coarse_loss_mult")
              if cfg[k] > 0]
    if unused or cfg["data_loss_type"] != "charb":
        raise NotImplementedError(f"the reference has no {unused} and only "
                                  f"the Charbonnier data loss")
    out = {}
    target = rays["rgb"][..., :3]
    mult = torch.broadcast_to(rays["lossmult"], target.shape)
    denom = mult.sum()
    data = [(mult * torch.sqrt((r["rgb"] - target) ** 2
                               + cfg["charb_padding"] ** 2)).sum() / denom
            for r in renderings]
    out["data"] = (cfg["data_coarse_loss_mult"] * sum(data[:-1])
                   + cfg["data_loss_mult"] * data[-1])
    if cfg["model_sky"]:
        sky_target = 1.0 - rays["sky_segs"]
        total = 0.0
        for r in renderings:
            acc = torch.clamp(r["weights"].sum(dim=-1), 1e-3, 1 - 1e-3)
            total += -(sky_target * torch.log(acc)
                       + (1 - sky_target) * torch.log(1 - acc)).mean()
        out["sky_segments"] = cfg["sky_weight"] * total
    if cfg["brightness_correction"]:
        aff = renderings[0]["affine"]
        eye = torch.eye(4, dtype=aff.dtype, device=aff.device)[None, :3, :]
        loss = torch.abs(eye - aff)
        if renderings[0]["affine_sky"] is not None:
            loss = loss + torch.abs(eye - renderings[0]["affine_sky"])
        out["identity"] = cfg["idt_weight"] * loss.mean()
    if cfg["anti_interlevel_loss_mult"] > 0 and len(history) > 1:
        c = history[-1]["sdist"].detach()
        w = history[-1]["weights"].detach()
        w_norm = w / (c[..., 1:] - c[..., :-1])
        total = 0.0
        for i, h in enumerate(history[:-1]):
            c_, w_ = blur_stepfun(c, w_norm, cfg["pulse_width"][i])
            area = 0.5 * (w_[..., 1:] + w_[..., :-1]) * (c_[..., 1:]
                                                         - c_[..., :-1])
            cdf = torch.cat([torch.zeros_like(area[..., :1]),
                             torch.cumsum(area, dim=-1)], dim=-1)
            w_s = torch.diff(sorted_interp_quad(h["sdist"], c_, w_, cdf),
                             dim=-1)
            total += (torch.clamp(w_s - h["weights"], min=0.0) ** 2
                      / (h["weights"] + 1e-5)).mean()
        out["anti_interlevel"] = cfg["anti_interlevel_loss_mult"] * total
    if cfg["distortion_loss_mult"] > 0:
        out["distortion"] = cfg["distortion_loss_mult"] * distortion(
            history[-1]["sdist"], history[-1]["weights"]).mean()
    if cfg["hash_decay_mults"] > 0:
        out["hash_decay"] = sum(cfg["hash_decay_mults"] * h["hash_decay"]
                                for h in history)
    return out
