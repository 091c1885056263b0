"""Visualization: depth/acc colormaps, render panels, ray histograms and
8-bit PNG output (port of ``ucnerf_tpu/utils/vis.py``).

Percentile-normalized, curve-warped depth colormaps with weight-aware
normalization, acc panels, ``visualize_suite`` assembling them from a
rendering dict, and the per-level ray histograms; everything works on host
numpy arrays, and ``visualize_rays`` resamples with the port's
``stepfun.resample`` (torch on the CPU).

Two of the JAX module's libraries are not on every machine the port runs
on, so the port carries their part itself: turbo, the colormap every CLI
asks for, is a 256-entry constant (matplotlib's ``turbo``, the only other
colormap source, is still used for any other name), and ``save_image_u8``
writes the PNG with ``zlib`` and ``struct`` instead of Pillow.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from ucnerf_tpu_torch.ops import stepfun

# matplotlib's turbo colormap (Google's polynomial turbo, 256 entries):
# r, g, b of each entry in units of 1e-5.
_TURBO_1E5 = """
    18995 07176 23217 19483 08339 26149 19956 09498 29024 20415 10652 31844
    20860 11802 34607 21291 12947 37314 21708 14087 39964 22111 15223 42558
    22500 16354 45096 22875 17481 47578 23236 18603 50004 23582 19720 52373
    23915 20833 54686 24234 21941 56942 24539 23044 59142 24830 24143 61286
    25107 25237 63374 25369 26327 65406 25618 27412 67381 25853 28492 69300
    26074 29568 71162 26280 30639 72968 26473 31706 74718 26652 32768 76412
    26816 33825 78050 26967 34878 79631 27103 35926 81156 27226 36970 82624
    27334 38008 84037 27429 39043 85393 27509 40072 86692 27576 41097 87936
    27628 42118 89123 27667 43134 90254 27691 44145 91328 27701 45152 92347
    27698 46153 93309 27680 47151 94214 27648 48144 95064 27603 49132 95857
    27543 50115 96594 27469 51094 97275 27381 52069 97899 27273 53040 98461
    27106 54015 98930 26878 54995 99303 26592 55979 99583 26252 56967 99773
    25862 57958 99876 25425 58950 99896 24946 59943 99835 24427 60937 99697
    23874 61931 99485 23288 62923 99202 22676 63913 98851 22039 64901 98436
    21382 65886 97959 20708 66866 97423 20021 67842 96833 19326 68812 96190
    18625 69775 95498 17923 70732 94761 17223 71680 93981 16529 72620 93161
    15844 73551 92305 15173 74472 91416 14519 75381 90496 13886 76279 89550
    13278 77165 88580 12698 78037 87590 12151 78896 86581 11639 79740 85559
    11167 80569 84525 10738 81381 83484 10357 82177 82437 10026 82955 81389
    09750 83714 80342 09532 84455 79299 09377 85175 78264 09287 85875 77240
    09267 86554 76230 09320 87211 75237 09451 87844 74265 09662 88454 73316
    09958 89040 72393 10342 89600 71500 10815 90142 70599 11374 90673 69651
    12014 91193 68660 12733 91701 67627 13526 92197 66556 14391 92680 65448
    15323 93151 64308 16319 93609 63137 17377 94053 61938 18491 94484 60713
    19659 94901 59466 20877 95304 58199 22142 95692 56914 23449 96065 55614
    24797 96423 54303 26180 96765 52981 27597 97092 51653 29042 97403 50321
    30513 97697 48987 32006 97974 47654 33517 98234 46325 35043 98477 45002
    36581 98702 43688 38127 98909 42386 39678 99098 41098 41229 99268 39826
    42778 99419 38575 44321 99551 37345 45854 99663 36140 47375 99755 34963
    48879 99828 33816 50362 99879 32701 51822 99910 31622 53255 99919 30581
    54658 99907 29581 56026 99873 28623 57357 99817 27712 58646 99739 26849
    59891 99638 26038 61088 99514 25280 62233 99366 24579 63323 99195 23937
    64362 98999 23356 65394 98775 22835 66428 98524 22370 67462 98246 21960
    68494 97941 21602 69525 97610 21294 70553 97255 21032 71577 96875 20815
    72596 96470 20640 73610 96043 20504 74617 95593 20406 75617 95121 20343
    76608 94627 20311 77591 94113 20310 78563 93579 20336 79524 93025 20386
    80473 92452 20459 81410 91861 20552 82333 91253 20663 83241 90627 20788
    84133 89986 20926 85010 89328 21074 85868 88655 21230 86709 87968 21391
    87530 87267 21555 88331 86553 21719 89112 85826 21880 89870 85087 22038
    90605 84337 22188 91317 83576 22328 92004 82806 22456 92666 82025 22570
    93301 81236 22667 93909 80439 22744 94489 79634 22800 95039 78823 22831
    95560 78005 22836 96049 77181 22811 96507 76352 22754 96931 75519 22663
    97323 74682 22536 97679 73842 22369 98000 73000 22161 98289 72140 21918
    98549 71250 21650 98781 70330 21358 98986 69382 21043 99163 68408 20706
    99314 67408 20348 99438 66386 19971 99535 65341 19577 99607 64277 19165
    99654 63193 18738 99675 62093 18297 99672 60977 17842 99644 59846 17376
    99593 58703 16899 99517 57549 16412 99419 56386 15918 99297 55214 15417
    99153 54036 14910 98987 52854 14398 98799 51667 13883 98590 50479 13367
    98360 49291 12849 98108 48104 12332 97837 46920 11817 97545 45740 11305
    97234 44565 10797 96904 43399 10294 96555 42241 09798 96187 41093 09310
    95801 39958 08831 95398 38836 08362 94977 37729 07905 94538 36638 07461
    94084 35566 07031 93612 34513 06616 93125 33482 06218 92623 32473 05837
    92105 31489 05475 91572 30530 05134 91024 29599 04814 90463 28696 04516
    89888 27824 04243 89298 26981 03993 88691 26152 03753 88066 25334 03521
    87422 24526 03297 86760 23730 03082 86079 22945 02875 85380 22170 02677
    84662 21407 02487 83926 20654 02305 83172 19912 02131 82399 19182 01966
    81608 18462 01809 80799 17753 01660 79971 17055 01520 79125 16368 01387
    78260 15693 01264 77377 15028 01148 76476 14374 01041 75556 13731 00942
    74617 13098 00851 73661 12477 00769 72686 11867 00695 71692 11268 00629
    70680 10680 00571 69650 10102 00522 68602 09536 00481 67535 08980 00449
    66449 08436 00424 65345 07902 00408 64223 07380 00401 63082 06868 00401
    61923 06367 00410 60746 05878 00427 59550 05399 00453 58336 04931 00486
    57103 04474 00529 55852 04028 00579 54583 03593 00638 53295 03169 00705
    51989 02756 00780 50664 02354 00863 49321 01963 00955 47960 01583 01055
"""


def _turbo_lut() -> np.ndarray:
    return (np.array(_TURBO_1E5.split(), np.int64) / 1e5).reshape(256, 3)


def _colormap_lut(name: str, n: int = 256) -> np.ndarray:
    if name == "turbo" and n == 256:
        return _turbo_lut()
    import matplotlib
    return np.asarray(matplotlib.colormaps[name](np.linspace(0, 1, n)))[:, :3]


def apply_colormap(x, cmap: str = "turbo"):
    """Map x in [0, 1] -> rgb via a colormap LUT."""
    lut = _colormap_lut(cmap)
    idx = np.clip((np.asarray(x) * (len(lut) - 1)).astype(np.int32), 0,
                  len(lut) - 1)
    return lut[idx]


def weighted_percentile(x, w, ps, assume_sorted=False):
    """Percentiles of x, weighted by w (vis.py:21-31)."""
    x = np.asarray(x).reshape(-1)
    w = np.asarray(w).reshape(-1)
    if not assume_sorted:
        order = np.argsort(x)
        x, w = x[order], w[order]
    acc_w = np.cumsum(w)
    return np.interp(np.asarray(ps) / 100 * acc_w[-1], acc_w, x)


def visualize_cmap(value, weight, colormap="turbo", lo=None, hi=None,
                   percentile=99.0, curve_fn=lambda x: -np.log(x + np.finfo(
                       np.float32).eps), matte_background=True):
    """Weight-aware, curve-warped scalar visualization (vis.py:34-91)."""
    lo_auto, hi_auto = weighted_percentile(
        value, weight, [50 - percentile / 2, 50 + percentile / 2])
    lo = lo or (lo_auto - np.finfo(np.float32).eps)
    hi = hi or (hi_auto + np.finfo(np.float32).eps)
    value, lo, hi = [curve_fn(x) for x in [value, lo, hi]]
    value = np.nan_to_num(
        np.clip((value - np.minimum(lo, hi)) / np.abs(hi - lo), 0, 1))
    if colormap:
        colorized = apply_colormap(value, colormap)
    else:
        colorized = np.stack([value] * 3, axis=-1)
    if matte_background:
        w = np.asarray(weight)[..., None]
        colorized = colorized * w + (1 - w)
    return colorized


def _resample_avg(t, tp, vp):
    """``stepfun.resample(..., use_avg=True)`` on float32 numpy arrays."""
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return stepfun.resample(f32(t), f32(tp), f32(vp), use_avg=True).numpy()


def visualize_rays(dist, dist_range, weights, rgbs, accumulate=False,
                   renormalize=False, resolution=512, bg_color=0.8):
    """Ray-histogram strip image (vis.py:100-153).

    Each sampling level's step functions (per-ray knots `dist`, values
    `weights`/`rgbs`) are resampled onto a common `resolution`-bin axis and
    stacked into an image: one pixel row per (ray, level), color = rgb,
    alpha = weight, matted over `bg_color`.

    Args:
      dist: list per level of [n, S_l + 1] sorted knots.
      dist_range: (lo, hi) of the common axis.
      weights: list per level of [n, S_l].
      rgbs: list per level of [n, S_l, 3] (values in [0, 1]).

    Returns:
      (vis [rows, resolution, 3], alpha [rows, resolution]).
    """
    dist_vis = np.linspace(*dist_range, resolution + 1).astype(np.float32)
    rows_rgb, rows_alpha = [], []
    n = dist[0].shape[0]
    for ray in range(n):
        for d, w, r in zip(dist, weights, rgbs):
            dd = np.asarray(d[ray], np.float32)
            ww = np.asarray(w[ray], np.float32)
            rr = np.asarray(r[ray], np.float32)
            if accumulate:
                eps = np.finfo(np.float32).eps
                w_csum = np.cumsum(ww, axis=0)
                rw_csum = np.cumsum(rr * ww[:, None], axis=0)
                rr = (rw_csum + eps) / (w_csum[:, None] + 2 * eps)
                ww = w_csum
            vis_r = _resample_avg(dist_vis[None], dd[None], rr.T).T
            vis_w = _resample_avg(dist_vis[None], dd[None], ww[None])[0]
            rows_rgb.append(vis_r)
            rows_alpha.append(vis_w)
        # Separator row between rays.
        rows_rgb.append(np.zeros((resolution, 3), np.float32))
        rows_alpha.append(np.zeros((resolution,), np.float32))
    vis_rgb = np.stack(rows_rgb[:-1])
    vis_alpha = np.stack(rows_alpha[:-1])
    if renormalize:
        vis_alpha = vis_alpha / max(np.finfo(np.float32).eps,
                                    vis_alpha.max())
    vis = (vis_rgb * vis_alpha[..., None]
           + bg_color * (1 - vis_alpha)[..., None])
    return vis, vis_alpha


def visualize_ray_histograms(ray_history, num_rays=64, repeat=4):
    """Assemble the two reference ray panels (vis.py:193-221) from a model's
    ray_history: per-level colors along each ray, and sqrt-weight density.

    ray_history: list per level of dicts of host arrays with 'sdist'
    [n, S+1], 'weights' [n, S] and channel-major 'rgb' [3, n, S] (prop
    levels carry no rgb: white is substituted, as the reference plots
    ray_rgbs only for levels that have them).
    """
    n = min(num_rays, ray_history[0]["sdist"].shape[0])
    dist = [np.asarray(h["sdist"][:n]) for h in ray_history]
    weights = [np.asarray(h["weights"][:n]) for h in ray_history]
    rgbs = []
    for h in ray_history:
        if h.get("rgb") is not None:
            rgbs.append(np.clip(
                np.moveaxis(np.asarray(h["rgb"])[:, :n], 0, -1), 0, 1))
        else:
            rgbs.append(np.ones(weights[len(rgbs)].shape + (3,), np.float32))

    ray_colors, _ = visualize_rays(dist, (0.0, 1.0), weights, rgbs)
    sqrt_w = [np.sqrt(w) for w in weights]
    ray_density, alpha = visualize_rays(
        dist, (0.0, 1.0), [np.ones_like(w) for w in sqrt_w],
        [np.repeat(w[..., None], 3, axis=-1) for w in sqrt_w], bg_color=0.0)
    # Alpha==0 bins render red, like the reference's null_color.
    ray_density = np.where(alpha[..., None] == 0,
                           np.array([1.0, 0.0, 0.0]), ray_density)
    rep = lambda img: np.repeat(img, repeat, axis=0)
    return {"ray_colors": rep(ray_colors),
            "ray_weights": rep(ray_density)}


def visualize_suite(rendering):
    """Assemble the standard panel dict from a rendering (vis.py:156-246)."""
    out = {}
    depth = rendering.get("distance_mean", rendering.get("depth"))
    acc = rendering["acc"]
    if depth is not None:
        out["color"] = np.clip(rendering["rgb"], 0, 1)
        out["depth"] = visualize_cmap(depth, np.ones_like(acc))
        out["depth_matted"] = visualize_cmap(depth, acc)
    if "distance_median" in rendering:
        out["depth_median"] = visualize_cmap(rendering["distance_median"],
                                             np.ones_like(acc))
    out["acc"] = np.stack([np.clip(acc, 0, 1)] * 3, axis=-1)
    for k in rendering:
        if k.startswith("normals"):
            out[k] = np.asarray(rendering[k]) / 2.0 + 0.5
    return out


# PNG color types by channel count: gray, RGB, RGBA.
_PNG_COLOR_TYPE = {1: 0, 3: 2, 4: 6}


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png_u8(img_u8: np.ndarray) -> bytes:
    """An 8-bit PNG of a uint8 [H, W] (gray) or [H, W, 3|4] image: one IDAT
    chunk, every scanline with filter type 0."""
    h, w = img_u8.shape[:2]
    channels = 1 if img_u8.ndim == 2 else img_u8.shape[2]
    if img_u8.ndim not in (2, 3) or channels not in _PNG_COLOR_TYPE:
        raise ValueError(f"no PNG layout for an image of shape "
                         f"{img_u8.shape}")
    rows = np.ascontiguousarray(img_u8, np.uint8).reshape(h, w * channels)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[channels],
                         0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def save_image_u8(path, img):
    """Write img (values in [0, 1]) as an 8-bit PNG, each value scaled by
    255 and truncated as the JAX package's Pillow path does."""
    img_u8 = (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png_u8(img_u8))
