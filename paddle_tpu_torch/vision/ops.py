"""Detection ops (port of ``paddle_tpu.vision.ops``: ``nms``,
``box_coder``, ``roi_align`` and ``deform_conv2d``).

JAX computes them with numpy or ``jnp`` outside any Pallas kernel, so here
they are torch ops on the tensors' device: gathers, elementwise arithmetic
and one matrix product.  Boxes are ``[x1, y1, x2, y2]``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["nms", "box_coder", "roi_align", "deform_conv2d"]


def _pair(v):
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(a) for a in v)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Greedy non-maximum suppression (JAX ``ops.py:16``): boxes in order
    of falling ``scores`` (index order without them; the sort is stable, so
    equal scores keep index order), each kept box dropping the later ones
    whose IoU with it, inter / (a1 + a2 - inter + 1e-10), exceeds
    ``iou_threshold``.  Returns the kept indices, at most ``top_k``, as
    int64 on the boxes' device.  Like JAX's, it takes and ignores
    ``category_idxs`` and ``categories``.  The [N, N] IoU matrix is
    computed on the device in one pass; the greedy walk over it runs on the
    host."""
    n = boxes.shape[0]
    if scores is None:
        order = torch.arange(n, device=boxes.device)
    else:
        order = torch.sort(scores, descending=True, stable=True).indices
    b = boxes[order]
    x1, y1, x2, y2 = b.unbind(1)
    area = (x2 - x1) * (y2 - y1)
    inter = ((torch.minimum(x2[:, None], x2[None, :])
              - torch.maximum(x1[:, None], x1[None, :])).clamp_min(0)
             * (torch.minimum(y2[:, None], y2[None, :])
                - torch.maximum(y1[:, None], y1[None, :])).clamp_min(0))
    iou = inter / (area[:, None] + area[None, :] - inter + 1e-10)
    over = (~(iou <= iou_threshold)).cpu().numpy()
    dropped = np.zeros(n, bool)
    keep = []
    for i in range(n):
        if not dropped[i]:
            keep.append(i)
            dropped |= over[i]
    if top_k:
        keep = keep[:top_k]
    return order[torch.as_tensor(keep, dtype=torch.int64,
                                 device=boxes.device)]


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0):
    """Encode boxes against priors, or decode deltas (JAX ``ops.py:42``).

    ``encode_center_size``: targets [N, 4] against priors [M, 4] -> [N, M,
    4] deltas (centre offsets over the prior's size, log size ratios),
    divided by the variance.  ``decode_center_size``: deltas [N, M, 4] (or
    broadcastable), times the variance, -> boxes; ``axis`` says which
    delta axis indexes the priors (0: the second, 1: the first).  The
    variance is a [M, 4] tensor, a 4-float list for every prior, or None;
    ``box_normalized=False`` adds 1 to widths and heights."""
    if isinstance(prior_box_var, (list, tuple)):
        prior_box_var = torch.as_tensor(
            prior_box_var, dtype=torch.float32,
            device=prior_box.device).expand(prior_box.shape[0], 4)
    pv = prior_box_var
    norm = 0.0 if box_normalized else 1.0
    pw = prior_box[:, 2] - prior_box[:, 0] + norm
    ph = prior_box[:, 3] - prior_box[:, 1] + norm
    pcx = prior_box[:, 0] + pw * 0.5
    pcy = prior_box[:, 1] + ph * 0.5
    if code_type in ("encode_center_size", "EncodeCenterSize"):
        t = target_box
        tw = t[:, 2] - t[:, 0] + norm
        th = t[:, 3] - t[:, 1] + norm
        tcx = t[:, 0] + tw * 0.5
        tcy = t[:, 1] + th * 0.5
        out = torch.stack([(tcx[:, None] - pcx[None, :]) / pw[None, :],
                           (tcy[:, None] - pcy[None, :]) / ph[None, :],
                           torch.log(tw[:, None] / pw[None, :]),
                           torch.log(th[:, None] / ph[None, :])], dim=-1)
        return out if pv is None else out / pv[None, :, :]
    t = target_box
    if pv is not None:
        if pv.dim() == 2:
            pv = pv[None, :, :] if axis == 0 else pv[:, None, :]
        t = t * pv
    if axis == 0:
        pw_, ph_, pcx_, pcy_ = (a[None, :] for a in (pw, ph, pcx, pcy))
    else:
        pw_, ph_, pcx_, pcy_ = (a[:, None] for a in (pw, ph, pcx, pcy))
    cx = t[..., 0] * pw_ + pcx_
    cy = t[..., 1] * ph_ + pcy_
    w = torch.exp(t[..., 2]) * pw_
    h = torch.exp(t[..., 3]) * ph_
    return torch.stack([cx - w * 0.5, cy - h * 0.5,
                        cx + w * 0.5 - norm, cy + h * 0.5 - norm], dim=-1)


# elements of one gathered corner of a ROI chunk (f32: 512 MiB)
_ROI_CHUNK = 1 << 27


def _roi_samples(xt, img, y1, x1, bin_h, bin_w, ph, pw, ns):
    """Bilinear samples of the ROIs ``img`` (their image indices) on an
    ns x ns grid a bin, averaged: [G, C, ph, pw].  ``xt`` is the map
    channel-last, [B, H, W, C].  Coordinates are clamped into the map, as
    JAX's sampler does (``ops.py:141-149``)."""
    _, H, W, C = xt.shape
    grid = (torch.arange(ns, device=xt.device, dtype=xt.dtype) + 0.5) / ns

    def axis(start, size, n_bins, n_max):
        pos = torch.arange(n_bins, device=xt.device,
                           dtype=xt.dtype)[:, None] + grid[None, :]
        p = start[:, None] + pos.reshape(-1)[None, :] * size[:, None]
        lo = torch.floor(p).clamp(0, n_max - 1)
        w1 = (p - lo).clamp(0.0, 1.0)
        return (lo.long(), (lo + 1).clamp(0, n_max - 1).long(), 1.0 - w1,
                w1)

    y0, y1i, wy0, wy1 = axis(y1, bin_h, ph, H)
    x0, x1i, wx0, wx1 = axis(x1, bin_w, pw, W)
    b = img[:, None, None]
    out = 0.0
    for yi, wy in ((y0, wy0), (y1i, wy1)):
        for xi, wx in ((x0, wx0), (x1i, wx1)):
            v = xt[b, yi[:, :, None], xi[:, None, :]]       # [G, Sy, Sx, C]
            out = out + v * (wy[:, :, None] * wx[:, None, :])[..., None]
    G = out.shape[0]
    out = out.reshape(G, ph, ns, pw, ns, C).mean(dim=(2, 4))
    return out.permute(0, 3, 1, 2)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True):
    """RoIAlign (JAX ``ops.py:95``): x [B, C, H, W], boxes [R, 4] in image
    coordinates, ``boxes_num`` [B] ROIs an image (in order) -> [R, C, ph,
    pw].  Each bin averages an ns x ns grid of bilinear samples; ``aligned``
    shifts the scaled box by -0.5 (without it a box is at least 1 x 1).
    With ``sampling_ratio`` > 0 every ROI takes ns = ``sampling_ratio``;
    otherwise ns = max(1, ceil(h / ph), ceil(w / pw)) of its scaled size,
    as JAX's eager path picks it: the boxes are read to the host once, and
    the ROIs that share an ns are sampled together (in chunks of at most
    ``_ROI_CHUNK`` elements a corner)."""
    ph, pw = (output_size, output_size) if isinstance(output_size, int) \
        else tuple(output_size)
    R = boxes.shape[0]
    if sampling_ratio > 0:
        ns_per_roi = np.full(R, int(sampling_ratio))
    else:
        bnp = boxes.detach().float().cpu().numpy()
        rh = (bnp[:, 3] - bnp[:, 1]) * spatial_scale
        rw = (bnp[:, 2] - bnp[:, 0]) * spatial_scale
        ns_per_roi = np.array([max(1, int(max(math.ceil(float(rh[r]) / ph),
                                              math.ceil(float(rw[r]) / pw))))
                               for r in range(R)], np.int64)
    cum = torch.cumsum(boxes_num.to(boxes.device).long(), 0)
    img = (torch.arange(R, device=boxes.device)[:, None]
           >= cum[None, :]).sum(1)
    off = 0.5 if aligned else 0.0
    bx = boxes * spatial_scale - off
    x1, y1, x2, y2 = bx.unbind(1)
    rw_, rh_ = x2 - x1, y2 - y1
    if not aligned:
        rw_, rh_ = rw_.clamp_min(1.0), rh_.clamp_min(1.0)
    bin_h, bin_w = rh_ / ph, rw_ / pw
    xt = x.permute(0, 2, 3, 1)
    C = x.shape[1]
    parts, order = [], []
    for ns in sorted(set(ns_per_roi.tolist())):
        idx = np.nonzero(ns_per_roi == ns)[0]
        step = max(1, _ROI_CHUNK // (ph * ns * pw * ns * C))
        for s in range(0, len(idx), step):
            sel = torch.as_tensor(idx[s:s + step], device=boxes.device)
            parts.append(_roi_samples(xt, img[sel], y1[sel], x1[sel],
                                      bin_h[sel], bin_w[sel], ph, pw, ns))
            order.append(idx[s:s + step])
    if not parts:
        return x.new_zeros((0, C, ph, pw))
    inverse = np.empty(R, np.int64)
    inverse[np.concatenate(order)] = np.arange(R)
    return torch.cat(parts)[torch.as_tensor(inverse, device=x.device)]


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None):
    """Deformable convolution v1 / v2 (JAX ``ops.py:181``): x [B, C, H, W],
    offset [B, 2 dg kh kw, Ho, Wo] laid out [B, dg, kh kw, 2, Ho, Wo] (dy
    first), weight [Co, C / groups, kh, kw], the v2 ``mask`` [B, dg kh kw,
    Ho, Wo].  Each tap of each output position samples its deformable
    group's channels bilinearly at the base position plus its offset (taps
    outside the map read 0), times the mask; the column matrix [B, groups,
    C / groups kh kw, Ho Wo] times the weight (``torch.matmul``: JAX's
    product lies outside any kernel too), plus the bias.  Gradients reach
    x, offset, weight, mask and bias."""
    s, p, d = _pair(stride), _pair(padding), _pair(dilation)
    B, C, H, W = x.shape
    Co, Cg, kh, kw = weight.shape
    Ho = (H + 2 * p[0] - d[0] * (kh - 1) - 1) // s[0] + 1
    Wo = (W + 2 * p[1] - d[1] * (kw - 1) - 1) // s[1] + 1
    dg = deformable_groups
    cpg = C // dg
    dev, dt = x.device, x.dtype

    def base(n_out, st, pd, k, dl):
        return (torch.arange(n_out, device=dev) * st - pd)[None, :] \
            + (torch.arange(k, device=dev) * dl)[:, None]     # [k, n_out]

    by = base(Ho, s[0], p[0], kh, d[0])[:, None, :, None].expand(
        kh, kw, Ho, Wo).reshape(kh * kw, Ho, Wo)
    bx = base(Wo, s[1], p[1], kw, d[1])[None, :, None, :].expand(
        kh, kw, Ho, Wo).reshape(kh * kw, Ho, Wo)
    off = offset.reshape(B, dg, kh * kw, 2, Ho, Wo)
    yy = (by.to(dt) + off[:, :, :, 0]).reshape(B, dg, -1)    # [B, dg, L]
    xx = (bx.to(dt) + off[:, :, :, 1]).reshape(B, dg, -1)
    y0, x0 = torch.floor(yy), torch.floor(xx)
    wy1, wx1 = yy - y0, xx - x0
    flat = x.reshape(B, dg, cpg, H * W)
    L = yy.shape[-1]
    col = 0.0
    for yi, wy in ((y0, 1.0 - wy1), (y0 + 1, wy1)):
        for xi, wx in ((x0, 1.0 - wx1), (x0 + 1, wx1)):
            valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            at = (yi.clamp(0, H - 1).long() * W
                  + xi.clamp(0, W - 1).long())                # [B, dg, L]
            v = torch.gather(flat, 3, at[:, :, None, :].expand(B, dg, cpg, L))
            col = col + v * (wy * wx * valid)[:, :, None, :]
    if mask is not None:
        col = col * mask.reshape(B, dg, 1, L)
    col = col.reshape(B, groups, Cg * kh * kw, Ho * Wo)
    out = torch.matmul(weight.reshape(groups, Co // groups, Cg * kh * kw),
                       col).reshape(B, Co, Ho, Wo)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out
