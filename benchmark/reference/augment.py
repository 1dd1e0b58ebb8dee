"""The paired augmentation of the reference pipeline, plain float32: with
its pair's draw a pair gets one hue rotation (tf.image.adjust_hue: RGB to
HSV, the hue turned by `delta` of a full turn, back to RGB; alpha passes)
and one integer translation with zero fill (out[y, x] = in[y - sy, x - sx]),
or passes unchanged; then [0, 255] -> [-1, 1]."""

from __future__ import annotations

import torch


def adjust_hue(rgb, delta):
    """(B, H, W, 3) on any non-negative scale, delta (B,) turns."""
    r, g, b = rgb.unbind(-1)
    vmax = torch.maximum(torch.maximum(r, g), b)
    vmin = torch.minimum(torch.minimum(r, g), b)
    chroma = vmax - vmin
    safe = torch.where(chroma > 0, chroma, torch.ones_like(chroma))
    hue = torch.where(vmax == r, torch.remainder((g - b) / safe, 6.0),
                      torch.where(vmax == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    hue = torch.where(chroma > 0, hue, torch.zeros_like(hue))
    hue = torch.remainder(hue + 6.0 * delta.view(-1, 1, 1), 6.0)
    out = []
    for n in (5.0, 3.0, 1.0):
        k = torch.remainder(n + hue, 6.0)
        out.append(vmax - chroma * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0))
    return torch.stack(out, dim=-1)


def translate(img, sy, sx):
    """out[i, y, x] = img[i, y - sy[i], x - sx[i]], zero outside."""
    b, h, w, _ = img.shape
    ys = torch.arange(h, device=img.device)[None, :] - sy[:, None]
    xs = torch.arange(w, device=img.device)[None, :] - sx[:, None]
    inside = ((ys >= 0) & (ys < h))[:, :, None] & ((xs >= 0) & (xs < w))[:, None, :]
    rows = torch.arange(b, device=img.device)[:, None, None]
    moved = img[rows, ys.clamp(0, h - 1)[:, :, None], xs.clamp(0, w - 1)[:, None, :]]
    return torch.where(inside[..., None], moved, torch.zeros_like(moved))


def augment_pair(src_u8, tgt_u8, delta, sy, sx, keep):
    """Raw [0, 255] pairs -> augmented, normalized float32 pairs."""
    out = []
    for img in (src_u8, tgt_u8):
        x = img.float()
        turned = torch.cat([adjust_hue(x[..., :3], delta), x[..., 3:]], dim=-1)
        x = torch.where(keep.view(-1, 1, 1, 1), translate(turned, sy, sx), x)
        out.append(x / 127.5 - 1.0)
    return out[0], out[1]
