"""Vision transforms (port of ``paddle_tpu.vision.transforms``): host-side
numpy preprocessing, HWC (uint8 or float) in, and ``ToTensor``'s CHW f32
torch tensor out on ``resolve_device(device)``.

The numpy bodies are the port's own copy of the JAX package's (which does
not import JAX).  One difference: every random transform draws from the
``numpy.random.RandomState`` it is given as ``rng`` (its own unseeded one
when None), not from numpy's global state, and makes the calls that the
JAX transform makes on numpy's global state, in the same order: JAX
seeded with ``np.random.seed(s)`` and the port given ``RandomState(s)``
make the same draws.  ``ColorJitter`` hands its ``rng`` to the four
jitters it composes.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device

__all__ = ["Compose", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomHorizontalFlip", "RandomCrop", "RandomResizedCrop",
           "Transpose"]


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


def _rng(rng):
    return rng if rng is not None else np.random.RandomState()


class ToTensor:
    """An HWC image (or HW) over 255 as f32, CHW unless ``data_format`` is
    ``"HWC"``, as a torch tensor on ``device`` (``None``: the CUDA device,
    raising without one)."""

    def __init__(self, data_format="CHW", device=None):
        self.data_format = data_format
        self.device = resolve_device(device)

    def __call__(self, img):
        arr = np.asarray(img, dtype=np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if self.data_format == "CHW":
            arr = arr.transpose(2, 0, 1)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self.data_format = data_format

    def __call__(self, img):
        """A torch tensor is normalised on its device and stays a tensor;
        anything else becomes an f32 numpy array."""
        shape = (-1, 1, 1) if self.data_format == "CHW" else (1, 1, -1)
        mean, std = self.mean.reshape(shape), self.std.reshape(shape)
        if isinstance(img, torch.Tensor):
            return (img - torch.from_numpy(mean).to(img.device)) \
                / torch.from_numpy(std).to(img.device)
        return (np.asarray(img, np.float32) - mean) / std


def _resize_np(arr, size):
    h, w = arr.shape[:2]
    if isinstance(size, int):
        if h < w:
            nh, nw = size, int(w * size / h)
        else:
            nh, nw = int(h * size / w), size
    else:
        nh, nw = size
    ys = (np.arange(nh) * (h / nh)).astype(np.int64).clip(0, h - 1)
    xs = (np.arange(nw) * (w / nw)).astype(np.int64).clip(0, w - 1)
    return arr[ys][:, xs]


class Resize:
    def __init__(self, size, interpolation="bilinear"):
        self.size = size

    def __call__(self, img):
        return _resize_np(np.asarray(img), self.size)


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else size

    def __call__(self, img):
        arr = np.asarray(img)
        h, w = arr.shape[:2]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return arr[i:i + th, j:j + tw]


class RandomHorizontalFlip:
    def __init__(self, prob=0.5, rng=None):
        self.prob = prob
        self.rng = _rng(rng)

    def __call__(self, img):
        if self.rng.rand() < self.prob:
            return np.asarray(img)[:, ::-1].copy()
        return np.asarray(img)


class RandomCrop:
    def __init__(self, size, padding=None, rng=None):
        self.size = (size, size) if isinstance(size, int) else size
        self.padding = padding
        self.rng = _rng(rng)

    def __call__(self, img):
        arr = np.asarray(img)
        if self.padding:
            p = self.padding
            arr = np.pad(arr, ((p, p), (p, p)) + ((0, 0),) * (arr.ndim - 2))
        h, w = arr.shape[:2]
        th, tw = self.size
        i = self.rng.randint(0, max(h - th, 0) + 1)
        j = self.rng.randint(0, max(w - tw, 0) + 1)
        return arr[i:i + th, j:j + tw]


class RandomResizedCrop:
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 rng=None):
        self.size = (size, size) if isinstance(size, int) else size
        self.scale = scale
        self.ratio = ratio
        self.rng = _rng(rng)

    def __call__(self, img):
        arr = np.asarray(img)
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * self.rng.uniform(*self.scale)
            ar = self.rng.uniform(*self.ratio)
            tw = int(round(np.sqrt(target * ar)))
            th = int(round(np.sqrt(target / ar)))
            if 0 < tw <= w and 0 < th <= h:
                i = self.rng.randint(0, h - th + 1)
                j = self.rng.randint(0, w - tw + 1)
                return _resize_np(arr[i:i + th, j:j + tw], self.size)
        return _resize_np(arr, self.size)


class Transpose:
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        return np.asarray(img).transpose(self.order)


# -- the colour jitters, rotation, pad, grayscale, vertical flip, erasing ---
def _as_float_hwc(img):
    arr = np.asarray(img)
    was_uint8 = arr.dtype == np.uint8
    a = arr.astype(np.float32)
    return a, was_uint8


def _restore(a, was_uint8):
    if was_uint8:
        return np.clip(a, 0, 255).astype(np.uint8)
    return a


def adjust_brightness(img, factor):
    """reference functional.adjust_brightness: pixel * factor."""
    a, u8 = _as_float_hwc(img)
    return _restore(a * float(factor), u8)


def adjust_contrast(img, factor):
    """Blend with the mean GRAYSCALE level (reference functional
    adjust_contrast uses the luma mean, not the raw RGB mean)."""
    a, u8 = _as_float_hwc(img)
    if a.ndim == 3 and a.shape[-1] == 3:
        mean = (a @ np.asarray([0.299, 0.587, 0.114], np.float32)).mean()
    else:
        mean = a.mean()
    return _restore(mean + (a - mean) * float(factor), u8)


def adjust_saturation(img, factor):
    """Blend with the per-pixel grayscale."""
    a, u8 = _as_float_hwc(img)
    gray = (a @ np.asarray([0.299, 0.587, 0.114], np.float32))[..., None]
    return _restore(gray + (a - gray) * float(factor), u8)


def adjust_hue(img, factor):
    """Shift hue by factor (in [-0.5, 0.5] turns) via HSV round-trip."""
    if not -0.5 <= factor <= 0.5:
        raise ValueError("hue factor must be in [-0.5, 0.5]")
    a, u8 = _as_float_hwc(img)
    scale = 255.0 if u8 else 1.0
    x = a / scale
    mx = x.max(-1)
    mn = x.min(-1)
    diff = mx - mn + 1e-12
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    h = np.where(mx == r, (g - b) / diff % 6,
                 np.where(mx == g, (b - r) / diff + 2, (r - g) / diff + 4))
    h = (h / 6.0 + factor) % 1.0
    s = np.where(mx > 0, diff / (mx + 1e-12), 0.0)
    v = mx
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = i.astype(np.int32) % 6
    out = np.stack([
        np.choose(i, [v, q, p, p, t, v]),
        np.choose(i, [t, v, v, q, p, p]),
        np.choose(i, [p, p, t, v, v, q]),
    ], axis=-1)
    return _restore(out * scale, u8)


def to_grayscale(img, num_output_channels=1):
    a, u8 = _as_float_hwc(img)
    gray = a @ np.asarray([0.299, 0.587, 0.114], np.float32)
    out = np.repeat(gray[..., None], num_output_channels, -1)
    return _restore(out, u8)


class BrightnessTransform:
    """reference transforms.py BrightnessTransform: factor ~ U[max(0, 1 - v),
    1 + v]."""

    def __init__(self, value, rng=None):
        self.value = float(value)
        self.rng = _rng(rng)

    def __call__(self, img):
        if self.value == 0:
            return np.asarray(img)
        f = self.rng.uniform(max(0.0, 1 - self.value), 1 + self.value)
        return adjust_brightness(img, f)


class ContrastTransform(BrightnessTransform):
    def __call__(self, img):
        if self.value == 0:
            return np.asarray(img)
        f = self.rng.uniform(max(0.0, 1 - self.value), 1 + self.value)
        return adjust_contrast(img, f)


class SaturationTransform(BrightnessTransform):
    def __call__(self, img):
        if self.value == 0:
            return np.asarray(img)
        f = self.rng.uniform(max(0.0, 1 - self.value), 1 + self.value)
        return adjust_saturation(img, f)


class HueTransform:
    def __init__(self, value, rng=None):
        if not 0 <= value <= 0.5:
            raise ValueError("hue value must be in [0, 0.5]")
        self.value = float(value)
        self.rng = _rng(rng)

    def __call__(self, img):
        if self.value == 0:
            return np.asarray(img)
        return adjust_hue(img, self.rng.uniform(-self.value, self.value))


class ColorJitter:
    """reference transforms.py ColorJitter: random-order composition of
    brightness/contrast/saturation/hue jitter."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 rng=None):
        self.rng = _rng(rng)
        self._ts = [BrightnessTransform(brightness, self.rng),
                    ContrastTransform(contrast, self.rng),
                    SaturationTransform(saturation, self.rng),
                    HueTransform(hue, self.rng)]

    def __call__(self, img):
        order = self.rng.permutation(len(self._ts))
        arr = np.asarray(img)
        for i in order:
            arr = self._ts[i](arr)
        return arr


class RandomVerticalFlip:
    def __init__(self, prob=0.5, rng=None):
        self.prob = prob
        self.rng = _rng(rng)

    def __call__(self, img):
        if self.rng.rand() < self.prob:
            return np.asarray(img)[::-1].copy()
        return np.asarray(img)


class Grayscale:
    def __init__(self, num_output_channels=1):
        self.num_output_channels = num_output_channels

    def __call__(self, img):
        return to_grayscale(img, self.num_output_channels)


class Pad:
    """reference transforms.py Pad (constant/edge/reflect)."""

    def __init__(self, padding, fill=0, padding_mode="constant"):
        if isinstance(padding, int):
            padding = (padding,) * 4           # l, t, r, b
        elif len(padding) == 2:
            padding = (padding[0], padding[1], padding[0], padding[1])
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def __call__(self, img):
        arr = np.asarray(img)
        l, t, r, b = self.padding
        spec = ((t, b), (l, r)) + ((0, 0),) * (arr.ndim - 2)
        if self.padding_mode == "constant":
            return np.pad(arr, spec, constant_values=self.fill)
        return np.pad(arr, spec, mode=self.padding_mode)


class RandomRotation:
    """reference transforms.py RandomRotation: nearest-sample rotation about
    the image center."""

    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, rng=None):
        if isinstance(degrees, (int, float)):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.fill = fill
        self.rng = _rng(rng)
        # only the default sampling mode is implemented — raise instead of
        # silently diverging from the reference for non-default arguments
        if interpolation != "nearest":
            raise NotImplementedError(
                f"RandomRotation: interpolation={interpolation!r} is not "
                "implemented (only 'nearest')")
        if expand:
            raise NotImplementedError(
                "RandomRotation: expand=True is not implemented")
        if center is not None:
            raise NotImplementedError(
                "RandomRotation: a custom center is not implemented "
                "(rotation is about the image center)")

    def __call__(self, img):
        arr = np.asarray(img)
        angle = np.radians(self.rng.uniform(*self.degrees))
        h, w = arr.shape[:2]
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        # inverse map: output pixel -> source pixel
        ys = cy + (yy - cy) * np.cos(angle) - (xx - cx) * np.sin(angle)
        xs = cx + (yy - cy) * np.sin(angle) + (xx - cx) * np.cos(angle)
        yi = np.round(ys).astype(np.int64)
        xi = np.round(xs).astype(np.int64)
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        out = np.full_like(arr, self.fill)
        out[valid] = arr[yi[valid], xi[valid]]
        return out


class RandomErasing:
    """reference transforms.py RandomErasing on HWC/CHW arrays, or on a
    torch tensor (erased in a copy on its device)."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, rng=None):
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value
        self.rng = _rng(rng)

    def __call__(self, img):
        if self.rng.rand() >= self.prob:
            return img
        out = img.clone() if isinstance(img, torch.Tensor) \
            else np.asarray(img).copy()
        chw = out.ndim == 3 and out.shape[0] in (1, 3) and \
            out.shape[0] < out.shape[-1]
        h, w = (out.shape[1], out.shape[2]) if chw else out.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * self.rng.uniform(*self.scale)
            ar = self.rng.uniform(*self.ratio)
            eh = int(round(np.sqrt(target * ar)))
            ew = int(round(np.sqrt(target / ar)))
            if eh < h and ew < w:
                i = self.rng.randint(0, h - eh)
                j = self.rng.randint(0, w - ew)
                if chw:
                    out[:, i:i + eh, j:j + ew] = self.value
                else:
                    out[i:i + eh, j:j + ew] = self.value
                break
        return out


__all__ += ["BrightnessTransform", "ContrastTransform", "SaturationTransform",
            "HueTransform", "ColorJitter", "RandomVerticalFlip", "Grayscale",
            "Pad", "RandomRotation", "RandomErasing", "adjust_brightness",
            "adjust_contrast", "adjust_saturation", "adjust_hue",
            "to_grayscale"]
