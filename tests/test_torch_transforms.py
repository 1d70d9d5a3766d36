"""Port parity of ``vision.transforms``: every transform and ``adjust_*`` /
``to_grayscale`` function of the port gives what JAX's gives on the same
image (uint8 and float), exactly.  A random transform of the port draws
from the ``numpy.random.RandomState`` it is given and makes the calls that
JAX's makes on numpy's global state, in the same order, so JAX seeded
with ``np.random.seed(s)`` and the port given ``RandomState(s)`` agree
over several calls in a row.  JAX's own ``tests/test_vision_zoo.py``
transform cases run on the port too.  ``ToTensor`` returns a torch tensor
on the device it is given (the CPU here)."""
import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.vision import transforms as JT
from paddle_tpu_torch.vision import transforms as TT

CALLS = 4


def _img(seed, shape=(12, 10, 3), dtype=np.uint8):
    r = np.random.default_rng(seed)
    if dtype == np.uint8:
        return r.integers(0, 256, shape).astype(np.uint8)
    return r.uniform(0, 1, shape).astype(np.float32)


def _np(v):
    if isinstance(v, Tensor):
        return np.asarray(v._value)
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


RANDOM = {
    "RandomHorizontalFlip": dict(prob=0.5),
    "RandomVerticalFlip": dict(prob=0.5),
    "RandomCrop": dict(size=6, padding=2),
    "RandomResizedCrop": dict(size=(5, 7)),
    "BrightnessTransform": dict(value=0.4),
    "ContrastTransform": dict(value=0.4),
    "SaturationTransform": dict(value=0.4),
    "HueTransform": dict(value=0.2),
    "ColorJitter": dict(brightness=0.4, contrast=0.4, saturation=0.4,
                        hue=0.1),
    "RandomRotation": dict(degrees=40, fill=3),
    "RandomErasing": dict(prob=0.7, value=9),
}


@pytest.mark.parametrize("name", list(RANDOM))
@pytest.mark.parametrize("dtype", [np.uint8, np.float32],
                         ids=["uint8", "float"])
def test_random_transform_matches_jax_draw_for_draw(name, dtype):
    """``CALLS`` calls in a row from one seed, on images that differ per
    call, for three seeds: equal outputs, so equal draws in equal order."""
    for seed in range(3):
        np.random.seed(seed)
        jt = getattr(JT, name)(**RANDOM[name])
        tt = getattr(TT, name)(**RANDOM[name],
                               rng=np.random.RandomState(seed))
        for call in range(CALLS):
            img = _img(10 * seed + call, dtype=dtype)
            want, got = _np(jt(img)), _np(tt(img))
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"seed {seed} call {call}")


def test_random_erasing_on_a_tensor_matches_jax():
    """CHW images as tensors: JAX's Tensor and the port's torch tensor are
    erased in copies; the input stays."""
    img = _img(1, (3, 9, 11), np.float32)
    np.random.seed(4)
    want = _np(JT.RandomErasing(prob=1.0, value=0.5)(Tensor(img)))
    src = torch.from_numpy(img.copy())
    got = TT.RandomErasing(prob=1.0, value=0.5,
                           rng=np.random.RandomState(4))(src)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(src.numpy(), img)


FIXED = {
    "Resize-int": (lambda T: T.Resize(7), (12, 10, 3)),
    "Resize-pair": (lambda T: T.Resize((5, 13)), (12, 10, 3)),
    "CenterCrop": (lambda T: T.CenterCrop((5, 8)), (12, 10, 3)),
    "Transpose": (lambda T: T.Transpose(), (12, 10, 3)),
    "Grayscale": (lambda T: T.Grayscale(3), (12, 10, 3)),
    "Pad-constant": (lambda T: T.Pad(2, fill=7), (6, 5, 3)),
    "Pad-edge": (lambda T: T.Pad((1, 2), padding_mode="edge"), (6, 5, 3)),
    "Pad-reflect": (lambda T: T.Pad((1, 2, 3, 1), padding_mode="reflect"),
                    (6, 5)),
    "Normalize-HWC": (lambda T: T.Normalize([0.5, 0.4, 0.3], [0.2, 0.3, 0.4],
                                            data_format="HWC"), (6, 5, 3)),
    "Compose": (lambda T: T.Compose([T.CenterCrop(8), T.Resize((4, 6)),
                                     T.Transpose()]), (12, 10, 3)),
}


@pytest.mark.parametrize("which", list(FIXED))
@pytest.mark.parametrize("dtype", [np.uint8, np.float32],
                         ids=["uint8", "float"])
def test_fixed_transform_matches_jax(which, dtype):
    make, shape = FIXED[which]
    img = _img(2, shape, dtype)
    want, got = _np(make(JT)(img)), _np(make(TT)(img))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", ["CHW", "HWC"])
def test_to_tensor_and_normalize_match_jax(fmt):
    """``ToTensor`` gives a torch f32 tensor on the device asked for;
    ``Normalize`` keeps a tensor a tensor, on its device."""
    img = _img(3)
    want = _np(JT.ToTensor(fmt)(img))
    got = TT.ToTensor(fmt, device="cpu")(img)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.device == torch.device("cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    norm = dict(mean=[0.5, 0.4, 0.3], std=[0.2, 0.3, 0.4], data_format=fmt)
    jn = JT.Normalize(**norm)(JT.ToTensor(fmt)(img))
    tn = TT.Normalize(**norm)(got)
    assert isinstance(tn, torch.Tensor)
    np.testing.assert_array_equal(tn.numpy(), _np(jn))
    gray = _img(4, (5, 6))
    np.testing.assert_array_equal(
        TT.ToTensor(fmt, device="cpu")(gray).numpy(),
        _np(JT.ToTensor(fmt)(gray)))


def test_to_tensor_defaults_to_the_card():
    if torch.cuda.is_available():
        assert TT.ToTensor()(_img(5)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TT.ToTensor()


@pytest.mark.parametrize("fn,arg", [("adjust_brightness", 1.7),
                                    ("adjust_brightness", 0.3),
                                    ("adjust_contrast", 0.0),
                                    ("adjust_contrast", 1.8),
                                    ("adjust_saturation", 0.2),
                                    ("adjust_saturation", 2.5),
                                    ("adjust_hue", 0.3),
                                    ("adjust_hue", -0.45),
                                    ("to_grayscale", 1),
                                    ("to_grayscale", 3)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32],
                         ids=["uint8", "float"])
def test_functional_matches_jax(fn, arg, dtype):
    img = _img(6, dtype=dtype)
    want, got = getattr(JT, fn)(img, arg), getattr(TT, fn)(img, arg)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_hue_factor_out_of_range_raises_as_in_jax():
    for T in (JT, TT):
        with pytest.raises(ValueError):
            T.adjust_hue(_img(7), 0.6)
        with pytest.raises(ValueError):
            T.HueTransform(0.7)
    with pytest.raises(NotImplementedError):
        TT.RandomRotation(10, interpolation="bilinear")


# -- JAX's tests/test_vision_zoo.py transform cases on the port --------------
def test_color_transforms_values():
    img = (np.arange(48).reshape(4, 4, 3) * 5).astype(np.uint8)
    np.testing.assert_allclose(TT.adjust_brightness(img, 2.0),
                               np.clip(img.astype(np.float32) * 2, 0, 255)
                               .astype(np.uint8))
    assert np.unique(TT.adjust_contrast(img, 0.0)).size <= 2
    g = TT.to_grayscale(img, 3)
    assert g.shape == img.shape and np.allclose(g[..., 0], g[..., 1])
    f = img.astype(np.float32) / 255.0
    np.testing.assert_allclose(TT.adjust_hue(f, 0.0), f, atol=1e-3)


def test_geometric_transforms():
    img = np.arange(36).reshape(6, 6).astype(np.float32)[..., None]
    rng = np.random.RandomState(0)
    np.testing.assert_allclose(TT.RandomVerticalFlip(prob=1.0, rng=rng)(img),
                               img[::-1])
    assert TT.Pad(2)(img).shape == (10, 10, 1)
    np.testing.assert_allclose(TT.RandomRotation((0, 0), rng=rng)(img), img)
    er = TT.RandomErasing(prob=1.0, value=7, rng=rng)(
        np.ones((8, 8, 3), np.float32))
    assert (er == 7).any()
    out = TT.ColorJitter(0.4, 0.4, 0.4, 0.1, rng=rng)(
        (rng.rand(5, 5, 3) * 255).astype(np.uint8))
    assert out.shape == (5, 5, 3)
