"""The vision functionals and detection ops on the card against the same
call on the CPU (f32, TF32 off): one ``cuda``-marked case per op of
``chip_smoke.py`` phase 3o, at small shapes.  They skip without a card.
The file imports no JAX, so that it runs where the card is."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.vision import ops as tops

VAL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _boxes(n, seed, scale=100.0):
    r = _rng(seed)
    xy = r.uniform(0, scale, (n, 2))
    wh = r.uniform(scale / 20, scale / 3, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _priors(seed, m=6):
    r = _rng(seed)
    p = np.abs(r.normal(2, 0.5, (m, 4))).astype(np.float32)
    p[:, 2:] = p[:, :2] + np.abs(r.normal(1, 0.2, (m, 2)))
    return p.astype(np.float32)


@pytest.fixture
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: holds the card against the CPU")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _same_on_card(fn, *inputs, tol=VAL):
    want = fn(*inputs)
    got = fn(*[v.cuda() if isinstance(v, torch.Tensor) else v
               for v in inputs])
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, **tol)


@pytest.mark.cuda
def test_roi_align_on_card_matches_cpu(_card):
    x = torch.from_numpy(_rng(20).normal(0, 1, (2, 16, 40, 48))
                         .astype(np.float32))
    boxes = torch.from_numpy(np.concatenate([_boxes(40, 21, 150),
                                             _boxes(30, 22, 150)]))
    for sr in (-1, 2):
        _same_on_card(lambda a, b, n: tops.roi_align(
            a, b, n, 7, spatial_scale=0.25, sampling_ratio=sr), x, boxes,
            torch.tensor([40, 30]))


@pytest.mark.cuda
def test_deform_conv2d_on_card_matches_cpu(_card):
    r = _rng(23)
    x = torch.from_numpy(r.normal(0, 1, (2, 16, 14, 14)).astype(np.float32))
    off = torch.from_numpy(r.normal(0, 1.5, (2, 18, 14, 14))
                           .astype(np.float32))
    w = torch.from_numpy(r.normal(0, 0.1, (16, 16, 3, 3)).astype(np.float32))
    m = torch.from_numpy(r.uniform(0, 1, (2, 9, 14, 14)).astype(np.float32))
    _same_on_card(lambda a, o, ww, mm: tops.deform_conv2d(
        a, o, ww, padding=1, mask=mm), x, off, w, m)


@pytest.mark.cuda
def test_nms_on_card_matches_cpu(_card):
    boxes = torch.from_numpy(_boxes(500, 24))
    scores = torch.from_numpy(_rng(25).permutation(500).astype(np.float32))
    _same_on_card(lambda b, s: tops.nms(b, 0.5, s), boxes, scores,
                  tol=dict(rtol=0, atol=0))


@pytest.mark.cuda
def test_box_coder_on_card_matches_cpu(_card):
    priors, targets = torch.from_numpy(_priors(26)), torch.from_numpy(
        _priors(27, 5))
    _same_on_card(lambda p, t: tops.box_coder(p, [0.1, 0.1, 0.2, 0.2], t),
                  priors, targets)
    deltas = torch.from_numpy(_rng(28).normal(0, 0.2, (5, 6, 4))
                              .astype(np.float32))
    _same_on_card(lambda p, t: tops.box_coder(
        p, None, t, code_type="decode_center_size"), priors, deltas)


@pytest.mark.cuda
def test_avg_pool2d_on_card_matches_cpu(_card):
    x = torch.from_numpy(_rng(29).normal(0, 1, (2, 8, 15, 16))
                         .astype(np.float32))
    _same_on_card(lambda a: TF.avg_pool2d(a, 3, 2, 1, ceil_mode=True,
                                          exclusive=False), x)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "area"])
def test_interpolate_on_card_matches_cpu(_card, mode):
    x = torch.from_numpy(_rng(30).normal(0, 1, (2, 8, 16, 16))
                         .astype(np.float32))
    for sf in (2, 0.5):
        _same_on_card(lambda a: TF.interpolate(a, scale_factor=sf,
                                               mode=mode), x)
