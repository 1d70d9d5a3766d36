"""Port parity of the vision functionals and detection ops: ``concat``,
``reshape`` (0 copies, -1 infers), ``transpose`` and ``squeeze``;
``avg_pool2d`` over odd sizes, ``ceil_mode``, both ``exclusive`` settings,
``divisor_override``, ``"SAME"`` / ``"VALID"`` and NHWC; ``interpolate``
in every mode, up and down, with ``align_corners`` / ``align_mode``, in
3-D, 4-D and 5-D (bicubic also against ``jax.image.resize`` itself); and
``vision.ops`` ``nms`` (distinct scores: JAX's ``np.argsort`` is not
stable), ``box_coder``, ``roi_align`` and ``deform_conv2d``.  Values and
gradients against the JAX package's functions (jitted) on the same numpy
inputs, f32: shape ops exactly, pooling to 1e-6, resizes and ops to 1e-5
(gradients of the ops 1e-4).  JAX's own ``tests/test_stub_fills.py``
cases run on the port too.  The card's cases are in
``tests/test_torch_vision_card.py``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.tensor import manipulation as jmanip
from paddle_tpu.vision import ops as jops
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import layers as TL
from paddle_tpu_torch.tensor import manipulation as tmanip
from paddle_tpu_torch.vision import ops as tops

from test_torch_resnet import jax_eager_grads, port_grads

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _jax_plain_dispatch():
    """The JAX oracle runs its plain ops (see ``test_torch_resnet.py``)."""
    prev = paddle.get_flags(["use_pallas_kernels"])
    paddle.set_flags({"use_pallas_kernels": False})
    yield
    paddle.set_flags(prev)


def _rng(seed):
    return np.random.default_rng(seed)


def jax_grads(jfn, inputs, ct):
    """``jax.jit(jax.value_and_grad)`` of sum(jfn(*inputs) * ct) over JAX
    Tensors (one compile a case, where eager JAX compiles every op of the
    forward and the backward apart): (out, the inputs' gradients)."""
    def f(*vs):
        out = jfn(*[Tensor(v) for v in vs])._value
        return jnp.sum(out * ct), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=tuple(range(len(inputs))), has_aux=True))(
            *[jnp.asarray(v) for v in inputs])
    return np.asarray(out), [np.asarray(g) for g in grads]


def jax_eager(jfn, inputs, ct):
    """:func:`jax_grads` through JAX's eager autograd
    (``jax_eager_grads``)."""
    return jax_eager_grads(jfn, inputs, ct)[:2]


def _hold(jfn, tfn, inputs, tol, grad_tol=None, seed=0, jax_side=jax_grads):
    """``jfn`` (JAX, through ``jax_side``) and ``tfn`` (the port) on the
    same inputs: the outputs to ``tol`` and the gradients of sum(out * ct)
    with respect to every input to ``grad_tol`` (default ``tol``)."""
    with torch.no_grad():
        shape = tuple(tfn(*[torch.from_numpy(v) for v in inputs]).shape)
    ct = _rng(seed + 100).normal(0, 1, shape).astype(np.float32)
    jout, jg = jax_side(jfn, inputs, ct)
    tout, tg, _ = port_grads(tfn, inputs, ct)
    assert tout.shape == jout.shape
    np.testing.assert_allclose(tout, jout, **tol)
    for i, (got, want) in enumerate(zip(tg, jg)):
        np.testing.assert_allclose(got, want, err_msg=f"grad {i}",
                                   **(grad_tol or tol))
    return tout


# -- shape ops ---------------------------------------------------------------
EXACT = dict(rtol=0, atol=0)
SHAPE_OPS = {
    "concat-1": (lambda m: (lambda a, b: m.concat([a, b], axis=1)),
                 [(2, 3, 4), (2, 5, 4)]),
    "concat-neg": (lambda m: (lambda a, b, c: m.concat([a, b, c], axis=-1)),
                   [(2, 3, 1), (2, 3, 4), (2, 3, 2)]),
    "reshape-0-and-neg1": (lambda m: (lambda a: m.reshape(a, [0, -1, 2])),
                           [(3, 4, 6)]),
    "reshape-0-0": (lambda m: (lambda a: m.reshape(a, [0, 0, 12])),
                    [(2, 5, 3, 4)]),
    "transpose": (lambda m: (lambda a: m.transpose(a, [0, 2, 1, 3])),
                  [(2, 3, 4, 5)]),
    "squeeze-all": (lambda m: (lambda a: m.squeeze(a)), [(1, 3, 1, 4)]),
    "squeeze-listed": (lambda m: (lambda a: m.squeeze(a, axis=[0, 1, -1])),
                       [(1, 3, 4, 1)]),
    "squeeze-int-neg": (lambda m: (lambda a: m.squeeze(a, axis=-2)),
                        [(2, 3, 1, 4)]),
    "squeeze-not-1": (lambda m: (lambda a: m.squeeze(a, axis=[1])),
                      [(2, 3, 4)]),
}


@pytest.mark.parametrize("which", list(SHAPE_OPS))
def test_shape_op_matches_jax(which):
    """Values and gradients equal JAX's (``squeeze`` keeps a listed axis
    of another size silently)."""
    make, shapes = SHAPE_OPS[which]
    r = _rng(1)
    inputs = [r.normal(0, 1, s).astype(np.float32) for s in shapes]
    out = _hold(make(jmanip), make(tmanip), inputs, EXACT)
    if which == "squeeze-not-1":
        assert out.shape == (2, 3, 4)


# -- avg_pool2d --------------------------------------------------------------
POOLS = [
    ((1, 3, 7, 9), dict(kernel_size=3, stride=2, padding=1)),
    ((1, 3, 7, 8), dict(kernel_size=3, stride=2, padding=1, ceil_mode=True,
                        exclusive=False)),
    ((1, 3, 7, 8), dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)),
    ((2, 2, 5, 5), dict(kernel_size=2, stride=2, padding=1, ceil_mode=True,
                        exclusive=False)),
    ((1, 2, 9, 9), dict(kernel_size=3, stride=1, padding=1, exclusive=False)),
    ((1, 2, 8, 8), dict(kernel_size=2, stride=2)),
    ((1, 2, 13, 13), dict(kernel_size=5, stride=3)),
    ((1, 2, 7, 6), dict(kernel_size=3, stride=1, padding=2,
                        exclusive=False)),
    ((1, 2, 7, 9), dict(kernel_size=(3, 2), stride=(2, 1), padding=[1, 0],
                        divisor_override=5)),
    ((1, 2, 7, 9), dict(kernel_size=3, stride=2, padding=1, ceil_mode=True,
                        divisor_override=4)),
    ((1, 2, 7, 9), dict(kernel_size=3, stride=2, padding=[0, 1, 2, 1])),
    ((1, 2, 7, 9), dict(kernel_size=3, stride=2, padding="SAME",
                        exclusive=False)),
    ((1, 2, 8, 9), dict(kernel_size=4, stride=3, padding="SAME")),
    ((1, 2, 7, 9), dict(kernel_size=3, stride=2, padding="VALID",
                        ceil_mode=True)),
    ((2, 7, 9, 3), dict(kernel_size=3, stride=2, padding=1, ceil_mode=True,
                        exclusive=False, data_format="NHWC")),
]


@pytest.mark.parametrize("shape,kw", POOLS,
                         ids=[f"{i}" for i in range(len(POOLS))])
def test_avg_pool2d_matches_jax(shape, kw):
    """Values to 1e-6 and the gradient against JAX's eager autograd; with
    ``exclusive=False`` and ``ceil_mode`` a window past the padding is
    divided by the whole window (case 1, 3), as JAX divides it."""
    x = _rng(2).normal(0, 1, shape).astype(np.float32)
    tol = dict(rtol=1e-6, atol=1e-6)
    _hold(lambda t: JF.avg_pool2d(t, **kw), lambda t: TF.avg_pool2d(t, **kw),
          [x], tol, jax_side=jax_eager)
    layer = TL.AvgPool2D(**kw)
    np.testing.assert_allclose(layer(torch.from_numpy(x)).numpy(),
                               TF.avg_pool2d(torch.from_numpy(x), **kw)
                               .numpy(), rtol=0, atol=0)


def test_avg_pool2d_ceil_window_is_not_torchs():
    """The case torch's own ``ceil_mode`` would divide by a clipped count:
    the last window of 8 columns at k 3, s 2, pad 1 holds one input column,
    the pad and one column past the padding; JAX (so the port) divides its
    3 ones by 9, torch by the 6 places that lie in the padded input."""
    x = torch.ones(1, 1, 7, 8)
    got = TF.avg_pool2d(x, 3, 2, 1, ceil_mode=True, exclusive=False)
    torch_own = torch.nn.functional.avg_pool2d(x, 3, 2, 1, ceil_mode=True,
                                               count_include_pad=True)
    assert got.shape == torch_own.shape == (1, 1, 4, 5)
    assert float(got[0, 0, 1, -1]) == pytest.approx(3 / 9)
    assert float(torch_own[0, 0, 1, -1]) == pytest.approx(3 / 6)


# -- interpolate -------------------------------------------------------------
RESIZES = [
    ((2, 3, 8), dict(mode="linear", size=13)),
    ((2, 3, 8), dict(mode="linear", size=5, align_corners=True)),
    ((2, 3, 8, 6), dict(mode="bilinear", scale_factor=2)),
    ((2, 3, 8, 6), dict(mode="bilinear", scale_factor=0.5)),
    ((2, 3, 8, 6), dict(mode="bilinear", size=[5, 11], align_corners=True)),
    ((2, 3, 8, 6), dict(mode="bilinear", size=[5, 11], align_mode=1)),
    ((2, 7, 6, 3), dict(mode="bilinear", size=[9, 4], data_format="NHWC")),
    ((1, 2, 4, 6, 5), dict(mode="trilinear", size=[7, 3, 10])),
    ((1, 2, 4, 6, 5), dict(mode="trilinear", scale_factor=2,
                           align_corners=True)),
    ((2, 3, 8, 6), dict(mode="bicubic", scale_factor=2)),
    ((2, 3, 16, 12), dict(mode="bicubic", scale_factor=0.5)),
    ((2, 3, 16, 12), dict(mode="bicubic", size=[5, 7])),
    ((2, 3, 8, 6), dict(mode="bicubic", size=[8, 15], align_corners=True)),
    ((2, 3, 16, 12), dict(mode="area", size=[8, 4])),
    ((2, 3, 16, 12), dict(mode="area", size=[5, 6])),
    ((2, 3, 4, 6), dict(mode="area", size=[8, 6])),
    ((2, 3, 4, 6), dict(mode="nearest", size=[7, 9])),
    ((2, 3, 4, 6), dict(mode="nearest", size=[3, 9], align_corners=True)),
]


@pytest.mark.parametrize("shape,kw", RESIZES,
                         ids=[f"{k['mode']}-{i}" for i, (_, k)
                              in enumerate(RESIZES)])
def test_interpolate_matches_jax(shape, kw):
    """Values to 1e-5 and the gradient; ``bicubic`` is JAX's antialiased
    Keys kernel (it ignores ``align_corners``), ``area`` the mean where
    the sizes divide and the half-pixel linear pass where they do not."""
    x = _rng(3).normal(0, 1, shape).astype(np.float32)
    _hold(lambda t: JF.interpolate(t, **kw),
          lambda t: TF.interpolate(t, **kw), [x], VAL)


@pytest.mark.parametrize("size", [(32, 24), (7, 5), (16, 9)],
                         ids=["enlarge", "shrink", "mixed"])
def test_bicubic_matches_jax_image_resize(size):
    """Against ``jax.image.resize(method="cubic")`` itself, enlarging and
    shrinking (antialiased); torch's own bicubic (a = -0.75, no
    antialiasing) differs where the image shrinks."""
    x = _rng(4).normal(0, 1, (2, 3, 16, 12)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3) + size,
                                       method="cubic"))
    got = TF.interpolate(torch.from_numpy(x), size=list(size),
                         mode="bicubic").numpy()
    np.testing.assert_allclose(got, want, **VAL)
    if size == (7, 5):
        torch_own = torch.nn.functional.interpolate(
            torch.from_numpy(x), size=size, mode="bicubic").numpy()
        assert not np.allclose(torch_own, want, atol=1e-2)


# -- nms and box_coder -------------------------------------------------------
def _boxes(n, seed, scale=100.0):
    r = _rng(seed)
    xy = r.uniform(0, scale, (n, 2))
    wh = r.uniform(scale / 20, scale / 3, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("n,thr,scored,top_k",
                         [(60, 0.3, True, None), (60, 0.5, True, 7),
                          (80, 0.7, True, None), (40, 0.3, False, None)],
                         ids=["0.3", "0.5-top7", "0.7", "no-scores"])
def test_nms_matches_jax(n, thr, scored, top_k):
    """Half the boxes are the other half moved by up to one unit (sides of
    5 to 33), so that every threshold drops some."""
    half = _boxes(n // 2, 5)
    boxes = np.concatenate([half, half + _rng(5).uniform(
        -1, 1, half.shape).astype(np.float32)])
    scores = _rng(6).permutation(n).astype(np.float32) / n if scored \
        else None
    want = np.asarray(jops.nms(
        Tensor(jnp.asarray(boxes)), thr,
        Tensor(jnp.asarray(scores)) if scored else None,
        top_k=top_k)._value)
    got = tops.nms(torch.from_numpy(boxes), thr,
                   torch.from_numpy(scores) if scored else None,
                   top_k=top_k)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < len(want) < n


def test_nms_ties_keep_index_order():
    """Equal scores keep index order (a stable sort): the known difference
    from JAX's ``np.argsort``, which does not promise an order."""
    boxes = torch.tensor([[0., 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60],
                          [0, 0, 10, 10]])
    got = tops.nms(boxes, 0.5, torch.tensor([0.5, 0.9, 0.5, 0.5]))
    assert got.tolist() == [1, 2]


def _priors(seed, m=6):
    r = _rng(seed)
    p = np.abs(r.normal(2, 0.5, (m, 4))).astype(np.float32)
    p[:, 2:] = p[:, :2] + np.abs(r.normal(1, 0.2, (m, 2)))
    return p.astype(np.float32)


@pytest.mark.parametrize("var", ["tensor", "list", None])
@pytest.mark.parametrize("normalized", [True, False])
def test_box_coder_encode_matches_jax(var, normalized):
    priors, targets = _priors(7), _priors(8, 5)
    v = _rng(9).uniform(0.1, 0.3, (6, 4)).astype(np.float32)
    jv = Tensor(jnp.asarray(v)) if var == "tensor" else \
        ([0.1, 0.1, 0.2, 0.2] if var == "list" else None)
    tv = torch.from_numpy(v) if var == "tensor" else \
        ([0.1, 0.1, 0.2, 0.2] if var == "list" else None)
    want = np.asarray(jops.box_coder(
        Tensor(jnp.asarray(priors)), jv, Tensor(jnp.asarray(targets)),
        box_normalized=normalized)._value)
    got = tops.box_coder(torch.from_numpy(priors), tv,
                         torch.from_numpy(targets),
                         box_normalized=normalized).numpy()
    assert got.shape == (5, 6, 4)
    np.testing.assert_allclose(got, want, **VAL)


@pytest.mark.parametrize("var", ["tensor", "list", None])
@pytest.mark.parametrize("axis", [0, 1])
def test_box_coder_decode_matches_jax(var, axis):
    priors = _priors(10)
    deltas = _rng(11).normal(0, 0.2, (6, 6, 4)).astype(np.float32)
    v = _rng(12).uniform(0.1, 0.3, (6, 4)).astype(np.float32)
    jv = Tensor(jnp.asarray(v)) if var == "tensor" else \
        ([0.1, 0.1, 0.2, 0.2] if var == "list" else None)
    tv = torch.from_numpy(v) if var == "tensor" else \
        ([0.1, 0.1, 0.2, 0.2] if var == "list" else None)
    want = np.asarray(jops.box_coder(
        Tensor(jnp.asarray(priors)), jv, Tensor(jnp.asarray(deltas)),
        code_type="decode_center_size", axis=axis,
        box_normalized=False)._value)
    got = tops.box_coder(torch.from_numpy(priors), tv,
                         torch.from_numpy(deltas),
                         code_type="decode_center_size", axis=axis,
                         box_normalized=False).numpy()
    np.testing.assert_allclose(got, want, **VAL)


# -- roi_align and deform_conv2d ---------------------------------------------
def _rois(seed):
    """Five ROIs over two images (3 + 2) of a 16 x 20 map at scale 0.5:
    sizes from under a bin to wider than the map, one partly outside."""
    boxes = np.array([[2.0, 3.0, 20.0, 17.0], [0.0, 0.0, 39.0, 31.0],
                      [10.5, 4.25, 13.0, 6.0], [30.0, 20.0, 46.0, 40.0],
                      [5.0, 5.0, 29.0, 9.0]], np.float32)
    boxes += _rng(seed).uniform(0, 0.5, boxes.shape).astype(np.float32)
    return boxes, np.array([3, 2], np.int32)


@pytest.mark.parametrize("sampling_ratio", [-1, 2], ids=["adaptive", "2"])
@pytest.mark.parametrize("aligned", [True, False])
def test_roi_align_matches_jax(sampling_ratio, aligned):
    """Values to 1e-5 and the gradient of x to 1e-4: adaptive sampling
    (a grid per ROI from its size, so groups of different counts) and a
    fixed one, both alignments; coordinates outside the map clamp."""
    x = _rng(13).normal(0, 1, (2, 3, 16, 20)).astype(np.float32)
    boxes, num = _rois(14)
    kw = dict(output_size=(3, 4), spatial_scale=0.5,
              sampling_ratio=sampling_ratio, aligned=aligned)
    jb, jn = Tensor(jnp.asarray(boxes)), Tensor(jnp.asarray(num))
    tb, tn = torch.from_numpy(boxes), torch.from_numpy(num)
    _hold(lambda t: jops.roi_align(t, jb, jn, **kw),
          lambda t: tops.roi_align(t, tb, tn, **kw), [x], VAL, GRAD)


DEFORM = [
    dict(shape=(2, 4, 7, 8), co=6, k=3, stride=1, padding=1, dg=1, groups=1,
         mask=False, bias=False),
    dict(shape=(1, 4, 9, 7), co=4, k=3, stride=2, padding=1, dg=2, groups=2,
         mask=True, bias=True),
    dict(shape=(2, 6, 6, 6), co=6, k=2, stride=1, padding=0, dg=3, groups=3,
         mask=True, bias=False),
]


@pytest.mark.parametrize("case", DEFORM, ids=["v1", "v2-groups", "v2-dg3"])
def test_deform_conv2d_matches_jax(case):
    """Values to 1e-5 and the gradients of x, offset, weight and mask to
    1e-4; offsets of N(0, 1.5) send taps across pixels and off the map."""
    r = _rng(15)
    B, C, H, W = case["shape"]
    k, s, p = case["k"], case["stride"], case["padding"]
    Ho, Wo = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1
    dg, g = case["dg"], case["groups"]
    x = r.normal(0, 1, (B, C, H, W)).astype(np.float32)
    off = r.normal(0, 1.5, (B, 2 * dg * k * k, Ho, Wo)).astype(np.float32)
    w = r.normal(0, 0.3, (case["co"], C // g, k, k)).astype(np.float32)
    inputs = [x, off, w]
    if case["mask"]:
        inputs.append(r.uniform(0, 1, (B, dg * k * k, Ho, Wo))
                      .astype(np.float32))
    bias = r.normal(0, 1, case["co"]).astype(np.float32) if case["bias"] \
        else None

    def call(ops, wrap):
        def fn(xv, ov, wv, *m):
            return ops.deform_conv2d(
                xv, ov, wv, None if bias is None else wrap(bias), stride=s,
                padding=p, deformable_groups=dg, groups=g,
                mask=m[0] if m else None)
        return fn
    _hold(call(jops, lambda v: Tensor(jnp.asarray(v))),
          call(tops, torch.from_numpy), inputs, VAL, GRAD)


# -- JAX's tests/test_stub_fills.py cases on the port ------------------------
def test_box_coder_decode_roundtrip():
    priors = _priors(0)
    targets = priors + _rng(0).normal(0, 0.05, (6, 4)).astype(np.float32)
    enc = tops.box_coder(torch.from_numpy(priors), None,
                         torch.from_numpy(targets))
    deltas = torch.stack([enc[i, i] for i in range(6)])
    dec = tops.box_coder(torch.from_numpy(priors), None, deltas[None],
                         code_type="decode_center_size")
    np.testing.assert_allclose(dec[0].numpy(), targets, rtol=1e-4, atol=1e-4)


def test_roi_align_constant_map():
    x = torch.full((1, 3, 16, 16), 7.0)
    boxes = torch.tensor([[2.0, 2.0, 10.0, 10.0], [0.0, 0.0, 15.0, 15.0]])
    out = tops.roi_align(x, boxes, torch.tensor([2]), output_size=4)
    assert tuple(out.shape) == (2, 3, 4, 4)
    np.testing.assert_allclose(out.numpy(), 7.0, rtol=1e-5)


def test_roi_align_matches_center_sampling():
    g = _rng(1).normal(0, 1, (1, 1, 8, 8)).astype(np.float32)
    out = tops.roi_align(torch.from_numpy(g), torch.tensor([[1., 1, 5, 5]]),
                         torch.tensor([1]), output_size=1, sampling_ratio=1,
                         aligned=True)
    c, lo = 2.5, 2
    w1 = c - lo
    g = g[0, 0]
    ref = ((1 - w1) * (1 - w1) * g[lo, lo] + (1 - w1) * w1 * g[lo, lo + 1]
           + w1 * (1 - w1) * g[lo + 1, lo] + w1 * w1 * g[lo + 1, lo + 1])
    np.testing.assert_allclose(float(out[0, 0, 0, 0]), ref, rtol=1e-5)


def test_deform_conv2d_zero_offset_equals_conv():
    r = _rng(2)
    x = torch.from_numpy(r.normal(0, 1, (2, 4, 8, 8)).astype(np.float32))
    w = torch.from_numpy(r.normal(0, 0.2, (6, 4, 3, 3)).astype(np.float32))
    out = tops.deform_conv2d(x, torch.zeros(2, 18, 8, 8), w, stride=1,
                             padding=1)
    ref = torch.nn.functional.conv2d(x, w, stride=1, padding=1)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_box_coder_list_variance_applied():
    priors = torch.tensor([[0.0, 0.0, 2.0, 2.0]])
    deltas = torch.zeros(1, 1, 4)
    deltas[0, 0, 0] = 1.0
    no_var = tops.box_coder(priors, None, deltas,
                            code_type="decode_center_size")
    with_var = tops.box_coder(priors, [0.5, 0.5, 0.5, 0.5], deltas,
                              code_type="decode_center_size")
    assert not np.allclose(no_var.numpy(), with_var.numpy())
    assert float(with_var[0, 0, 0] - no_var[0, 0, 0]) == pytest.approx(-1.0)
