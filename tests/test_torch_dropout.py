"""The port's dropout: Philox4x32-10 against Random123's known-answer
vectors (exact), the attention-dropout keep mask of the flash kernels
(``dropout_keep``: its keep rate within 5 sigma of 1 - rate, rate 0, seeds,
and the coordinate keying the kernels rely on), and ``nn.functional.dropout``
/ ``nn.layers.Dropout`` against the JAX package's at rate 0, in eval mode
and under ``downscale_in_infer`` inference (exact), with the binomial keep
rate in training.  JAX draws its masks from ``jax.random`` and the port
from a ``torch.Generator``, so in training the two agree in distribution,
not in bits."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn import Dropout as JDropout
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.layers import Dropout
from paddle_tpu_torch.ops import flash_attention as tfa

M = 0xFFFFFFFF

# Random123's kat_vectors for philox4x32_10: counter, key -> output
KATS = [((0, 0, 0, 0), (0, 0),
         (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
        ((M, M, M, M), (M, M),
         (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
        ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
         (0xa4093822, 0x299f31d0),
         (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]


@pytest.mark.parametrize("counter,key,want", KATS,
                         ids=["zeros", "all-ones", "pi-digits"])
def test_philox_known_answers(counter, key, want):
    got = tfa.philox4x32_10(counter, key)
    assert tuple(int(w) for w in got) == want
    # the same counter as int64 tensors, broadcast over a batch
    batch = [torch.full((3, 2), c, dtype=torch.int64) for c in counter]
    for w, x in zip(tfa.philox4x32_10(batch, key), want):
        assert w.shape == (3, 2) and bool((w == x).all())


def _within_5_sigma(keep, rate):
    n = keep.numel()
    sigma = math.sqrt(rate * (1 - rate) / n)
    return abs(float(keep.float().mean()) - (1 - rate)) <= 5 * sigma


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_rate_within_5_sigma(rate):
    keep = tfa.dropout_keep(7, range(8), range(256), range(512), rate)
    assert keep.shape == (8, 256, 512) and keep.dtype == torch.bool
    assert _within_5_sigma(keep, rate)


def test_rate_zero_keeps_everything():
    assert bool(tfa.dropout_keep(7, range(2), range(64), range(200),
                                 0.0).all())


def test_mask_is_a_function_of_the_seed():
    a = tfa.dropout_keep(11, range(2), range(128), range(128), 0.1)
    b = tfa.dropout_keep(11, range(2), range(128), range(128), 0.1)
    c = tfa.dropout_keep(12, range(2), range(128), range(128), 0.1)
    d = tfa.dropout_keep(11 + (1 << 32), range(2), range(128), range(128),
                         0.1)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.equal(a, d)         # the seed's high word counts too


def test_mask_is_keyed_on_global_coordinates():
    """Any subset of rows and columns gives the full mask's entries (each
    kernel rebuilds the mask from its own tiles), and the columns
    {2t, 2t+1, 8+2t, 9+2t} of a 16-column group take words 0..3 of the call
    (4 * group + t, row, bhq, 0) against the threshold."""
    rate, seed = 0.3, (5 << 32) + 9
    full = tfa.dropout_keep(seed, range(6), range(40), range(100), rate)
    bhq, rows, cols = [4, 1], [39, 0, 17], [99, 3, 64, 50, 8]
    part = tfa.dropout_keep(seed, bhq, rows, cols, rate)
    assert torch.equal(part, full[bhq][:, rows][:, :, cols])
    thresh = tfa.dropout_threshold(rate)
    for b, r, group, t in ((3, 7, 2, 1), (0, 39, 5, 3)):
        words = tfa.philox4x32_10((4 * group + t, r, b, 0),
                                  (seed & M, seed >> 32))
        for col, w in zip((2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t), words):
            assert bool(full[b, r, 16 * group + col]) == (int(w) >= thresh)


def test_threshold_and_scale_follow_jax():
    """keep iff word >= uint32(rate * 2**32), and 1 / (1 - rate) rounded
    as f32, as the TPU kernel's ``_dropout_mask``."""
    for rate in (0.1, 0.5, 0.9):
        assert tfa.dropout_threshold(rate) == int(rate * 4294967296.0)
        want = np.float32(1.0) / np.float32(1.0 - rate)
        assert tfa.dropout_scale(rate) == float(want)


def _x(shape=(4, 8, 32), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("case", ["rate0", "eval"])
def test_functional_dropout_equals_jax_when_it_keeps_all(case, mode):
    """At rate 0 in training, and in eval at 0.1 (both modes: JAX returns
    x unchanged in inference, ``downscale_in_infer`` included), the port's
    output equals JAX's exactly."""
    x = _x()
    p, training = (0.0, True) if case == "rate0" else (0.1, False)
    want = JF.dropout(Tensor(jnp.asarray(x)), p, training=training,
                      mode=mode).numpy()
    got = TF.dropout(torch.from_numpy(x), p, training=training, mode=mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_functional_dropout_in_training(mode):
    """Binomial keep rate within 5 sigma, kept values x / (1 - p)
    (upscale) or x (downscale), dropped ones 0, x's dtype, the same output
    from the same generator state."""
    x = torch.from_numpy(_x((64, 64, 32))) + 5.0        # no exact zeros
    gen = torch.Generator().manual_seed(3)
    out = TF.dropout(x, 0.1, mode=mode, generator=gen)
    keep = out != 0
    assert _within_5_sigma(keep, 0.1)
    kept = x / 0.9 if mode == "upscale_in_train" else x
    assert torch.equal(out[keep], kept[keep])
    again = TF.dropout(x, 0.1, mode=mode,
                       generator=torch.Generator().manual_seed(3))
    assert torch.equal(out, again)
    xb = x.bfloat16()
    assert TF.dropout(xb, 0.1, mode=mode, generator=gen).dtype \
        == torch.bfloat16


def test_functional_dropout_axis_broadcasts_the_mask():
    """With ``axis`` the mask spans those axes and is shared along the
    others (JAX's ``mask_shape``)."""
    x = torch.from_numpy(_x((16, 8, 32))) + 5.0
    out = TF.dropout(x, 0.5, axis=[0, 2], generator=torch.Generator()
                     .manual_seed(1))
    keep = out != 0
    assert bool((keep == keep[:, :1, :]).all())
    assert 0 < float(keep.float().mean()) < 1


def test_functional_dropout_needs_a_generator_in_training():
    with pytest.raises(ValueError, match="Generator"):
        TF.dropout(torch.ones(4), 0.1)
    assert torch.equal(TF.dropout(torch.ones(4), 0.1, training=False),
                       torch.ones(4))


def test_dropout_layer_eval_equals_jax_and_trains_at_the_rate():
    x = _x()
    jl, tl = JDropout(0.1), Dropout(0.1)
    jl.eval()
    tl.eval()
    np.testing.assert_array_equal(tl(torch.from_numpy(x)).numpy(),
                                  np.asarray(jl(Tensor(jnp.asarray(x)))
                                             .numpy()))
    tl.train()
    tl.generator = torch.Generator().manual_seed(4)
    big = torch.from_numpy(_x((64, 64, 32))) + 5.0
    assert _within_5_sigma(tl(big) != 0, 0.1)
    assert list(tl.parameters()) == []
