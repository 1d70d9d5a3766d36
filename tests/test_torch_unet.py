"""Port parity of the SD-1.5-style UNet slice on the CPU at f32: the
functionals it adds (``silu``, ``group_norm``, nearest ``interpolate``),
``timestep_embedding``, ``ResBlock``, ``CrossAttention`` and
``TransformerBlock`` against the JAX package's, with the JAX weights
crossed over through numpy by name; and a small UNet's MSE-against-noise
loss and every gradient against ``jax.value_and_grad`` of the JAX model's
loss, composed as ``bench.py``'s ``bench_sd_unet`` composes it.  The small
UNet (channels 160, 4 heads of 40, 16 x 16 latents) sends its level-0
self-attention (256 tokens at head dim 40) down the port's flash-attention
route, whose kernels run their plain versions on CPU tensors; its middle
block (64 tokens) and its cross-attention (7 context tokens) take plain
attention in both packages.  Tolerances: outputs 1e-5 (2e-5 for the
attention blocks), the loss 1e-5 relative, each gradient 1e-4 of its
tensor's max |grad|."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import unet as junet
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.layer import functional_state
from paddle_tpu_torch.models import unet as tunet
from paddle_tpu_torch.models import unet_params_from_numpy
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import fused as tfu

TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
SMALL = dict(block_channels=(160, 160), layers_per_block=1, attn_levels=(0,),
             num_heads=4, cross_attention_dim=32, norm_groups=8)
B, HW, CTX_LEN = 2, 16, 7


@pytest.fixture(autouse=True)
def _jax_plain_dispatch():
    """The JAX oracle runs its plain ops, as on a CPU where no Pallas
    override is registered, even after an earlier test on this worker
    registered them; f32 products at full precision on both sides."""
    prev = paddle.get_flags(["use_pallas_kernels"])
    paddle.set_flags({"use_pallas_kernels": False})
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        torch.set_float32_matmul_precision(prec)
        paddle.set_flags(prev)


def _rng(seed):
    return np.random.default_rng(seed)


def _j(x):
    return Tensor(jnp.asarray(x))


def _counts():
    return (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_bwd_dkv.launches,
            tfa.flash_attention_bwd_dq.launches,
            tfu.layer_norm_fwd.launches, tfu.layer_norm_bwd.launches)


def _parts():
    return tunet._Parts(torch.float32, "cpu", 0, True, False)


def _crossed(jmodule, tmodule):
    """Load the JAX module's weights into the port's module, by name."""
    named = {n: np.asarray(p._value) for n, p in jmodule.named_parameters()}
    assert set(named) == {n for n, _ in tmodule.named_parameters()}
    tmodule.load_state_dict(unet_params_from_numpy(named, device="cpu"))
    return tmodule


# -- the functionals -----------------------------------------------------------
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_group_norm_matches_jax(fmt):
    r = _rng(1)
    shape = (2, 64, 5, 6) if fmt == "NCHW" else (2, 5, 6, 64)
    x = r.standard_normal(shape).astype(np.float32) * 3 + 1
    w = r.standard_normal(64).astype(np.float32)
    b = r.standard_normal(64).astype(np.float32)
    want = JF.group_norm(_j(x), 8, 1e-5, _j(w), _j(b), fmt)._value
    got = TF.group_norm(torch.from_numpy(x), 8, 1e-5, torch.from_numpy(w),
                        torch.from_numpy(b), fmt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = JF.group_norm(_j(x), 8, data_format=fmt)._value
    np.testing.assert_allclose(
        TF.group_norm(torch.from_numpy(x), 8, data_format=fmt).numpy(),
        np.asarray(plain), **TOL)


def test_silu_matches_jax():
    x = _rng(2).standard_normal((3, 7, 11)).astype(np.float32) * 4
    np.testing.assert_allclose(TF.silu(torch.from_numpy(x)).numpy(),
                               np.asarray(JF.silu(_j(x))._value), **TOL)


@pytest.mark.parametrize("kw", [dict(scale_factor=2), dict(size=[7, 9]),
                                dict(size=[7, 9], align_corners=True),
                                dict(scale_factor=1.5,
                                     data_format="NHWC")],
                         ids=["x2", "size", "align_corners", "NHWC x1.5"])
def test_nearest_interpolate_matches_jax(kw):
    x = _rng(3).standard_normal((2, 3, 4, 6)).astype(np.float32)
    want = np.asarray(JF.interpolate(_j(x), mode="nearest", **kw)._value)
    got = TF.interpolate(torch.from_numpy(x), mode="nearest", **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_interpolate_modes_not_ported_raise():
    with pytest.raises(ValueError, match="nearest"):
        TF.interpolate(torch.zeros(1, 1, 2, 2), scale_factor=2,
                       mode="bilinear")


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 17, 999], np.int32)
    want = np.asarray(junet.timestep_embedding(_j(t), 320)._value)
    got = tunet.timestep_embedding(torch.from_numpy(t), 320)
    assert got.dtype == torch.float32 and got.shape == (4, 320)
    # at t = 999 the f32 argument t * freq is only resolved to 6.1e-5 (its
    # spacing near 1,000), and the two exp implementations may round a
    # frequency one ulp apart: cos / sin agree to a few such steps
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.5e-4)
    np.testing.assert_allclose(got[:2].numpy(), want[:2], **TOL)


# -- the blocks ------------------------------------------------------------------
@pytest.mark.parametrize("c_in,c_out", [(32, 64), (64, 64)],
                         ids=["skip conv", "identity skip"])
def test_resblock_matches_jax(c_in, c_out):
    paddle.seed(3)
    jblock = junet.ResBlock(c_in, c_out, 48, 8)
    tblock = _crossed(jblock, tunet.ResBlock(c_in, c_out, 48, 8, _parts()))
    r = _rng(4)
    x = r.standard_normal((2, c_in, 6, 5)).astype(np.float32)
    temb = r.standard_normal((2, 48)).astype(np.float32)
    want = np.asarray(jblock(_j(x), _j(temb))._value)
    got = tblock(torch.from_numpy(x), torch.from_numpy(temb))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("ctx_len", [None, CTX_LEN], ids=["self", "cross"])
def test_cross_attention_matches_jax(ctx_len):
    """Self-attention over 256 tokens at head dim 40 takes the
    flash-attention route (its plain versions here); cross-attention over 7
    context tokens the plain path."""
    dim, ctx_dim, heads = 160, 32, 4
    paddle.seed(5)
    jattn = junet.CrossAttention(dim, dim if ctx_len is None else ctx_dim,
                                 heads)
    tattn = _crossed(jattn, tunet.CrossAttention(
        dim, dim if ctx_len is None else ctx_dim, heads, _parts()))
    assert tattn.to_q.bias is None and tattn.to_out.bias is not None
    r = _rng(6)
    x = r.standard_normal((2, 256, dim)).astype(np.float32)
    ctx = None if ctx_len is None else \
        r.standard_normal((2, ctx_len, ctx_dim)).astype(np.float32)
    want = np.asarray(jattn(_j(x), None if ctx is None else _j(ctx))._value)
    before = _counts()
    got = tattn(torch.from_numpy(x),
                None if ctx is None else torch.from_numpy(ctx))
    assert _counts() == before
    np.testing.assert_allclose(got.detach().numpy(), want, **ATTN_TOL)


def test_transformer_block_matches_jax():
    dim, heads = 160, 4
    paddle.seed(7)
    jblock = junet.TransformerBlock(dim, 32, heads)
    tblock = _crossed(jblock, tunet.TransformerBlock(dim, 32, heads,
                                                     _parts()))
    r = _rng(8)
    x = r.standard_normal((2, dim, 16, 16)).astype(np.float32)
    ctx = r.standard_normal((2, CTX_LEN, 32)).astype(np.float32)
    want = np.asarray(jblock(_j(x), _j(ctx))._value)
    got = tblock(torch.from_numpy(x), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.detach().numpy(), want, **ATTN_TOL)


# -- the small UNet's train-step loss and gradients -----------------------------
@functools.lru_cache(maxsize=None)
def _jax_model():
    paddle.seed(0)
    model = junet.UNet2DConditionModel(junet.UNetConfig(**SMALL))
    return model, {n: p._value for n, p in model.named_parameters()}


def _batch():
    r = _rng(0)
    lat = r.normal(0, 1, (B, 4, HW, HW)).astype(np.float32)
    t = r.integers(0, 1000, (B,)).astype(np.int32)
    ctx = r.normal(0, 1, (B, CTX_LEN, 32)).astype(np.float32)
    noise = r.normal(0, 1, (B, 4, HW, HW)).astype(np.float32)
    return lat, t, ctx, noise


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads():
    model, params = _jax_model()
    lat, t, ctx, noise = _batch()

    def loss_fn(params):
        with functional_state(model, params):
            pred = model(_j(lat), _j(t), _j(ctx))
        return jnp.mean((pred._value.astype(jnp.float32)
                         - jnp.asarray(noise)) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _port_model(**kw):
    _, params = _jax_model()
    model = tunet.UNet2DConditionModel(tunet.UNetConfig(**SMALL),
                                       device="cpu", **kw)
    model.load_state_dict(unet_params_from_numpy(
        {k: np.asarray(v) for k, v in params.items()}, device="cpu"))
    return model


class _AttentionRoutes:
    """Within the block, count the flash-attention op's calls and its
    ``None`` answers (the shapes it declines, which run plain)."""

    def __enter__(self):
        self.calls = self.declined = 0
        self.saved = tfa.flash_attention

        def op(*a, **kw):
            out = self.saved(*a, **kw)
            self.calls += 1
            self.declined += out is None
            return out
        tfa.flash_attention = op
        return self

    def __exit__(self, *exc):
        tfa.flash_attention = self.saved


def test_parameter_names_and_shapes_match_jax():
    _, jparams = _jax_model()
    model = tunet.UNet2DConditionModel(tunet.UNetConfig(**SMALL),
                                       device="cpu")
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == {n: tuple(v.shape) for n, v in jparams.items()}
    # a level without attention holds None where JAX's LayerList does
    assert [a is None for a in model.down_attn] == [False, True]
    assert [a is None for a in model.up_attn] == [True, False]


@pytest.mark.parametrize("kernels,norm_kernels",
                         [(True, True), (False, False)],
                         ids=["kernels+norm", "plain"])
def test_loss_and_grads_match_jax_value_and_grad(kernels, norm_kernels):
    """With ``kernels`` the two level-0 self-attentions (256 tokens, head
    dim 40) take the flash-attention op and the middle block's (64 tokens)
    and the three cross-attentions are declined; ``norm_kernels`` sends
    the LayerNorms of width 160 to the LayerNorm op, which declines them
    (160 is not a multiple of 128), as JAX's does."""
    jloss, jgrads = _jax_loss_and_grads()
    model = _port_model(kernels=kernels, norm_kernels=norm_kernels)
    lat, t, ctx, noise = _batch()
    before = _counts()
    with _AttentionRoutes() as routes:
        pred = model(torch.from_numpy(lat), torch.from_numpy(t),
                     torch.from_numpy(ctx))
        loss = ((pred.float() - torch.from_numpy(noise)) ** 2).mean()
        names = [n for n, _ in model.named_parameters()]
        grads = dict(zip(names, torch.autograd.grad(loss,
                                                    list(model.parameters()))))
    assert _counts() == before
    assert (routes.calls, routes.declined) == ((6, 4) if kernels else (0, 0))
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    assert grads.keys() == jgrads.keys()
    for k, want in jgrads.items():
        np.testing.assert_allclose(grads[k].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=k)


def test_sd15_config_and_head_dims():
    """SD-1.5's self-attention head dims are the ones this slice's kernels
    were widened for: 40, 80 and 160 at 4,096, 1,024 and 256 tokens, which
    the op takes at widths 48, 80 and 160."""
    c = tunet.unet_config_sd15()
    assert vars(c) == vars(junet.unet_config_sd15())
    dims = [c.block_channels[lvl] // c.num_heads for lvl in c.attn_levels]
    assert dims == [40, 80, 160]
    assert [tfa.head_width(d) for d in dims] == [48, 80, 160]
    tokens = [(64 >> lvl) ** 2 for lvl in c.attn_levels]
    assert all(tfa._supported((8, s, 8, d), (8, s, 8, d))
               for s, d in zip(tokens, dims))
    assert not tfa._supported((8, 64, 8, 160), (8, 64, 8, 160))
    assert not tfa._supported((8, 4096, 8, 40), (8, 77, 8, 40))
