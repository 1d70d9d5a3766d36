"""Port parity of the ViT train step: the port's ``VisionTransformer`` loss
and every gradient against ``jax.value_and_grad`` of the JAX model's loss,
composed as ``bench.py``'s ``bench_vit_l16`` composes it (cross-entropy
through ``log_softmax`` in f32), on a tiny f32 config (img 80, patch 4:
400 patches + the class token = 401 tokens, which the flash-attention op
pads to 512; embed 64, one head of 64, depth 2, 10 classes, B 2) with the
JAX weights crossed over through numpy by name; one AdamW step, the
port's fused kernel against JAX's eager update; a ViT whose 65 tokens
take the plain attention path in both packages; and the port's dropout
(eval logits against JAX's, a loss that is a function of the seed).  On
the CPU the JAX side runs its plain ops (no Pallas kernel is registered
there); the port runs the plain versions of its kernels."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import optimizer as joptim
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn.layer import functional_state
from paddle_tpu.vision.models.vit import VisionTransformer as JViT
from paddle_tpu_torch.models import vit_params_from_numpy
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import fused as tfu
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.vision.models import VisionTransformer

B, CLASSES = 2, 10
TINY = dict(img_size=80, patch_size=4, embed_dim=64, depth=2, num_heads=1,
            num_classes=CLASSES)
SHORT = dict(TINY, img_size=32)            # 8 x 8 patches + 1 = 65 tokens
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
ADAM_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _jax_plain_dispatch():
    """The JAX oracle runs its plain ops, as on a CPU where no Pallas
    override is registered, even after an earlier test on this worker
    registered them: a registered override would call a Pallas kernel
    outside interpret mode."""
    prev = paddle.get_flags(["use_pallas_kernels"])
    paddle.set_flags({"use_pallas_kernels": False})
    yield
    paddle.set_flags(prev)


class _PadCount:
    """Within the block, count the calls of the flash-attention op's
    ``_pad_to_tile`` and of its ``None`` answers (the plain path)."""

    def __enter__(self):
        self.pads = self.declined = 0
        self.saved = (tfa._pad_to_tile, tfa.flash_attention)

        def pad(*a, **kw):
            self.pads += 1
            return self.saved[0](*a, **kw)

        def op(*a, **kw):
            out = self.saved[1](*a, **kw)
            self.declined += out is None
            return out

        tfa._pad_to_tile, tfa.flash_attention = pad, op
        return self

    def __exit__(self, *exc):
        tfa._pad_to_tile, tfa.flash_attention = self.saved


@functools.lru_cache(maxsize=None)
def _jax_model(kind):
    paddle.seed(0)
    model = JViT(**(TINY if kind == "tiny" else SHORT))
    return model, {n: p._value for n, p in model.named_parameters()}


def _batch(kind):
    r = np.random.default_rng(0)
    img = TINY["img_size"] if kind == "tiny" else SHORT["img_size"]
    x = r.normal(0, 1, (B, 3, img, img)).astype(np.float32)
    y = r.integers(0, CLASSES, (B,)).astype(np.int32)
    return x, y


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(kind):
    model, params = _jax_model(kind)
    x, y = _batch(kind)

    def loss_fn(params):
        with functional_state(model, params):
            logits = model(Tensor(jnp.asarray(x)))
        logp = jax.nn.log_softmax(logits._value.astype(jnp.float32), -1)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                             -1))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _port_model(kind, **kw):
    _, params = _jax_model(kind)
    model = VisionTransformer(**(TINY if kind == "tiny" else SHORT),
                              device="cpu", **kw)
    model.load_state_dict(vit_params_from_numpy(
        {k: np.asarray(v) for k, v in params.items()}, device="cpu"))
    return model


def _port_loss(model, kind):
    x, y = _batch(kind)
    logp = torch.log_softmax(model(torch.from_numpy(x)).float(), dim=-1)
    return -logp.gather(1, torch.from_numpy(y).long()[:, None]).mean()


def _port_loss_and_grads(model, kind):
    loss = _port_loss(model, kind)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return loss.detach(), dict(zip(names, grads))


def _counts():
    return (tfa.flash_attention_fwd.launches, tfu.layer_norm_fwd.launches,
            tfu.layer_norm_bwd.launches, tfu.adamw_update.launches)


def test_parameter_names_and_shapes_match_jax():
    _, jparams = _jax_model("tiny")
    model = VisionTransformer(**TINY, device="cpu")
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == {n: tuple(v.shape) for n, v in jparams.items()}
    assert len(got) == 4 + 12 * TINY["depth"] + 2 + 2
    assert got["pos_embed"] == (1, 401, 64)


@pytest.mark.parametrize("kernels,norm_kernels",
                         [(True, True), (True, False), (False, False)],
                         ids=["kernels+norm", "kernels", "plain"])
def test_loss_and_grads_match_jax_value_and_grad(kernels, norm_kernels):
    """At 401 tokens the port's attention takes the pad-to-tile path (once
    per block) when ``kernels`` is on, and plain attention when it is
    off."""
    jloss, jgrads = _jax_loss_and_grads("tiny")
    model = _port_model("tiny", kernels=kernels, norm_kernels=norm_kernels)
    before = _counts()
    with _PadCount() as pads:
        tloss, tgrads = _port_loss_and_grads(model, "tiny")
    assert _counts() == before
    assert pads.pads == (TINY["depth"] if kernels else 0)
    assert pads.declined == 0
    np.testing.assert_allclose(float(tloss), jloss, rtol=LOSS_RTOL)
    assert tgrads.keys() == jgrads.keys()
    for k in jgrads:
        np.testing.assert_allclose(tgrads[k].numpy(), jgrads[k], err_msg=k,
                                   **GRAD_TOL)


def test_one_adamw_step_fused_matches_jax_eager_update():
    """One AdamW(lr 1e-4, weight decay 0.01, the JAX default) step on equal
    parameters and gradients, as ``bench_vit_l16`` takes it: the port's
    fused update (every tensor through the kernel's plain version) against
    the JAX optimizer's eager update."""
    _, jparams = _jax_model("tiny")
    _, jgrads = _jax_loss_and_grads("tiny")
    jopt = joptim.AdamW(learning_rate=1e-4, parameters=[])
    jnew, jst = jopt.apply_gradients_functional(
        jparams, {k: jnp.asarray(v) for k, v in jgrads.items()},
        jopt.init_opt_state(jparams))
    topt = AdamW(learning_rate=1e-4, fused=True)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    tg = {k: torch.from_numpy(v.copy()) for k, v in jgrads.items()}
    before = _counts()
    tnew, tst = topt.apply_gradients_functional(
        tp, tg, topt.init_opt_state(tp, device="cpu"))
    assert _counts() == before
    for k in jparams:
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]),
                                   err_msg=k, **ADAM_TOL)
        for key in ("moment1", "moment2"):
            np.testing.assert_allclose(tst[k][key].numpy(),
                                       np.asarray(jst[k][key]), **ADAM_TOL)


def test_short_sequence_takes_the_plain_path_in_both():
    """At 65 tokens (below the JAX package's 384-token pad threshold) the
    flash-attention op declines and attention runs plain, in the port as
    in JAX; loss and gradients agree."""
    jloss, jgrads = _jax_loss_and_grads("short")
    model = _port_model("short", norm_kernels=True)
    with _PadCount() as pads:
        tloss, tgrads = _port_loss_and_grads(model, "short")
    assert pads.pads == 0 and pads.declined == SHORT["depth"]
    np.testing.assert_allclose(float(tloss), jloss, rtol=LOSS_RTOL)
    for k in jgrads:
        np.testing.assert_allclose(tgrads[k].numpy(), jgrads[k], err_msg=k,
                                   **GRAD_TOL)


def test_dropout_eval_matches_jax_and_training_follows_the_seed():
    """With ``drop_rate`` and ``attn_drop_rate`` 0.1: eval logits equal
    JAX's (dropout off); in training the loss is a function of the seed
    (the model's two generators), moves from the eval loss, and every
    parameter gets a gradient (the pad path's attention runs with its
    in-kernel dropout, through the plain versions here)."""
    drop = dict(drop_rate=0.1, attn_drop_rate=0.1)
    paddle.seed(0)
    jmodel = JViT(**TINY, **drop)
    jmodel.eval()
    named = {n: np.asarray(p._value) for n, p in jmodel.named_parameters()}
    x, _ = _batch("tiny")
    jlogits = np.asarray(jmodel(Tensor(jnp.asarray(x)))._value)

    def port(seed):
        m = VisionTransformer(**TINY, **drop, device="cpu", seed=seed,
                              norm_kernels=True)
        m.load_state_dict(vit_params_from_numpy(named, device="cpu"))
        return m

    model = port(3)
    model.eval()
    with torch.no_grad():
        tlogits = model(torch.from_numpy(x))
    np.testing.assert_allclose(tlogits.numpy(), jlogits, rtol=1e-4,
                               atol=1e-4)
    with torch.no_grad():
        eval_loss = float(_port_loss(model, "tiny"))
    model.train()
    with _PadCount() as pads:
        loss_a, grads = _port_loss_and_grads(model, "tiny")
    assert pads.pads == TINY["depth"]
    with torch.no_grad():
        loss_b = _port_loss(port(3).train(), "tiny")
        loss_c = _port_loss(port(4).train(), "tiny")
    assert float(loss_a) == float(loss_b) != float(loss_c)
    assert float(loss_a) != eval_loss
    assert all(bool(g.abs().sum() > 0) for g in grads.values())



def test_qkv_without_bias_matches_jax():
    """``VisionTransformer(qkv_bias=False)``, which JAX builds with a qkv
    projection without a bias: the port builds the same parameters (no
    ``qkv.bias``), takes the JAX weights by name through
    ``vit_params_from_numpy``, and its loss and gradients match
    ``jax.value_and_grad`` of the JAX model's."""
    paddle.seed(1)
    jmodel = JViT(**SHORT, qkv_bias=False)
    jparams = {n: p._value for n, p in jmodel.named_parameters()}
    assert not any(n.endswith("qkv.bias") for n in jparams)
    model = VisionTransformer(**SHORT, qkv_bias=False, device="cpu")
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} \
        == {n: tuple(v.shape) for n, v in jparams.items()}
    model.load_state_dict(vit_params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, device="cpu"))
    x, y = _batch("short")

    def loss_fn(params):
        with functional_state(jmodel, params):
            logits = jmodel(Tensor(jnp.asarray(x)))
        logp = jax.nn.log_softmax(logits._value.astype(jnp.float32), -1)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                             -1))

    jloss, jgrads = jax.value_and_grad(loss_fn)(jparams)
    tloss, tgrads = _port_loss_and_grads(model, "short")
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    assert tgrads.keys() == jgrads.keys()
    for k in jgrads:
        np.testing.assert_allclose(tgrads[k].numpy(), np.asarray(jgrads[k]),
                                   err_msg=k, **GRAD_TOL)
