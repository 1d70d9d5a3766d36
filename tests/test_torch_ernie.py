"""Port parity of the ERNIE MLM train step: ``ErnieForMaskedLM`` loss and
every gradient against ``jax.value_and_grad`` of the JAX model's loss,
composed as ``bench.py``'s ``bench_ernie_mlm`` composes it, on a tiny f32
config (hidden 128, 2 layers, 2 heads of 64, MLP 512, vocab 1,024, S 128,
B 2, dropout 0) with the JAX weights crossed over through numpy by name;
one AdamW step, the port's fused kernel against JAX's eager update; labels
with ``-100``; a 2-D attention mask; the dense head against the chunked
one; and ``nn.functional.softmax`` against the JAX one.  At the published
dropout 0.1: eval logits against JAX's, a loss that is a function of the
seed, and gradients that reach every parameter; and
``ErnieForSequenceClassification``'s eval logits and (at rate 0) loss and
gradients against JAX.  On the CPU the JAX
side runs its plain ops (no Pallas kernel is registered there); the port
runs the plain versions of its kernels."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import optimizer as joptim
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models.ernie import ErnieConfig as JConfig
from paddle_tpu.models.ernie import ErnieForMaskedLM as JMaskedLM
from paddle_tpu.models.ernie import \
    ErnieForSequenceClassification as JSeqCls
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.layer import functional_state
from paddle_tpu_torch.models import (ErnieConfig, ErnieForMaskedLM,
                                     ErnieForSequenceClassification,
                                     ernie_params_from_numpy)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import fused as tfu
from paddle_tpu_torch.optimizer import AdamW

B, S, VOCAB = 2, 128, 1024
KW = dict(vocab_size=VOCAB, hidden_size=128, num_hidden_layers=2,
          num_attention_heads=2, intermediate_size=512,
          max_position_embeddings=S, hidden_dropout_prob=0.0,
          attention_probs_dropout_prob=0.0)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
ADAM_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _jax_plain_dispatch():
    """The JAX oracle runs its plain ops, as on a CPU where no Pallas
    override is registered, even after an earlier test on this worker
    registered them (``paddle_tpu.ops.pallas.register_all(force=True)``):
    a registered override would call a Pallas kernel outside interpret
    mode."""
    import paddle_tpu
    prev = paddle_tpu.get_flags(["use_pallas_kernels"])
    paddle_tpu.set_flags({"use_pallas_kernels": False})
    yield
    paddle_tpu.set_flags(prev)


@functools.lru_cache(maxsize=None)
def _jax_model():
    paddle.seed(0)
    model = JMaskedLM(JConfig(**KW))
    return model, {n: p._value for n, p in model.named_parameters()}


def _batch(variant):
    r = np.random.default_rng(0)
    ids = r.integers(0, VOCAB, (B, S)).astype(np.int32)
    labels = ids.copy()
    mask = None
    if variant == "ignore":
        labels[r.random((B, S)) < 0.3] = -100
    if variant == "mask":
        mask = np.ones((B, S), np.int32)
        mask[1, 100:] = 0
    return ids, labels, mask


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(variant):
    model, params = _jax_model()
    ids, labels, mask = _batch(variant)
    kw = {} if mask is None else dict(attention_mask=Tensor(jnp.asarray(mask)))

    def loss_fn(params):
        with functional_state(model, params):
            loss, _ = model(Tensor(jnp.asarray(ids)),
                            labels=Tensor(jnp.asarray(labels)), **kw)
        return loss._value.astype(jnp.float32)

    # jitted: eager JAX compiles every op of the forward and backward alone
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _port_model(**knobs):
    _, params = _jax_model()
    model = ErnieForMaskedLM(ErnieConfig(**KW), device="cpu", **knobs)
    model.load_state_dict(ernie_params_from_numpy(
        {k: np.asarray(v) for k, v in params.items()}, device="cpu"))
    return model


def _port_loss_and_grads(model, variant, **kw):
    ids, labels, mask = _batch(variant)
    if mask is not None:
        kw["attention_mask"] = torch.from_numpy(mask)
    loss, _ = model(torch.from_numpy(ids), labels=torch.from_numpy(labels),
                    **kw)
    names = [n for n, _ in model.named_parameters()]
    # JAX hands a zero gradient to a parameter the loss never reaches (the
    # pooler); torch autograd gives None unless asked to materialize it
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()],
                                materialize_grads=True)
    return loss.detach(), dict(zip(names, grads))


def _counts():
    return (tfa.flash_attention_fwd.launches, tfu.layer_norm_fwd.launches,
            tfu.layer_norm_bwd.launches, tfu.adamw_update.launches)


def test_parameter_names_and_shapes_match_jax():
    _, jparams = _jax_model()
    model = ErnieForMaskedLM(ErnieConfig(**KW), device="cpu")
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == {n: tuple(v.shape) for n, v in jparams.items()}
    assert len(got) == 8 + 16 * KW["num_hidden_layers"] + 2 + 3


@pytest.mark.parametrize("kernels,norm_kernels",
                         [(True, True), (True, False), (False, False)],
                         ids=["kernels+norm", "kernels", "plain"])
def test_loss_and_grads_match_jax_value_and_grad(kernels, norm_kernels):
    jloss, jgrads = _jax_loss_and_grads("plain")
    model = _port_model(kernels=kernels, norm_kernels=norm_kernels)
    before = _counts()
    tloss, tgrads = _port_loss_and_grads(model, "plain")
    assert _counts() == before
    np.testing.assert_allclose(float(tloss), jloss, rtol=LOSS_RTOL)
    assert tgrads.keys() == jgrads.keys()
    for k in jgrads:
        np.testing.assert_allclose(tgrads[k].numpy(), jgrads[k], err_msg=k,
                                   **GRAD_TOL)
    for k in ("ernie.pooler.weight", "ernie.pooler.bias"):
        assert not tgrads[k].any() and not jgrads[k].any()


@pytest.mark.parametrize("variant", ["ignore", "mask"])
def test_ignored_labels_and_attention_mask_match_jax(variant):
    """Labels with -100 entries (the mean runs over the other tokens) and a
    2-D padding mask (additive -1e4, the masked attention's plain path)."""
    jloss, jgrads = _jax_loss_and_grads(variant)
    tloss, tgrads = _port_loss_and_grads(
        _port_model(kernels=True, norm_kernels=True), variant)
    np.testing.assert_allclose(float(tloss), jloss, rtol=LOSS_RTOL)
    for k in jgrads:
        np.testing.assert_allclose(tgrads[k].numpy(), jgrads[k], err_msg=k,
                                   **GRAD_TOL)


def test_one_adamw_step_fused_matches_jax_eager_update():
    """One AdamW(lr 1e-4, wd 0.01) step on equal parameters and gradients:
    the port's fused update (every tensor through the kernel's plain
    version) against the JAX optimizer's eager update, which is what JAX
    runs on the CPU; the pooler's zero gradient decays its weights in
    both."""
    _, jparams = _jax_model()
    _, jgrads = _jax_loss_and_grads("plain")
    jopt = joptim.AdamW(learning_rate=1e-4, weight_decay=0.01)
    jnew, jst = jopt.apply_gradients_functional(
        jparams, {k: jnp.asarray(v) for k, v in jgrads.items()},
        jopt.init_opt_state(jparams))
    topt = AdamW(learning_rate=1e-4, weight_decay=0.01, fused=True)
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
    pw = "ernie.pooler.weight"
    np.testing.assert_allclose(tnew[pw].numpy(),
                               np.asarray(jparams[pw]) * (1 - 1e-4 * 0.01),
                               rtol=1e-6)


def test_dense_head_equals_chunked_head_in_both_frameworks():
    model, _ = _jax_model()
    ids, labels, _ = _batch("ignore")
    jchunk, _ = model(Tensor(jnp.asarray(ids)),
                      labels=Tensor(jnp.asarray(labels)))
    jdense, jlogits = model(Tensor(jnp.asarray(ids)),
                            labels=Tensor(jnp.asarray(labels)),
                            return_logits=True)
    tmodel = _port_model()
    with torch.no_grad():
        tchunk, none = tmodel(torch.from_numpy(ids),
                              labels=torch.from_numpy(labels))
        tdense, tlogits = tmodel(torch.from_numpy(ids),
                                 labels=torch.from_numpy(labels),
                                 return_logits=True)
    assert none is None and tlogits.shape == (B, S, VOCAB)
    jchunk, jdense = float(jchunk.numpy()), float(jdense.numpy())
    np.testing.assert_allclose(jchunk, jdense, rtol=2e-5)
    np.testing.assert_allclose(float(tchunk), float(tdense), rtol=2e-5)
    np.testing.assert_allclose(float(tdense), jdense, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits.numpy()),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("norm_kernels", [False, True])
@pytest.mark.parametrize("case", ["last", "dtype", "axis1", "untileable"])
def test_functional_softmax_matches_jax(case, norm_kernels):
    """``nn.functional.softmax`` against the JAX one: the last axis of a
    tiling shape (the kernel's plain version with the norm kernels on), a
    ``dtype`` cast of bf16 input to f32 first, ``axis=1`` and a last axis
    of 500 (the plain op in both packages)."""
    r = np.random.default_rng(3)
    shape = (4, 8, 500) if case == "untileable" else (4, 8, 128)
    x = (r.standard_normal(shape) * 3).astype(np.float32)
    axis = 1 if case == "axis1" else -1
    dtype = "float32" if case == "dtype" else None
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if case == "dtype":
        jx, tx = jx.astype(jnp.bfloat16), tx.bfloat16()
    want = JF.softmax(Tensor(jx), axis=axis, dtype=dtype).numpy()
    before = (tfu.softmax_fwd.launches, tfu.softmax_bwd.launches)
    got = TF.softmax(tx, axis=axis, dtype=dtype, norm_kernels=norm_kernels)
    assert (tfu.softmax_fwd.launches, tfu.softmax_bwd.launches) == before
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


DROP_KW = dict(KW, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)


def _crossed(jmodel, tmodel):
    """Load the JAX model's weights into the port's by name; returns the
    JAX parameters."""
    params = {n: p._value for n, p in jmodel.named_parameters()}
    tmodel.load_state_dict(ernie_params_from_numpy(
        {k: np.asarray(v) for k, v in params.items()}, device="cpu"))
    return params


def test_eval_logits_at_dropout_0_1_match_jax():
    """The tiny ERNIE built with dropout 0.1 in eval mode: every dropout is
    off in both packages, and the MLM logits agree within 1e-4."""
    paddle.seed(0)
    jmodel = JMaskedLM(JConfig(**DROP_KW))
    jmodel.eval()
    tmodel = ErnieForMaskedLM(ErnieConfig(**DROP_KW), device="cpu",
                              norm_kernels=True)
    _crossed(jmodel, tmodel)
    tmodel.eval()
    ids, _, _ = _batch("plain")
    want = np.asarray(jmodel(Tensor(jnp.asarray(ids))).numpy())
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kernels", [True, False],
                         ids=["flash dropout", "plain dropout"])
def test_dropout_loss_follows_the_seed_and_grads_reach_every_parameter(
        kernels):
    """At dropout 0.1 in training: the same seed gives the same loss (the
    model's two generators), another seed another, the loss differs from
    eval's, and every parameter but the MLM head's unused pooler gets a
    non-zero gradient.  ``kernels`` sends attention through the flash op's
    in-kernel dropout (its plain versions here), else through the plain
    path's materialised mask."""
    ids, labels, _ = _batch("plain")
    ids, labels = torch.from_numpy(ids), torch.from_numpy(labels)

    def loss_of(seed, train=True):
        model = ErnieForMaskedLM(ErnieConfig(**DROP_KW), device="cpu",
                                 seed=0, kernels=kernels)
        model.ernie.dropout_generator.manual_seed(seed)
        model.ernie.attention_seed_generator.manual_seed(seed)
        model.train(train)
        return model, model(ids, labels=labels)[0]

    model, a = loss_of(5)
    _, b = loss_of(5)
    _, c = loss_of(6)
    _, e = loss_of(5, train=False)
    a_, b_, c_, e_ = (float(x.detach()) for x in (a, b, c, e))
    assert a_ == b_
    assert a_ != c_ and a_ != e_
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(a, list(model.parameters()),
                                materialize_grads=True)
    for n, g in zip(names, grads):
        assert bool(torch.isfinite(g).all()), n
        assert bool(g.any()) != n.startswith("ernie.pooler."), n


def test_generators_are_owned_by_the_model():
    """One device generator for the hidden masks and one host generator
    for the attention seeds, shared by every Dropout and attention layer
    of the model and its head."""
    model = ErnieForSequenceClassification(ErnieConfig(**DROP_KW),
                                           device="cpu", seed=3)
    dg = model.ernie.dropout_generator
    sg = model.ernie.attention_seed_generator
    assert sg.device.type == "cpu" and dg is not sg
    layer = model.ernie.encoder[0]
    assert model.dropout.generator is dg
    assert model.ernie.embeddings.dropout.generator is dg
    assert layer.dropout.generator is dg
    assert layer.attention.seed_generator is sg


def _cls_batch():
    r = np.random.default_rng(5)
    return (r.integers(0, VOCAB, (B, S)).astype(np.int32),
            r.integers(0, 2, (B,)).astype(np.int32))


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["rate0", "eval0.1"])
def test_sequence_classification_matches_jax(dropout):
    """``ErnieForSequenceClassification`` (2 classes): at rate 0 in
    training, the cross-entropy loss and every gradient against
    ``jax.value_and_grad``; built at 0.1, the eval logits."""
    kw = dict(KW, hidden_dropout_prob=dropout,
              attention_probs_dropout_prob=dropout)
    paddle.seed(1)
    jmodel = JSeqCls(JConfig(**kw), num_classes=2)
    tmodel = ErnieForSequenceClassification(ErnieConfig(**kw), num_classes=2,
                                            device="cpu", norm_kernels=True)
    params = _crossed(jmodel, tmodel)
    ids, labels = _cls_batch()
    if dropout:
        jmodel.eval()
        tmodel.eval()
        want = np.asarray(jmodel(Tensor(jnp.asarray(ids))).numpy())
        with torch.no_grad():
            got = tmodel(torch.from_numpy(ids))
        assert got.shape == (B, 2)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
        return

    def loss_fn(params):
        with functional_state(jmodel, params):
            logits = jmodel(Tensor(jnp.asarray(ids)))
        loss = JF.cross_entropy(logits, Tensor(jnp.asarray(labels)))
        return loss._value.astype(jnp.float32)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    logits = tmodel(torch.from_numpy(ids))
    tloss = torch.nn.functional.cross_entropy(logits.float(),
                                              torch.from_numpy(labels).long())
    names = [n for n, _ in tmodel.named_parameters()]
    assert set(names) == set(jgrads)
    tgrads = torch.autograd.grad(tloss, list(tmodel.parameters()),
                                 materialize_grads=True)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    for n, g in zip(names, tgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[n]),
                                   err_msg=n, **GRAD_TOL)


@pytest.mark.parametrize("act", ["relu", "silu"])
def test_hidden_act_by_name_matches_jax(act):
    """``hidden_act`` names any activation of the functional module, as
    JAX's ``getattr(F, c.hidden_act)`` does: the tiny ERNIE with ``relu``
    or ``silu`` gives JAX's MLM logits within 1e-4 (eval mode)."""
    kw = dict(KW, hidden_act=act)
    paddle.seed(0)
    jmodel = JMaskedLM(JConfig(**kw))
    jmodel.eval()
    tmodel = ErnieForMaskedLM(ErnieConfig(**kw), device="cpu")
    _crossed(jmodel, tmodel)
    tmodel.eval()
    ids, _, _ = _batch("plain")
    want = np.asarray(jax.jit(lambda i: jmodel(Tensor(i))._value)(
        jnp.asarray(ids)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    with pytest.raises(NotImplementedError, match="no_such_act"):
        ErnieForMaskedLM(ErnieConfig(**dict(KW, hidden_act="no_such_act")),
                         device="cpu")
