"""Port parity of the rest of the vision zoo: DenseNet, SqueezeNet,
ShuffleNetV2, AlexNet, VGG (``vision/models/densenet.py``), LeNet,
GoogLeNet and Inception-v3 (``vision/models/inception.py``).

Every builder of the two JAX files has the JAX model's parameter and
buffer names, order and shapes; one block of each family matches JAX's
in training mode (output, every gradient, every running buffer
after the call); and each family's loss and every gradient in eval mode
match a jitted ``jax.value_and_grad`` at f32 (loss 1e-5, gradients
1e-4), composed as ``bench_resnet50`` composes its loss (cross-entropy
through ``log_softmax`` in f32), B 2, 10 classes: DenseNet-121 at 32 x 32,
Inception-v3 at 75 x 75 (its smallest input), GoogLeNet at 192 x 192 (the
smallest size whose auxiliary heads see 3 x 3 maps) with all three heads
in the loss (main + 0.3 x each auxiliary, PaddleClas's ``GoogLeNetLoss``
weights), SqueezeNet 1.1, ShuffleNetV2 and AlexNet at 64 x 64, VGG-11 with
BatchNorm at 32 x 32 and LeNet at 28 x 28 (one channel).  The helpers,
numpy initialisers and tolerances are ``tests/test_torch_resnet.py``'s."""
import contextlib
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn import initializer as jinit
from paddle_tpu.nn.layer import functional_state
from paddle_tpu.vision import models as jvm
from paddle_tpu.vision.models import densenet as jdense
from paddle_tpu.vision.models import inception as jincep
from paddle_tpu_torch.models import vision_params_from_numpy
from paddle_tpu_torch.nn import layers as TL
from paddle_tpu_torch.vision import models as tvm
from paddle_tpu_torch.vision.models import densenet as tdense
from paddle_tpu_torch.vision.models import inception as tincep

from test_torch_resnet import (CLASSES, GRAD_TOL, OUT_TOL, jax_state,
                               numpy_init, perturb_batch_norms, port_grads)

B = 2
AUX_WEIGHT = 0.3


@pytest.fixture(autouse=True)
def _jax_plain_dispatch():
    """The JAX oracle runs its plain ops (see ``test_torch_resnet.py``)."""
    prev = paddle.get_flags(["use_pallas_kernels"])
    paddle.set_flags({"use_pallas_kernels": False})
    yield
    paddle.set_flags(prev)


# -- names and shapes --------------------------------------------------------
BUILDERS = ["densenet121", "densenet161", "densenet169", "densenet201",
            "densenet264", "squeezenet1_0", "squeezenet1_1",
            "shufflenet_v2_x1_0", "alexnet", "vgg11", "vgg13", "vgg16",
            "vgg19", ("vgg11", dict(batch_norm=True)), "googlenet",
            "inception_v3", "LeNet"]


def _builder_id(b):
    return b if isinstance(b, str) else f"{b[0]}-bn"


@contextlib.contextmanager
def host_init():
    """Within the block, JAX's ``Uniform`` and ``XavierUniform``
    initialisers fill zeros, and ``jnp.zeros`` / ``ones`` / ``full`` fill
    on the host: each new shape of a device fill compiles on its own
    (about 4 s for a DenseNet's), and a test of names and shapes reads no
    value."""
    def fill(shape, value, dtype=None):
        return jnp.asarray(np.full(shape, value, dtype or np.float32))

    def zeros(self, shape, dtype):
        return fill(shape, 0.0, dtype)

    saved = (jinit.Uniform._generate, jinit.XavierUniform._generate,
             jnp.zeros, jnp.ones, jnp.full)
    jinit.Uniform._generate = jinit.XavierUniform._generate = zeros
    jnp.zeros = lambda shape, dtype=None: fill(shape, 0.0, dtype)
    jnp.ones = lambda shape, dtype=None: fill(shape, 1.0, dtype)
    jnp.full = fill
    try:
        yield
    finally:
        (jinit.Uniform._generate, jinit.XavierUniform._generate, jnp.zeros,
         jnp.ones, jnp.full) = saved


@pytest.mark.parametrize("builder", BUILDERS, ids=map(_builder_id, BUILDERS))
def test_names_and_shapes_match_jax(builder):
    """The port's model has JAX's parameter and buffer names, in JAX's
    order, and shapes, and f32 buffers (each JAX model is built once)."""
    name, kw = (builder, {}) if isinstance(builder, str) else builder
    with host_init():
        jmodel = getattr(jvm, name)(num_classes=CLASSES, **kw)
    want_p = [(n, tuple(p.shape)) for n, p in jmodel.named_parameters()]
    want_b = [(n, tuple(b.shape)) for n, b in jmodel.named_buffers()]
    del jmodel
    ported = getattr(tvm, name)(num_classes=CLASSES, device="cpu", **kw)
    assert [(n, tuple(p.shape)) for n, p in ported.named_parameters()] \
        == want_p
    assert [(n, tuple(b.shape)) for n, b in ported.named_buffers()] == want_b
    assert {b.dtype for b in ported.buffers()} <= {torch.float32}


def test_builders_refuse_what_jax_refuses():
    for fn in (tvm.densenet121, tvm.squeezenet1_1, tvm.shufflenet_v2_x1_0,
               tvm.alexnet, tvm.vgg16, tvm.googlenet, tvm.inception_v3):
        with pytest.raises(NotImplementedError):
            fn(pretrained=True, device="cpu")
    with pytest.raises(ValueError):
        tvm.DenseNet(layers=99, device="cpu")
    with pytest.raises(ValueError):
        tvm.SqueezeNet("2.0", device="cpu")


def test_full_width_parameter_counts():
    """DenseNet-121 and Inception-v3 at 1,000 classes: torchvision's
    DenseNet-121 has 7,978,856 parameters (the same layers); JAX's
    Inception-v3, without an auxiliary head, 23,834,568."""
    assert sum(p.numel() for p in tvm.densenet121(device="cpu")
               .parameters()) == 7_978_856
    assert sum(p.numel() for p in tvm.inception_v3(device="cpu")
               .parameters()) == 23_834_568


# -- one block of each family in training mode -------------------------------
def _mk():
    return dict(dtype=torch.float32, device="cpu",
                generator=torch.Generator().manual_seed(0))


BLOCKS = {
    "dense-layer+transition": (
        lambda: jnn.Sequential(jdense._DenseLayer(16, 8, 2, 0.0),
                               jdense._Transition(24, 12)),
        lambda mk: TL.Sequential(tdense._DenseLayer(16, 8, 2, 0.0, mk=mk),
                                 tdense._Transition(24, 12, mk=mk)),
        (16, 8)),
    "fire": (lambda: jdense._Fire(16, 8, 8, 12),
             lambda mk: tdense._Fire(16, 8, 8, 12, mk=mk), (16, 6)),
    "shuffle-stride-1": (lambda: jdense._ShuffleUnit(16, 16, 1),
                         lambda mk: tdense._ShuffleUnit(16, 16, 1, mk=mk),
                         (16, 6)),
    "shuffle-stride-2": (lambda: jdense._ShuffleUnit(16, 32, 2),
                         lambda mk: tdense._ShuffleUnit(16, 32, 2, mk=mk),
                         (16, 6)),
    "inception-v1": (
        lambda: jincep._InceptionV1Block(16, 8, 8, 12, 4, 8, 8),
        lambda mk: tincep._InceptionV1Block(16, 8, 8, 12, 4, 8, 8, mk=mk),
        (16, 7)),
    "inc-a": (lambda: jincep._IncA(16, 8),
              lambda mk: tincep._IncA(16, 8, mk=mk), (16, 5)),
    "inc-c": (lambda: jincep._IncC(24, 8),
              lambda mk: tincep._IncC(24, 8, mk=mk), (24, 7)),
    "inc-e": (lambda: jincep._IncE(24), lambda mk: tincep._IncE(24, mk=mk),
              (24, 3)),
}


def _jax_block_train(jblock, params, buffers, x, ct):
    """Jitted ``jax.value_and_grad`` of sum(block(x) * ct) in training
    mode: (out, input grad, {name: param grad}, {name: buffer after})."""
    def f(p, xv):
        full = dict(p)
        full.update({k: jnp.asarray(v) for k, v in buffers.items()})
        with functional_state(jblock, full) as fs:
            out = jblock(Tensor(xv))._value
            new = {k: v for k, v in fs.collect().items() if k in buffers}
        return jnp.sum(out * ct), (out, new)

    jblock.train()
    try:
        (_, (out, new)), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(
                {k: jnp.asarray(v) for k, v in params.items()},
                jnp.asarray(x))
    finally:
        jblock.eval()
    return (np.asarray(out), np.asarray(gx),
            {k: np.asarray(v) for k, v in gp.items()},
            {k: np.asarray(v) for k, v in new.items()})


@pytest.mark.parametrize("which", list(BLOCKS))
def test_block_in_training_mode_matches_jax(which):
    """One block in training mode against JAX's (jitted, the updated
    buffers through ``functional_state``): the output, the gradients of
    the input and of every parameter, and every running buffer after the
    call (each moved from its start)."""
    jbuild, tbuild, (cin, hw) = BLOCKS[which]
    r = np.random.default_rng(30)
    with numpy_init(31):
        jblock = jbuild()
    perturb_batch_norms(jblock, 32)
    params, buffers = jax_state(jblock)
    tblock = tbuild(_mk())
    tblock.load_state_dict(vision_params_from_numpy({**params, **buffers},
                                                    device="cpu"))
    tblock.train()
    x = r.normal(0, 1, (B, cin, hw, hw)).astype(np.float32)
    with torch.no_grad():
        shape = tuple(tbuild(_mk()).train()(torch.from_numpy(x)).shape)
    ct = r.normal(0, 1, shape).astype(np.float32)
    jout, jgx, jgp, jbuffers = _jax_block_train(jblock, params, buffers, x,
                                                ct)
    tout, (tgx,), tgp = port_grads(tblock, [x], ct,
                                   wrt=list(tblock.parameters()))
    assert tout.shape == jout.shape == shape
    np.testing.assert_allclose(tout, jout, **OUT_TOL)
    np.testing.assert_allclose(tgx, jgx, **GRAD_TOL)
    names = [n for n, _ in tblock.named_parameters()]
    assert names == list(params) and sorted(names) == sorted(jgp)
    for name, got in zip(names, tgp):
        np.testing.assert_allclose(got, jgp[name], err_msg=name, **GRAD_TOL)
    assert [n for n, _ in tblock.named_buffers()] == list(buffers)
    assert sorted(jbuffers) == sorted(buffers)
    for name, b in tblock.named_buffers():
        np.testing.assert_allclose(b.numpy(), jbuffers[name], err_msg=name,
                                   **OUT_TOL)
        assert not np.allclose(jbuffers[name], buffers[name])


# -- whole models in eval mode -----------------------------------------------
def _heads(out):
    return out if isinstance(out, tuple) else (out,)


def _weights(n):
    return [1.0] + [AUX_WEIGHT] * (n - 1)


@functools.lru_cache(maxsize=1)        # one model a test; VGG's is 0.5 GB
def _jax_zoo_model(name, kw):
    with numpy_init(1):
        model = getattr(jvm, name)(num_classes=CLASSES, **dict(kw))
    perturb_batch_norms(model, 2)
    model.eval()
    return (model, *jax_state(model))


def _batch(img, channels):
    r = np.random.default_rng(0)
    return (r.normal(0, 1, (B, channels, img, img)).astype(np.float32),
            r.integers(0, CLASSES, (B,)).astype(np.int32))


def _jax_loss_and_grads(name, kw, img, channels):
    model, params, buffers = _jax_zoo_model(name, kw)
    x, y = _batch(img, channels)

    def loss_fn(p):
        full = dict(p)
        full.update({k: jnp.asarray(v) for k, v in buffers.items()})
        with functional_state(model, full):
            outs = _heads(model(Tensor(jnp.asarray(x))))
        loss = 0.0
        for w, o in zip(_weights(len(outs)), outs):
            logp = jax.nn.log_softmax(o._value.astype(jnp.float32), -1)
            loss = loss + w * -jnp.mean(jnp.take_along_axis(
                logp, jnp.asarray(y)[:, None], -1))
        return loss

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        {k: jnp.asarray(v) for k, v in params.items()})
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


MODELS = [("densenet121", (), 32, 3), ("inception_v3", (), 75, 3),
          ("googlenet", (), 192, 3), ("squeezenet1_1", (), 64, 3),
          ("shufflenet_v2_x1_0", (), 64, 3), ("alexnet", (), 64, 3),
          ("vgg11", (("batch_norm", True),), 32, 3), ("LeNet", (), 28, 1)]


@pytest.mark.parametrize("name,kw,img,channels", MODELS,
                         ids=[m[0] + ("-bn" if m[1] else "") for m in MODELS])
def test_model_loss_and_grads_match_jax_in_eval_mode(name, kw, img,
                                                     channels):
    """The loss to 1e-5 and every gradient to 1e-4 against the jitted
    ``jax.value_and_grad``, f32, eval mode (the dropouts pass, the
    BatchNorms use their redrawn buffers, which do not move)."""
    jloss, jgrads = _jax_loss_and_grads(name, kw, img, channels)
    _, params, buffers = _jax_zoo_model(name, kw)
    model = getattr(tvm, name)(num_classes=CLASSES, device="cpu", **dict(kw))
    model.load_state_dict(vision_params_from_numpy({**params, **buffers},
                                                   device="cpu"))
    model.eval()
    x, y = _batch(img, channels)
    outs = _heads(model(torch.from_numpy(x)))
    assert len(outs) == (3 if name == "googlenet" else 1)
    loss = 0.0
    for w, o in zip(_weights(len(outs)), outs):
        assert tuple(o.shape) == (B, CLASSES)
        logp = torch.log_softmax(o.float(), dim=-1)
        loss = loss + w * -logp.gather(1, torch.from_numpy(y).long()[:, None]
                                       ).mean()
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), jloss, **OUT_TOL)
    assert names == list(params) and sorted(names) == sorted(jgrads)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), jgrads[n], err_msg=n,
                                   **GRAD_TOL)
    for n, b in model.named_buffers():
        np.testing.assert_array_equal(b.numpy(), buffers[n])


def test_dropout_draws_from_the_model_generator():
    """In training mode the dropouts of a model draw from its own
    ``dropout_generator``: two models of one seed give equal outputs, and
    the output differs from eval mode."""
    x = torch.from_numpy(_batch(64, 3)[0])
    outs = []
    for _ in range(2):
        m = tvm.squeezenet1_1(num_classes=CLASSES, device="cpu", seed=5)
        drops = [d for d in m.modules() if isinstance(d, TL.Dropout)]
        assert drops and all(d.generator is m.dropout_generator
                             for d in drops)
        outs.append(m.train()(x))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert not torch.allclose(outs[0], m.eval()(x))
