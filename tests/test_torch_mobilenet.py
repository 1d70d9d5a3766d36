"""Port parity of the convolutional vision path, part 2: the MobileNets.
Parameter and buffer names and shapes of V1, V2, V3-Small and V3-Large
equal JAX's; one ``InvertedResidual`` in training mode matches JAX's
eagerly (output, gradients, updated buffers); and MobileNetV2's and
MobileNetV3-Small's loss and every gradient in eval mode match a jitted
``jax.value_and_grad``, composed as ``bench_resnet50`` composes it, at
32 x 32, B 2, 10 classes.  The helpers, the numpy initialisers and the
tolerances are ``tests/test_torch_resnet.py``'s."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision.models import mobilenet as jmobilenet
from paddle_tpu_torch.models import vision_params_from_numpy
from paddle_tpu_torch.vision.models import mobilenet as tmobilenet

from test_torch_resnet import (GRAD_TOL, OUT_TOL, hold_model,
                               hold_names_and_shapes, jax_eager_grads,
                               jax_state, numpy_init, perturb_batch_norms,
                               port_grads)


@pytest.fixture(autouse=True)
def _jax_plain_dispatch():
    """The JAX oracle runs its plain ops (see ``test_torch_resnet.py``)."""
    prev = paddle.get_flags(["use_pallas_kernels"])
    paddle.set_flags({"use_pallas_kernels": False})
    yield
    paddle.set_flags(prev)


@pytest.mark.parametrize("name", ["mobilenet_v1", "mobilenet_v2",
                                  "mobilenet_v3_small",
                                  "mobilenet_v3_large"])
def test_mobilenet_names_and_shapes_match_jax(name):
    """Names and shapes; the classifier's dropout draws from the model's
    own generator on its device (V1 has no dropout)."""
    ported = hold_names_and_shapes(name)
    drops = [m for m in ported.modules()
             if type(m).__name__ == "Dropout"]
    assert len(drops) == (0 if name == "mobilenet_v1" else 1)
    for m in drops:
        assert m.p == 0.2 and m.generator is ported.dropout_generator
        assert m.generator.device == torch.device("cpu")


def test_mobilenet_v3_small_has_jax_parameter_count():
    full = tmobilenet.mobilenet_v3_small(device="cpu")
    assert len(list(full.named_parameters())) == 142
    assert sum(p.numel() for p in full.parameters()) == 2_542_856


def test_inverted_residual_in_training_mode_matches_jax():
    """One ``InvertedResidual`` (16 -> 16 channels, expansion 6, stride 1:
    the residual add) in training mode, eagerly against JAX: the output,
    the gradients of the input and of every parameter, and every running
    buffer after the call."""
    r = np.random.default_rng(20)
    with numpy_init(21):
        jblock = jmobilenet.InvertedResidual(16, 16, 1, 6)
    perturb_batch_norms(jblock, 22)
    params, buffers = jax_state(jblock)
    tblock = tmobilenet.InvertedResidual(16, 16, 1, 6, mk=dict(
        dtype=torch.float32, device="cpu",
        generator=torch.Generator().manual_seed(0)))
    assert tblock.use_res
    tblock.load_state_dict(vision_params_from_numpy({**params, **buffers},
                                                    device="cpu"))
    jblock.train()
    tblock.train()
    x = r.normal(0, 1, (2, 16, 8, 8)).astype(np.float32)
    ct = r.normal(0, 1, x.shape).astype(np.float32)
    jparams = [p for _, p in jblock.named_parameters()]
    jout, (jgx,), jgp = jax_eager_grads(jblock, [x], ct, wrt=jparams)
    tout, (tgx,), tgp = port_grads(tblock, [x], ct,
                                   wrt=list(tblock.parameters()))
    np.testing.assert_allclose(tout, jout, **OUT_TOL)
    np.testing.assert_allclose(tgx, jgx, **GRAD_TOL)
    for name, got, want in zip(params, tgp, jgp):
        np.testing.assert_allclose(got, want, err_msg=name, **GRAD_TOL)
    _, jbuffers = jax_state(jblock)
    for name, b in tblock.named_buffers():
        np.testing.assert_allclose(b.numpy(), jbuffers[name], err_msg=name,
                                   **OUT_TOL)
        assert not np.allclose(jbuffers[name], buffers[name])


@pytest.mark.parametrize("name", ["mobilenet_v2", "mobilenet_v3_small"])
def test_mobilenet_loss_and_grads_match_jax_in_eval_mode(name):
    """The whole model at 32 x 32, B 2, 10 classes, in eval mode, f32: the
    loss and every gradient against the jitted ``jax.value_and_grad``
    (depthwise convolutions, ReLU6, Hardswish, the squeeze-excitation's
    Hardsigmoid, the classifier); the buffers stay."""
    hold_model(name, train=False)
