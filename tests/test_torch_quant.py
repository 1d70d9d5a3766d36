"""Port parity: paddle_tpu_torch.serving.quant and paddle_tpu_torch.quantization
against the JAX package's KV codec and weight quantizer, on the CPU.

The codec is elementwise (f32 absmax, divide, round half to even, clip,
cast), so codes and scales must be EQUAL bit for bit — fp8 codes compared as
their bytes — and so must the weights ``quantize_params`` snaps at f32.  The
same numpy inputs feed both packages."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import build_functional_llama
from paddle_tpu.quantization import (dequantize_weight as jdequantize_weight,
                                     quantize_weight as jquantize_weight)
from paddle_tpu.serving import quant as jq
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig as TConfig
from paddle_tpu_torch.quantization import dequantize_weight, quantize_weight
from paddle_tpu_torch.serving import quant as tq


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


def _bytes(a):
    """Raw bytes of a jax array or torch tensor, as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy() \
            if a.element_size() == 1 else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _rows(seed=0):
    """K/V-like rows [N, Hkv, D]: magnitudes over three decades, an all-zero
    row, a row whose absmax element lands exactly on +qmax and -qmax, and
    values on half-code ties."""
    r = np.random.default_rng(seed)
    x = (r.standard_normal((48, 4, 32))
         * r.uniform(0.01, 10.0, (48, 4, 1))).astype(np.float32)
    x[3] = 0.0
    x[5, 1] = np.linspace(-2.0, 2.0, 32, dtype=np.float32)
    x[6, 2] = 0.0
    x[6, 2, :4] = [127.0, -127.0, 0.5, 1.5]     # ties at scale 1: round even
    return x


@pytest.mark.parametrize("in_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantize_kv_bit_equal(kv_dtype, in_dtype):
    x = _rows(seed=len(kv_dtype))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if in_dtype == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.bfloat16()
    jdt, jqmax = jq.kv_spec(kv_dtype)
    tdt, tqmax = tq.kv_spec(kv_dtype)
    assert tqmax == jqmax and str(tdt).endswith(str(jdt))
    jcodes, jscale = jq.quantize_kv(jx, qmax=jqmax, dtype=jdt)
    tcodes, tscale = tq.quantize_kv(tx, qmax=tqmax, dtype=tdt)
    assert tcodes.dtype == tdt and tscale.dtype == torch.float32
    np.testing.assert_array_equal(_bytes(tcodes), _bytes(jcodes))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    # the zero row stays zero (at the 1e-8 scale floor); the row through
    # +-qmax uses the whole grid, and int8 ties round to even
    assert not tcodes[3].float().any() and (tscale[3] > 0).all()
    assert tcodes[6, 2, :2].float().tolist() == [tqmax, -tqmax]
    if kv_dtype == "int8":
        assert tcodes[6, 2, 2:4].tolist() == [0, 2]
    np.testing.assert_array_equal(
        tq.dequantize_kv(tcodes, tscale).numpy(),
        np.asarray(jq.dequantize_kv(jcodes, jscale)))


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_page_bytes_matches_jax(kv_dtype, dtype):
    cfg = dict(vocab_size=256, hidden_size=4096, intermediate_size=64,
               num_hidden_layers=32, num_attention_heads=32,
               num_key_value_heads=8)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    for ps in (8, 16):
        assert tq.page_bytes(TConfig(**cfg), ps, kv_dtype=kv_dtype,
                             dtype=tdt) \
            == jq.page_bytes(JConfig(**cfg), ps, kv_dtype=kv_dtype, dtype=jdt)


def test_page_bytes_at_7b_widths():
    """The int8 page at LLaMA-2 7B widths and page size 16: codes plus one
    f32 scale per row, against 8 MiB for a bf16 page."""
    cfg = TConfig()
    assert tq.page_bytes(cfg, 16, kv_dtype="int8") \
        == 2 * 32 * 32 * 16 * 128 + 2 * 32 * 32 * 16 * 4 == 4_325_376
    assert tq.page_bytes(cfg, 16, dtype=torch.bfloat16) == 8 * 2 ** 20


def test_kv_spec_rejects_unknown_names():
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        tq.kv_spec("int4")


@pytest.mark.parametrize("axis", [None, -2, -1, (0, 1)])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_weight_matches_jax(axis, bits):
    r = np.random.default_rng(bits)
    w = (r.standard_normal((3, 16, 24)) * r.uniform(0.1, 4.0, (3, 1, 24))) \
        .astype(np.float32)
    jcodes, jscale = jquantize_weight(jnp.asarray(w), bits=bits, axis=axis)
    tcodes, tscale = quantize_weight(torch.from_numpy(w), bits=bits,
                                     axis=axis)
    assert tcodes.dtype == torch.int8
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(
        dequantize_weight(tcodes, tscale).numpy(),
        np.asarray(jdequantize_weight(jcodes, jscale)))


def test_quantize_params_bit_equal_at_f32():
    """Per-output-channel matmul weights, per-row embedding, norms passed
    through — every leaf equal to the JAX quantizer's at f32."""
    jcfg = JConfig(vocab_size=64, hidden_size=32, intermediate_size=48,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=32)
    ep, bp, hp, *_ = build_functional_llama(jcfg, n_micro=1,
                                            key=jax.random.PRNGKey(0))
    tparams = params_from_numpy(
        *[{k: np.asarray(v) for k, v in t.items()} for t in (ep, bp, hp)],
        device="cpu")
    want = jq.quantize_params((ep, bp, hp), bits=8)
    got = tq.quantize_params(tparams, bits=8)
    for wt, gt, orig in zip(want, got, tparams):
        assert set(wt) == set(gt)
        for k in wt:
            np.testing.assert_array_equal(gt[k].numpy(), np.asarray(wt[k]))
            if k.startswith("ln"):
                assert gt[k] is orig[k]
            else:
                assert not torch.equal(gt[k], orig[k])
