"""Port parity: paddle_tpu_torch.ops.paged_attention against the JAX package's
ragged paged attention (the Pallas kernel in interpret mode and its jnp
reference), on the CPU at f32 with rtol = atol = 2e-5.  The same numpy inputs
feed both packages — for quantized pages the same int8 / fp8 codes and f32
scales, made by the JAX codec.  On CPU tensors the port's wrapper runs its
plain version, so its kernel launch counters must not move."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.serving.quant import kv_spec, quantize_kv
from paddle_tpu_torch.ops import paged_attention as tpa

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(S, Qmax, Hq, Hkv, D, ps, NP, P, seed):
    r = np.random.default_rng(seed)
    q = r.standard_normal((S, Qmax, Hq, D)).astype(np.float32)
    kp = r.standard_normal((Hkv, NP, ps, D)).astype(np.float32)
    vp = r.standard_normal((Hkv, NP, ps, D)).astype(np.float32)
    pt = r.integers(0, NP, (S, P)).astype(np.int32)
    return q, kp, vp, pt


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _quantized(kp, vp, kv_dtype):
    """(jax kw, torch kw, k codes, v codes) of f32 pages quantized by the
    JAX codec; the torch tensors hold the same bytes."""
    dt, qmax = kv_spec(kv_dtype)
    (kq, ks), (vq, vs) = (quantize_kv(jnp.asarray(p), qmax=qmax, dtype=dt)
                          for p in (kp, vp))
    tdt = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[kv_dtype]

    def t(a):
        a = np.asarray(a)
        if a.dtype.itemsize == 1:
            return torch.from_numpy(a.view(np.uint8).copy()).view(tdt)
        return torch.from_numpy(a.copy())
    return (dict(k_scales=ks, v_scales=vs),
            dict(k_scales=t(ks), v_scales=t(vs)), (kq, t(kq)), (vq, t(vq)))


def _check_ragged(q, kp, vp, pt, qs, ql, kl, kv_dtype=None):
    arrays = (q, kp, vp, pt, np.asarray(qs, np.int32),
              np.asarray(ql, np.int32), np.asarray(kl, np.int32))
    ja, ta = _both(arrays)
    jkw = tkw = {}
    if kv_dtype is not None:
        jkw, tkw, (ja[1], ta[1]), (ja[2], ta[2]) = _quantized(kp, vp,
                                                              kv_dtype)
    want_kernel = np.asarray(jpa.ragged_paged_attention(*ja, interpret=True,
                                                        **jkw))
    want_ref = np.asarray(jpa.ragged_paged_attention_ref(*ja, **jkw))
    launches = (tpa.ragged_paged_attention.launches,
                tpa.ragged_paged_attention.quant_launches)
    calls = tpa.ragged_paged_attention_ref.calls
    got_ref = tpa.ragged_paged_attention_ref(*ta, **tkw).numpy()
    got_wrap = tpa.ragged_paged_attention(*ta, **tkw).numpy()
    for got in (got_ref, got_wrap):
        np.testing.assert_allclose(got, want_kernel, **TOL)
        np.testing.assert_allclose(got, want_ref, **TOL)
    # CPU tensors never launch a kernel: both calls went to the plain
    # version, whose own counter moved twice
    assert (tpa.ragged_paged_attention.launches,
            tpa.ragged_paged_attention.quant_launches) == launches
    assert tpa.ragged_paged_attention_ref.calls == calls + 2
    # padding rows and q_len = 0 slots are exact zeros
    for s, n in enumerate(ql):
        assert not got_wrap[s, n:].any()
    return got_wrap


@pytest.mark.parametrize("case", ["decode", "verify", "chunk", "mixed"])
def test_ragged_segments_match_jax(case):
    """q_len in {1, K+1, chunk} and a mix with an inactive slot — the
    segment shapes the serving engine dispatches (verify segments straddle
    a page boundary: positions 14..18 at ps = 16)."""
    S, Hq, Hkv, D, ps, NP, P = 4, 8, 2, 64, 16, 13, 3
    q, kp, vp, pt = _inputs(S, 8, Hq, Hkv, D, ps, NP, P, seed=11)
    seg = {"decode": ([7, 20, 0, 47], [1, 1, 1, 1], [8, 21, 1, 48]),
           "verify": ([14, 3, 30, 0], [5, 5, 5, 5], [19, 8, 35, 5]),
           "chunk": ([0, 16, 8, 40], [8, 8, 8, 8], [8, 24, 16, 48]),
           "mixed": ([7, 14, 16, 0], [1, 5, 8, 0], [8, 19, 24, 0])}[case]
    _check_ragged(q, kp, vp, pt, *seg)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("case", ["decode", "chunk", "verify", "gqa"])
def test_quantized_segments_match_jax(case, kv_dtype):
    """int8 / fp8 pages with per-row scales (the fused-dequant kernel body)
    at the decode, chunk, verify and GQA segment shapes."""
    S, Hq, Hkv, D, ps, NP, P = 4, 8, 2, 64, 16, 13, 3
    if case == "gqa":
        Hq, Hkv, D, ps, P = 16, 4, 64, 8, 6
    q, kp, vp, pt = _inputs(S, 8, Hq, Hkv, D, ps, NP, P, seed=13)
    kp *= 3.0                       # scales differ from row to row
    seg = {"decode": ([7, 20, 0, 47], [1, 1, 0, 1], [8, 21, 0, 48]),
           "chunk": ([0, 16, 8, 40], [8, 8, 8, 8], [8, 24, 16, 48]),
           "verify": ([14, 3, 30, 0], [5, 3, 1, 0], [19, 6, 31, 0]),
           "gqa": ([0, 6, 20, 40], [4, 1, 8, 2], [4, 7, 28, 42])}[case]
    _check_ragged(q, kp, vp, pt, *seg, kv_dtype=kv_dtype)


def test_scale_aware_plain_version_is_manual_dequant():
    """With scales, the plain version equals dequantizing the pages by hand
    and calling it without scales — bit for bit at f32."""
    S, Hq, Hkv, D, ps, NP, P = 3, 4, 2, 64, 8, 7, 3
    q, kp, vp, pt = _inputs(S, 5, Hq, Hkv, D, ps, NP, P, seed=3)
    _, tkw, (_, kq), (_, vq) = _quantized(kp, vp, "int8")
    seg = [torch.tensor(x, dtype=torch.int32)
           for x in ([3, 0, 10], [5, 0, 2], [8, 0, 12])]
    tq, tpt = torch.from_numpy(q), torch.from_numpy(pt)
    got = tpa.ragged_paged_attention_ref(tq, kq, vq, tpt, *seg, **tkw)
    kd = kq.float() * tkw["k_scales"][..., None]
    vd = vq.float() * tkw["v_scales"][..., None]
    want = tpa.ragged_paged_attention_ref(tq, kd, vd, tpt, *seg)
    assert torch.equal(got, want)
    assert not got[1].any()


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (16, 2)])
def test_ragged_gqa_ratios_match_jax(hq, hkv):
    S, D, ps, NP, P = 3, 32, 8, 11, 4
    q, kp, vp, pt = _inputs(S, 8, hq, hkv, D, ps, NP, P, seed=hq)
    _check_ragged(q, kp, vp, pt, [0, 6, 20], [4, 1, 8], [4, 7, 28])


def test_decode_wrappers_match_jax():
    """Decode-shaped wrappers over lengths {0, 5, ps, P * ps}: empty,
    sub-page, page boundary, full table."""
    S, Hq, Hkv, D, ps, NP, P = 4, 8, 2, 64, 16, 13, 3
    r = np.random.default_rng(5)
    q = r.standard_normal((S, Hq, D)).astype(np.float32)
    kp = r.standard_normal((Hkv, NP, ps, D)).astype(np.float32)
    vp = r.standard_normal((Hkv, NP, ps, D)).astype(np.float32)
    pt = r.permutation(NP - 1)[:S * P].reshape(S, P).astype(np.int32)
    lens = np.array([0, 5, ps, P * ps], np.int32)
    ja, ta = _both((q, kp, vp, pt, lens))
    want = np.asarray(jpa.ragged_paged_attention_decode(*ja, interpret=True))
    want_ref = np.asarray(jpa.paged_attention_decode_ref(*ja))
    launches = tpa.ragged_paged_attention.launches
    got = tpa.ragged_paged_attention_decode(*ta).numpy()
    got_ref = tpa.paged_attention_decode_ref(*ta).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_ref, want_ref, **TOL)
    assert not got[0].any()
    assert tpa.ragged_paged_attention.launches == launches


def test_gather_kv_matches_jax():
    r = np.random.default_rng(2)
    pages = r.standard_normal((2, 7, 4, 8)).astype(np.float32)
    pt = r.integers(0, 7, (3, 5)).astype(np.int32)
    want = np.asarray(jpa.paged_gather_kv(jnp.asarray(pages), jnp.asarray(pt)))
    got = tpa.paged_gather_kv(torch.from_numpy(pages),
                              torch.from_numpy(pt)).numpy()
    np.testing.assert_array_equal(got, want)
    # fp8 pages gather their bytes unchanged
    _, _, (jq, tq), _ = _quantized(pages, pages, "fp8")
    want = np.asarray(jpa.paged_gather_kv(jq, jnp.asarray(pt)))
    got = tpa.paged_gather_kv(tq, torch.from_numpy(pt))
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                  want.view(np.uint8))


def test_gather_scales_matches_jax():
    r = np.random.default_rng(4)
    scales = r.uniform(0.01, 1.0, (2, 7, 4)).astype(np.float32)
    pt = r.integers(0, 7, (3, 5)).astype(np.int32)
    want = np.asarray(jpa.paged_gather_scales(jnp.asarray(scales),
                                              jnp.asarray(pt)))
    got = tpa.paged_gather_scales(torch.from_numpy(scales),
                                  torch.from_numpy(pt)).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrapper_rejects_what_it_does_not_take():
    q, kp, vp, pt = _inputs(2, 2, 4, 2, 64, 16, 5, 2, seed=1)
    ta = [torch.from_numpy(a) for a in (q, kp, vp, pt)]
    seg = [torch.tensor(x, dtype=torch.int32) for x in ([0, 0], [1, 1],
                                                         [1, 1])]
    scales = torch.ones(2, 5, 16)
    with pytest.raises(ValueError, match="both"):
        tpa.ragged_paged_attention(*ta, *seg, k_scales=scales)
    with pytest.raises(ValueError, match="scale pages"):
        tpa.ragged_paged_attention(*ta, *seg, k_scales=scales[:, :4],
                                   v_scales=scales[:, :4])
    with pytest.raises(ValueError):
        tpa.ragged_paged_attention(ta[0][:, :, :3], *ta[1:], *seg)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """The CUDA kernel against its plain version on the card (f32 and
    bf16 inputs, f32 output so only the algorithms differ)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, kp, vp, pt = _inputs(4, 8, 8, 2, 64, 16, 13, 3, seed=11)
    seg = ([7, 14, 16, 0], [1, 5, 8, 0], [8, 19, 24, 0])
    for dt in (torch.float32, torch.bfloat16):
        ta = [torch.from_numpy(a).cuda().to(dt) for a in (q, kp, vp)]
        idx = [torch.from_numpy(pt).cuda()] + [
            torch.tensor(x, dtype=torch.int32, device="cuda") for x in seg]
        got = tpa.ragged_paged_attention(*ta, *idx, out_dtype=torch.float32)
        want = tpa.ragged_paged_attention_ref(*ta, *idx,
                                              out_dtype=torch.float32)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_quant_kernel_matches_plain_version_on_card():
    """The fused-dequant kernel against its plain version on the card, f32
    q and f32 output: only the summation order differs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, kp, vp, pt = _inputs(4, 8, 8, 2, 64, 16, 13, 3, seed=11)
    seg = ([7, 14, 16, 0], [1, 5, 8, 0], [8, 19, 24, 0])
    for kv_dtype in ("int8", "fp8"):
        _, tkw, (_, kq), (_, vq) = _quantized(kp, vp, kv_dtype)
        args = [torch.from_numpy(q).cuda(), kq.cuda(), vq.cuda(),
                torch.from_numpy(pt).cuda()] + [
            torch.tensor(x, dtype=torch.int32, device="cuda") for x in seg]
        kw = {k: v.cuda() for k, v in tkw.items()}
        n = tpa.ragged_paged_attention.quant_launches
        got = tpa.ragged_paged_attention(*args, **kw)
        want = tpa.ragged_paged_attention_ref(*args, **kw)
        torch.cuda.synchronize()
        assert tpa.ragged_paged_attention.quant_launches == n + 1
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
