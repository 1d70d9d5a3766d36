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


# -- split-KV: the host plan, the merge, and the split edges on the card ------
def test_split_plan_fills_the_card_from_shapes_alone():
    """The plan of phase 3a's decode launch (4 slots, one query row, 32 kv
    heads, a 72-page table of page 16) puts at least two blocks on each of
    an H100's 132 SMs; a short table gets one split; no plan has more
    splits than pages; the workspace holds m, l and D accumulators per
    split, slot, kv head and group row."""
    plan = tpa.split_plan(4, 1, 32, 32, 128, 72, 16, True)
    assert plan.row_tile == 1
    assert plan.blocks >= 264 and plan.n_splits > 1
    assert plan.n_splits * plan.split_len >= 72 * 16
    assert plan.split_len % 16 == 0
    assert plan.ml_shape == (plan.n_splits, 4, 32, 1, 2)
    assert plan.acc_shape == (plan.n_splits, 4, 32, 1, 128)
    assert tpa.split_plan(4, 1, 32, 32, 128, 4, 16, True).n_splits == 1
    for width, ps in ((1, 16), (3, 8), (5, 64), (65, 16), (200, 16)):
        for s_slots in (1, 4, 64):
            p = tpa.split_plan(s_slots, 1, 8, 8, 64, width, ps, False)
            assert 1 <= p.n_splits <= width
            assert (p.n_splits - 1) * p.split_len < width * ps \
                <= p.n_splits * p.split_len
    # a group of several rows (verify, GQA) with bf16 q takes the
    # tensor-core tile, with f32 q the CUDA-core one; the prefill chunk's
    # 256 rows keep their table in one split (its partials would outweigh
    # the K/V it reads)
    assert tpa.split_plan(4, 5, 16, 4, 128, 72, 16, True).row_tile \
        == tpa.MMA_ROWS
    assert tpa.split_plan(4, 5, 32, 32, 128, 72, 16, True).row_tile \
        == tpa.MMA_ROWS
    assert tpa.split_plan(4, 5, 16, 4, 128, 72, 16, False).row_tile \
        == tpa.CORE_ROWS
    assert tpa.split_plan(1, 256, 32, 32, 128, 40, 16, True).n_splits == 1


def _partials(q, kp, vp, pt, qs, ql, kl, n_splits, split_len, kv=None):
    """What the kernel's split blocks leave: per split, each group row's max
    m of its visible scores in the split (base 2, NEG_INF where none), l and
    the unnormalized accumulator."""
    S, Qmax, Hq, D = q.shape
    hkv = kp.shape[0]
    rep = Hq // hkv
    k = tpa.paged_gather_kv(kp, pt).float()
    v = tpa.paged_gather_kv(vp, pt).float()
    if kv is not None:
        k = k * tpa.paged_gather_scales(kv[0], pt)[..., None]
        v = v * tpa.paged_gather_scales(kv[1], pt)[..., None]
    qg = q.float().reshape(S, Qmax, hkv, rep, D).permute(0, 2, 1, 3, 4) \
        .reshape(S, hkv, Qmax * rep, D)
    s = torch.einsum("shrd,sthd->shrt", qg, k) / np.sqrt(D) * np.log2(np.e)
    t = torch.arange(s.shape[-1])
    qi = (torch.arange(Qmax * rep) // rep)[:, None]
    vis = (t <= qs.long()[:, None, None, None] + qi) \
        & (t < kl.long()[:, None, None, None]) \
        & (qi < ql.long()[:, None, None, None])
    ml, acc = [], []
    for sp in range(n_splits):
        mask = vis & (t >= sp * split_len) & (t < (sp + 1) * split_len)
        m = torch.where(mask, s, torch.full_like(s, -np.inf)).amax(-1)
        p = torch.where(mask, torch.exp2(s - m[..., None]),
                        torch.zeros_like(s))
        l = p.sum(-1)
        m = torch.where(l > 0, m, torch.full_like(m, tpa.NEG_INF))
        ml.append(torch.stack([m, l], -1))
        acc.append(torch.einsum("shrt,sthd->shrd", p, v))
    return torch.stack(ml), torch.stack(acc)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("n_splits", [1, 2, 3, 6])
def test_split_partials_merge_to_jax(n_splits, kv_dtype):
    """Split partials merged by the plain merge equal the JAX kernel (in
    interpret mode) on a mix of a split edge, a verify span across a split
    boundary, a q_len = 0 slot and a GQA group — the kernel's split
    algorithm, checked on the CPU."""
    S, Qmax, Hq, Hkv, D, ps, NP, P = 4, 5, 8, 2, 64, 8, 30, 6
    q, kp, vp, pt = _inputs(S, Qmax, Hq, Hkv, D, ps, NP, P, seed=21)
    split_len = -(-P // n_splits) * ps
    seg = ([split_len - 1, split_len - 3, 0, 2], [1, 5, 0, 3],
           [split_len, split_len + 2, 0, 5])
    arrays = (q, kp, vp, pt, *(np.asarray(x, np.int32) for x in seg))
    ja, ta = _both(arrays)
    jkw, kv = {}, None
    if kv_dtype is not None:
        jkw, tkw, (ja[1], ta[1]), (ja[2], ta[2]) = _quantized(kp, vp, kv_dtype)
        kv = (tkw["k_scales"], tkw["v_scales"])
    want = np.asarray(jpa.ragged_paged_attention(*ja, interpret=True, **jkw))
    ml, acc = _partials(*ta, n_splits, split_len, kv)
    got = tpa.ragged_paged_attention_combine_ref(ml, acc, ta[5], Hq,
                                                 torch.float32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the CPU wrapper of the merge is its plain version
    n = tpa.ragged_paged_attention.combine_launches
    torch.testing.assert_close(
        tpa.ragged_paged_attention_combine(ml, acc, ta[5], Hq, torch.float32),
        got, rtol=0, atol=0)
    assert tpa.ragged_paged_attention.combine_launches == n


def _split_edge_cases(sms):
    """(name, S, Qmax, Hq, Hkv, D, ps, NP, P, q_start, q_len, kv_len) at the
    split edges the plan gives on a card of ``sms`` SMs."""
    L = tpa.split_plan(5, 1, 32, 32, 128, 24, 16, True, sms=sms).split_len
    V = tpa.split_plan(4, 5, 32, 32, 128, 24, 16, True, sms=sms).split_len
    return [
        ("split edges", 5, 1, 32, 32, 128, 16, 160, 24,
         [0, L - 2, L - 1, L, 0], [1, 1, 1, 1, 0], [1, L - 1, L, L + 1, 0]),
        ("verify frontier in a split", 4, 5, 32, 32, 128, 16, 120, 24,
         [V - 2, V - 5, V + V // 2, 0], [5, 5, 5, 0],
         [V + 3, V, V + V // 2 + 5, 7]),
        ("one split", 3, 1, 32, 32, 128, 16, 16, 4, [63, 29, 0], [1, 1, 1],
         [64, 30, 1]),
        ("GQA 16:4 D=64 ps=64", 3, 1, 16, 4, 64, 64, 20, 6, [299, 63, 64],
         [1, 1, 1], [300, 64, 65]),
        ("37-row chunk", 2, 40, 32, 32, 128, 16, 40, 12, [100, 0], [37, 0],
         [137, 0]),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
@pytest.mark.parametrize("case", range(5))
def test_split_edges_match_plain_version_on_card(case, kv_dtype):
    """The kernels at the split grid's edges (kv_len 1, L - 1, L, L + 1 and
    0; a verify frontier across and inside a split; one split; GQA 16:4 at
    D 64 and page 64; a 37-row chunk on the tensor cores with a q_len = 0
    slot) against the plain version, f32 and bf16 q, f32 out, within 1e-4
    — 2e-2 where bf16 q meets quantized pages, since the plain version
    rounds each dequantized row to bf16 and the CUDA-core tile keeps it
    f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    (_, S, Qmax, Hq, Hkv, D, ps, NP, P,
     qs, ql, kl) = _split_edge_cases(sms)[case]
    q, kp, vp, pt = _inputs(S, Qmax, Hq, Hkv, D, ps, NP, P, seed=case)
    kw = {}
    if kv_dtype is not None:
        _, tkw, (_, kq), (_, vq) = _quantized(kp, vp, kv_dtype)
        kw = {k: v.cuda() for k, v in tkw.items()}
        pages = [kq.cuda(), vq.cuda()]
    idx = [torch.from_numpy(pt).cuda()] + [
        torch.tensor(x, dtype=torch.int32, device="cuda") for x in (qs, ql, kl)]
    for dt in (torch.float32, torch.bfloat16):
        tol = 2e-2 if dt == torch.bfloat16 and kv_dtype else 1e-4
        qd = torch.from_numpy(q).cuda().to(dt)
        if kv_dtype is None:
            pages = [torch.from_numpy(a).cuda().to(dt) for a in (kp, vp)]
        got = tpa.ragged_paged_attention(qd, *pages, *idx,
                                         out_dtype=torch.float32, **kw)
        want = tpa.ragged_paged_attention_ref(qd, *pages, *idx,
                                              out_dtype=torch.float32, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        for s, n in enumerate(ql):
            assert not got[s, n:].any()


# -- head dims off 64 / 128 -----------------------------------------------------
@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["plain", "int8"])
@pytest.mark.parametrize("d", [80, 96])
def test_head_dims_match_jax(d, kv_dtype):
    """The plain version against JAX's kernel in interpret mode and its
    reference at head dims 80 (a multiple of 16 that the kernels run at
    width 96) and 96, GQA 8:2, a mix of decode, verify and chunk segments
    and an inactive slot; f32 and int8 pages."""
    S, Hq, Hkv, ps, NP, P = 4, 8, 2, 16, 13, 3
    q, kp, vp, pt = _inputs(S, 8, Hq, Hkv, d, ps, NP, P, seed=17)
    kp *= 3.0
    _check_ragged(q, kp, vp, pt, [7, 14, 16, 0], [1, 5, 8, 0],
                  [8, 19, 24, 0], kv_dtype=kv_dtype)


def test_head_width_map_and_what_the_card_refuses():
    """Every head dim that is a multiple of 8 up to 256 has a compiled
    width (a multiple of 32 that holds it, 224 at 256; 40 at 64, 80 at 96);
    the launch refuses any other head dim before it touches the card (a
    row that is not a multiple of 8 elements would break the kernels'
    16-byte copies)."""
    for d in range(1, 300):
        w = tpa.head_width(d)
        if d % 8 == 0 and d <= 256:
            assert w % 32 == 0 and d <= w <= 256 and (w - d < 32 or w == 256)
        else:
            assert w is None
    assert [tpa.head_width(d) for d in (8, 40, 80, 96, 160, 200, 256)] \
        == [32, 64, 96, 96, 160, 256, 256]
    q, kp, vp, pt = _inputs(2, 2, 4, 2, 12, 16, 5, 2, seed=1)
    ta = [torch.from_numpy(a) for a in (q, kp, vp, pt)]
    seg = [torch.tensor(x, dtype=torch.int32) for x in ([0, 0], [1, 1],
                                                         [1, 1])]
    with pytest.raises(ValueError, match="head dim 12"):
        tpa._launch_kernel(*ta, *seg, 1.0, torch.float32)


@pytest.mark.cuda
def test_head_dim_kernels_match_plain_version_on_card():
    """Rows 1-2 at head dims 40, 80, 96 and 256 (bf16, int8 and fp8 pages;
    decode, verify and chunk) against the plain version on the card, under
    ``chip_smoke.py`` phase 2e's tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import chip_smoke
    chip_smoke.ragged_head_dim_checks(tpa)


# -- page sizes that are not a multiple of 8 ---------------------------------
@pytest.mark.parametrize("tensor_cores", [False, True])
def test_split_plan_aligns_splits_at_every_page_size(tensor_cores):
    """At page sizes 1-32, every plan's split is whole pages and a whole
    number of the kernels' 16-token chunks, the splits cover the table
    (and the last one starts inside it), and a plan never has more splits
    than pages, for decode, verify, GQA and chunk shapes over short and
    long tables."""
    for ps in range(1, 33):
        for s_slots, qmax, hq, hkv in ((4, 1, 32, 32), (4, 5, 32, 32),
                                       (4, 1, 32, 8), (1, 64, 32, 32)):
            for width in (1, 2, 3, 7, 16, 33, 100, 257):
                p = tpa.split_plan(s_slots, qmax, hq, hkv, 128, width, ps,
                                   tensor_cores)
                assert p.split_len % ps == 0 and p.split_len % 16 == 0, \
                    (ps, width, p)
                assert 1 <= p.n_splits <= width
                assert (p.n_splits - 1) * p.split_len < width * ps \
                    <= p.n_splits * p.split_len, (ps, width, p)
    # page 16 keeps the plan it had: splits of whole pages only
    plan = tpa.split_plan(4, 1, 32, 32, 128, 72, 16, True)
    assert (plan.n_splits, plan.split_len) == (5, 240)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
@pytest.mark.parametrize("ps", [2, 4, 12])
def test_page_sizes_off_eight_match_jax(ps, kv_dtype):
    """The plain version against JAX's Pallas kernel in interpret mode and
    its reference at page sizes 2, 4 and 12 (the sizes the card's kernels
    take through their per-row table walk): decode, verify and chunk
    segments, GQA 8:2, lengths on and beside page boundaries, an inactive
    slot; f32, int8 and fp8 pages."""
    S, Hq, Hkv, D = 4, 8, 2, 64
    P = -(-48 // ps)
    q, kp, vp, pt = _inputs(S, 8, Hq, Hkv, D, ps, 3 * P, P, seed=19 + ps)
    kp *= 3.0
    _check_ragged(q, kp, vp, pt, [ps - 1, 2 * ps - 3, 10, 0],
                  [1, 5, 8, 0], [ps, 2 * ps + 2, 18, 0], kv_dtype=kv_dtype)


@pytest.mark.cuda
def test_page_size_kernels_match_plain_version_on_card():
    """Rows 1-2 at page sizes 2, 4, 12 and 20 beside 16 (decode on the CUDA
    cores, GQA decode and verify on the tensor cores, a prefill chunk;
    with and without a split grid; f32 and bf16 q; bf16, int8 and fp8
    pages) against the plain version on the card, under ``chip_smoke.py``
    phase 2's tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import chip_smoke
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = tpa.ragged_paged_attention.combine_launches
    for ps in chip_smoke.PAGE_SIZES:
        for name, kw in chip_smoke.page_size_cases(ps):
            for dtype, out_dtype in chip_smoke.DTYPE_PAIRS:
                args = chip_smoke.make_case(gen, dtype=dtype, **kw)
                chip_smoke.compare(tpa, name, args, out_dtype)
                for kv_dtype in chip_smoke.KV_DTYPES:
                    qargs, scales = chip_smoke.quantize_pages(args, kv_dtype)
                    chip_smoke.compare(tpa, name, qargs, out_dtype, **scales)
    assert tpa.ragged_paged_attention.combine_launches > n
