"""Port parity of flash attention's dropout and segment branches (split
from ``test_torch_flash_attention.py``, whose helpers and numerics fixture
it shares): the dropout branch against JAX's masked formula on the same
mask, its lse and rate edges and its seeds; the wgmma bodies' keep bits
and the forward's tile order, modelled lane by lane on the CPU; the mask
read out of each plain version; segment ids (the varlen mask) and the
pad-to-tile path against the Pallas kernels in interpret mode; and the
card's cases of both branches, marked ``cuda``."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_flash_attention import (  # noqa: F401
    BWD_TOL, DROP_IDS, DROP_SHAPES, FWD_TOL, _bshd, _counts, _factor,
    _held_bf16, _inputs, _jax_masked_attention, _pinned_numerics, _rows,
    _two_segments, chip_smoke, jfa, tfa)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", DROP_SHAPES, ids=DROP_IDS)
def test_dropout_matches_jax_masked_formula(shape, causal):
    """The differentiable op at rate 0.1 (the plain versions on the CPU)
    against ``jax.vjp`` of JAX's masked formula under the same mask,
    crossed through numpy: o within 2e-5, dq / dk / dv within 1e-4 of the
    tensor's max |grad|."""
    rate, seed = 0.1, 1234567
    b, s_q, s_k, hq, hkv, d = shape
    q, k, v, do = _inputs(shape, seed=8)
    factor = _factor(seed, shape, rate)
    jout, vjp = jax.vjp(
        lambda a, b_, c: _jax_masked_attention(a, b_, c, factor, causal),
        *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    before = _counts()
    out = tfa.flash_attention(tq, tk, tv, causal=causal, dropout_rate=rate,
                              dropout_seed=seed)
    out.backward(torch.from_numpy(do))
    assert _counts() == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    for t, want in zip((tq, tk, tv), jgrads):
        want = np.asarray(want)
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    # the mask is not a no-op: o moved from the undropped output
    plain = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                causal=causal)
    assert not torch.allclose(out.detach(), plain, atol=1e-3)


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_lse_is_the_undropped_lse(causal):
    """Under dropout lse keeps the undropped p: the plain forward's lse at
    rate 0.1 equals the Pallas kernel's at rate 0 (interpret mode)."""
    shape = (1, 128, 256, 4, 2, 64)
    b, s_q, s_k, hq, hkv, d = shape
    q, k, v, _ = _inputs(shape, seed=9)
    scale = 1.0 / math.sqrt(d)
    _, jlse = jax.block_until_ready(jfa.flash_attention_fwd_kernel_call(
        _rows(q), _rows(k), _rows(v), causal, scale, interpret=True,
        n_q_heads=hq, n_kv_heads=hkv))
    _, lse = tfa.flash_attention_fwd(*(torch.from_numpy(x)
                                       for x in (q, k, v)), causal, scale,
                                     dropout_rate=0.1, seed=77)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD_TOL)


def test_dropout_rate_zero_is_the_undropped_path():
    """Rate 0 is bit-equal to no dropout, forward and gradients, in the op
    and in each plain version."""
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs((1, 128, 128, 4, 2, 64), seed=10))
    scale = 1.0 / 8.0
    a = tfa.flash_attention_fwd_ref(q, k, v, True, scale)
    b = tfa.flash_attention_fwd_ref(q, k, v, True, scale, 0.0, 99)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    delta = (do * a[0]).sum(-1).permute(0, 2, 1).reshape(a[1].shape)
    for fn in (tfa.flash_attention_bwd_dkv_ref,
               tfa.flash_attention_bwd_dq_ref):
        x = fn(q, k, v, do, a[1], delta, True, scale)
        y = fn(q, k, v, do, a[1], delta, True, scale, 0.0, 99)
        x, y = (x, y) if isinstance(x, tuple) else ((x,), (y,))
        assert all(torch.equal(i, j) for i, j in zip(x, y))
    grads = []
    for rate in (None, 0.0):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        kw = {} if rate is None else dict(dropout_rate=rate, dropout_seed=5)
        out = tfa.flash_attention(*ts, causal=True, **kw)
        out.backward(do)
        grads.append([out.detach()] + [t.grad for t in ts])
    assert all(torch.equal(x, y) for x, y in zip(*grads))


def test_dropout_rate_one_returns_zeros():
    """A rate of 1 or more returns zeros of q's shape, before the shape
    check (so an untileable shape gets zeros too), as JAX's op does."""
    for s in (128, 197):
        q = torch.randn(1, s, 2, 64)
        for rate in (1.0, 1.5):
            out = tfa.flash_attention(q, q, q, dropout_rate=rate)
            assert out is not None and torch.equal(out, torch.zeros_like(q))
    jq = jnp.ones((1, 197, 2, 64))
    assert not np.asarray(jfa.flash_attention(jq, jq, jq,
                                              dropout_rate=1.0)).any()


def test_dropout_seed_comes_from_the_host_generator():
    """A None seed is drawn from the explicit host generator: equal
    generator states give equal outputs, and successive calls differ; no
    generator, or one on another device, raises."""
    q, k, v, _ = (torch.from_numpy(x) for x in
                  _inputs((1, 128, 128, 2, 2, 64), seed=11))
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    a = tfa.flash_attention(q, k, v, dropout_rate=0.1, generator=g1)
    b = tfa.flash_attention(q, k, v, dropout_rate=0.1, generator=g2)
    c = tfa.flash_attention(q, k, v, dropout_rate=0.1, generator=g1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="host"):
        tfa.flash_attention(q, k, v, dropout_rate=0.1)


def _nibbles(seed, cell, row, bhq, rate):
    """The 4 keep bits (bit i: word i >= the threshold) of the Philox calls
    at the broadcast int64 counters (cell, row, bhq, 0)."""
    words = tfa.philox4x32_10((cell, row, bhq, 0), tfa._seed_words(seed))
    thresh = tfa.dropout_threshold(rate)
    return sum((w >= thresh).long() << i for i, w in enumerate(words))


def _bit(bits, i):
    return ((bits >> i) & 1).bool()


def _wgmma_dq_keep(seed, bh, s_q, s_k, rate, bm, causal, bk=64):
    """keep [bh, s_q, s_k] as the wgmma dQ's (and forward's) lanes hold it,
    and the scores its tiles cover (key tiles of ``bk`` per block of ``bm``
    q rows).  A lane (g, t) of the warp whose 16 q rows start at ``r16``
    holds rows r16 + g and r16 + g + 8 and, per key tile at kcol0, keys
    kcol0 + 8 j + 2t + (e & 1); per 64-key chunk c of the tile it keeps one
    register of bits, in which per 16-key group kk it draws the calls
    (4 (kcol0 / 16 + 4 c + kk) + t, row + 8 r) and puts words x, y at bits
    8 kk + 2 r + (0, 1) and z, w at 8 kk + 4 + 2 r + (0, 1)."""
    n16, n_kt = -(-s_q // 16), -(-s_k // bk)
    bhq = torch.arange(bh)[:, None, None, None, None]
    row = (16 * torch.arange(n16)[:, None] + torch.arange(8))  # r16 + g
    row = row.reshape(-1)[None, :, None, None, None]
    t = torch.arange(4)[None, None, :, None, None]
    kt = torch.arange(n_kt)[None, None, None, :, None]
    keep = torch.zeros(bh, n16 * 16, n_kt * bk, dtype=torch.bool)
    for c in range(bk // 64):
        bits = torch.zeros(bh, row.shape[1], 4, n_kt, 1, dtype=torch.int64)
        for kk in range(4):
            for r in range(2):
                n = _nibbles(seed, (bk // 16 * kt + 4 * c + kk) * 4 + t,
                             row + 8 * r, bhq, rate)
                bits |= ((n & 3) | (n & 12) << 2) << (8 * kk + 2 * r)
        for j in range(8):
            for e in range(4):
                rows = (row + 8 * (e >> 1)).expand_as(bits)
                cols = (bk * kt + 64 * c + 8 * j + 2 * t + (e & 1)) \
                    .expand_as(bits)
                keep[torch.arange(bh)[:, None, None, None, None]
                     .expand_as(bits), rows, cols] = _bit(bits, 4 * j + e)
    plan = tfa.segment_tile_plan(None, s_q, s_k, bm, bk, causal)
    seen = (plan[0] != tfa.TILE_SKIP).repeat_interleave(bm, 0) \
        .repeat_interleave(bk, 1)[:s_q, :s_k]
    return keep[:, :s_q, :s_k], seen


def _wgmma_dkv_keep(seed, bh, s_q, s_k, rate, bq, causal):
    """keep [bh, s_q, s_k] as the wgmma dK/dV's lanes hold it, and the
    scores its tiles cover (64 keys per consumer, q tiles of ``bq``).  The
    fragment is transposed: a lane (g, t) of the warp whose 16 keys start
    at ``k16`` holds keys k16 + g and k16 + g + 8 and, per q tile at row0,
    q rows row0 + 8 j + 2t + (e & 1).  It draws the call (4 (k16 / 16) +
    g / 2, row0 + 8 j + 2t + (g & 1)) into nibble j of ``own``; the lane
    pair g, g ^ 1 swaps ``own`` in one shuffle; then element e of n-tile j
    is bit 4 j + e of ((a >> s) & 0x5..) | ((b >> s) & 0x5..) << 1, with a
    the nibbles of q row 2t, b of 2t + 1 and s = g & 1."""
    nq = bq // 8
    n16, n_qt = -(-s_k // 16), -(-s_q // bq)
    bhq = torch.arange(bh)[:, None, None, None, None]
    k16 = 16 * torch.arange(n16)[None, :, None, None, None]
    g = torch.arange(8)[None, None, :, None, None]
    t = torch.arange(4)[None, None, None, :, None]
    row0 = bq * torch.arange(n_qt)[None, None, None, None, :]
    odd = g & 1
    own = torch.zeros(bh, n16, 8, 4, n_qt, dtype=torch.int64)
    for j in range(nq):
        own |= _nibbles(seed, (k16 >> 4) * 4 + (g >> 1),
                        row0 + 2 * t + 8 * j + odd, bhq, rate) << (4 * j)
    other = own[:, :, torch.arange(8) ^ 1]                   # lane ^ 4
    a = torch.where(odd.bool(), other, own)
    b = torch.where(odd.bool(), own, other)
    m = 0x55555555
    bits = ((a >> odd) & m) | (((b >> odd) & m) << 1)
    keep = torch.zeros(bh, n_qt * bq, n16 * 16, dtype=torch.bool)
    for j in range(nq):
        for e in range(4):
            keys = (k16 + g + 8 * (e >> 1)).expand_as(bits)
            rows = (row0 + 8 * j + 2 * t + (e & 1)).expand_as(bits)
            keep[bhq.expand_as(bits), rows, keys] = _bit(bits, 4 * j + e)
    plan = tfa.segment_tile_plan(None, s_q, s_k, bq, 64, causal)
    seen = (plan[0] != tfa.TILE_SKIP).repeat_interleave(bq, 0) \
        .repeat_interleave(64, 1)[:s_q, :s_k]
    return keep[:, :s_q, :s_k], seen


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [40, 128, 256])
@pytest.mark.parametrize("s_q,s_k", [(200, 200), (136, 200)])
def test_wgmma_backward_keep_bits_are_dropout_keep(s_q, s_k, d, causal):
    """The keep bits of every lane of the wgmma dQ and dK/dV fragments
    (``_wgmma_dq_keep``, ``_wgmma_dkv_keep``: each body's tiles at head dim
    ``d``, ``tfa.segment_tiles``), reassembled into [rows, keys], equal
    ``dropout_keep`` on every score the tiles cover, and the tiles cover
    every visible score; lengths off the tile, causal and not."""
    rate, seed, bh = 0.1, (11 << 32) + 5, 2
    want = tfa.dropout_keep(seed, range(bh), range(s_q), range(s_k), rate)
    rows = torch.arange(s_q)[:, None]
    visible = rows + (s_k - s_q) >= torch.arange(s_k) if causal \
        else torch.ones(s_q, s_k, dtype=torch.bool)
    for which, model in (("bwd_dq", _wgmma_dq_keep),
                         ("bwd_dkv", _wgmma_dkv_keep)):
        bq, bk = tfa.segment_tiles(which, d)
        assert bk == 64
        keep, seen = model(seed, bh, s_q, s_k, rate, bq, causal)
        assert bool(seen[visible].all()), which
        seen = seen.expand_as(keep)
        assert torch.equal(keep[seen], want[seen]), which
        assert 0.85 < float(keep[seen].float().mean()) < 0.95


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("design", range(len(tfa.FWD_DESIGNS)))
@pytest.mark.parametrize("s_q,s_k", [(200, 200), (136, 200), (264, 264)])
def test_wgmma_forward_keep_bits_are_dropout_keep(s_q, s_k, design, causal):
    """The keep bits of every lane of the wgmma forward's fragment
    (``_wgmma_dq_keep`` at the design's q rows a block and keys a tile:
    64-key tiles in one register of bits, 128-key tiles in two), reassembled
    into [rows, keys], equal ``dropout_keep`` on every score the tiles
    cover, and the tiles cover every visible score; every design of
    ``tfa.FWD_DESIGNS`` (the segment branch's is design 0), lengths off the
    tile, causal and not."""
    rate, seed, bh = 0.1, (13 << 32) + 7, 2
    want = tfa.dropout_keep(seed, range(bh), range(s_q), range(s_k), rate)
    rows = torch.arange(s_q)[:, None]
    visible = rows + (s_k - s_q) >= torch.arange(s_k) if causal \
        else torch.ones(s_q, s_k, dtype=torch.bool)
    bq, bk, _ = tfa.FWD_DESIGNS[design]
    keep, seen = _wgmma_dq_keep(seed, bh, s_q, s_k, rate, bq, causal, bk)
    assert bool(seen[visible].all())
    seen = seen.expand_as(keep)
    assert torch.equal(keep[seen], want[seen])
    assert 0.85 < float(keep[seen].float().mean()) < 0.95


# (B, S_q, S_k, Hq, D, causal) of the forward's launches in 3c, 3d and
# 3h, S 200 (off the tile) causal and not at head dims 64 and 160, and
# 512 q tiles at head dims 192 and 256
FWD_TILE_LAUNCHES = [(8, 2048, 2048, 16, 64, True), (64, 512, 512, 12, 64,
                                                     False),
                     (8, 4096, 4096, 8, 40, False),
                     (8, 1024, 1024, 8, 80, False),
                     (8, 256, 256, 8, 160, False),
                     (2, 200, 200, 4, 64, True), (2, 200, 200, 4, 64, False),
                     (2, 200, 200, 4, 160, True),
                     (8, 1024, 1024, 8, 192, False),
                     (8, 1024, 1024, 8, 256, False)]
H100_SMS = 132


@pytest.mark.parametrize("launch", FWD_TILE_LAUNCHES,
                         ids=["3c", "3d", "3h-d40", "3h-d80", "3h-d160",
                              "S200-causal", "S200", "S200-d160-causal",
                              "d192", "d256"])
def test_forward_tiles_cover_every_q_tile_once_longest_first(launch):
    """The forward's tiles in every design (``tfa.FWD_DESIGNS``; the
    segment branch's, design 0, is ``segment_tiles("fwd", d)``) and the
    order its blocks take them at a launch (``tfa.fwd_tile_order``: a block
    per q tile, or a persistent grid of a block an SM walking them) cover
    every (batch x q-head row, q tile) exactly once, and the longest first:
    down the launch order and within each block the key tiles a q tile
    visits never grow."""
    b, s_q, s_k, hq, d, causal = launch
    assert tfa.FWD_DESIGNS[0][:2] == tfa.segment_tiles("fwd", d)
    for bq, bk, persistent in tfa.FWD_DESIGNS:
        n_qt = -(-s_q // bq)
        plan = tfa.segment_tile_plan(None, s_q, s_k, bq, bk, causal)[0]
        visits = (plan != tfa.TILE_SKIP).sum(1).tolist()
        for blocks in (None, H100_SMS) if persistent else (None,):
            order = tfa.fwd_tile_order(b * hq, s_q, bq, blocks)
            flat = [x for blk in order for x in blk]
            assert len(flat) == b * hq * n_qt
            assert set(flat) == {(r, qt) for r in range(b * hq)
                                 for qt in range(n_qt)}
            assert len(order) == (b * hq * n_qt if blocks is None
                                  else min(blocks, b * hq * n_qt))
            for blk in order:
                lens = [visits[qt] for _, qt in blk]
                assert lens == sorted(lens, reverse=True)
            launch_order = sorted(
                ((j + i * len(order), qt) for j, blk in enumerate(order)
                 for i, (_, qt) in enumerate(blk)), key=lambda x: x[0])
            lens = [visits[qt] for _, qt in launch_order]
            assert lens == sorted(lens, reverse=True)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_dropout_mask_read_out_of_each_plain_version(causal):
    """The read-out ``chip_smoke.py`` applies to the kernels on the card,
    applied to the plain versions: one-hot inputs beside rate 0 give back
    every keep bit of o, dq, dk and dv, equal to ``dropout_keep``'s, with
    GQA (each q head of a group read alone through dK/dV) and lengths off
    the chunk."""
    for dt in (torch.float32, torch.bfloat16):
        n, kept = chip_smoke.check_masks(tfa, (2, 72, 136, 4, 2, 32), dt,
                                         causal, (3 << 32) + 17, 0.1, "cpu")
        assert n == 2 * 4 * (72 * 136 if not causal else
                             sum(min(136, i + 65) for i in range(72)))
        assert abs(kept - 0.9) <= 5 * (0.09 / n) ** 0.5


@pytest.mark.cuda
def test_dropout_kernels_match_plain_versions_on_card():
    """The dropout branch of the three kernels at rate 0.1 against their
    plain versions under the same seed, f32 (1e-5) and bf16 (as
    ``chip_smoke.py`` holds it), causal GQA and a key length off the tile;
    then the masks of all three kernels themselves, read out through
    one-hot inputs (``chip_smoke.check_masks``), equal to ``dropout_keep``
    bit for bit, bf16 and f32, causal and not, with GQA and lengths off the
    64-row tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    rate, seed = 0.1, (3 << 32) + 17
    for dt in (torch.float32, torch.bfloat16):
        for shape, causal in (((2, 128, 128, 4, 2, 64), True),
                              ((1, 128, 200, 2, 2, 128), False)):
            q, k, v, do = (torch.from_numpy(x).cuda().to(dt)
                           for x in _inputs(shape, seed=12))
            scale = 1.0 / math.sqrt(shape[-1])
            args = (causal, scale, rate, seed)
            o, lse = tfa.flash_attention_fwd(q, k, v, *args)
            ro, rlse = tfa.flash_attention_fwd_ref(q, k, v, *args)
            delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1) \
                .reshape(lse.shape).contiguous()
            got = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, *args)
            got += (tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                               *args),)
            want = tfa.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                   *args)
            want += (tfa.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta,
                                                    *args),)
            torch.cuda.synchronize()
            torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
            if dt == torch.float32:
                for a, b_ in ((o, ro),) + tuple(zip(got, want)):
                    torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-5)
            else:
                _held_bf16(o, ro, 2.0 ** -8 * tfa.flash_attention_fwd_ref(
                    q, k, v.abs(), *args)[0].float())
                for a, b_ in zip(got, want):
                    _held_bf16(a, b_)
    for shape in ((2, 136, 200, 8, 2, 64), (1, 128, 200, 4, 4, 128)):
        for dt in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                chip_smoke.check_masks(tfa, shape, dt, causal, seed, rate)


# -- segment ids (the varlen mask) and the pad-to-tile path -------------------
@pytest.mark.parametrize("causal", [False, True])
def test_segment_forward_matches_pallas_interpret(causal):
    """The JAX suite's case (``test_pallas_kernels.py:214``): S 256, ids
    [0]*100 + [1]*156 (the boundary inside a tile), o and lse of the plain
    forward against ``flash_attention_fwd_kernel_call(segment_ids=...)``
    in interpret mode, and the op against the Pallas op, within 2e-5."""
    b, s, h, d = 2, 256, 2, 64
    q, k, v, _ = _inputs((b, s, s, h, h, d), seed=13)
    seg = _two_segments(b, s, 100)
    scale = 1.0 / math.sqrt(d)
    jo, jlse = jax.block_until_ready(jfa.flash_attention_fwd_kernel_call(
        _rows(q), _rows(k), _rows(v), causal, scale, interpret=True,
        n_q_heads=h, n_kv_heads=h,
        segment_ids=jnp.asarray(seg, jnp.float32)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    before = _counts()
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, causal, scale,
                                     segment_ids=torch.from_numpy(seg))
    out = tfa.flash_attention(tq, tk, tv, causal=causal,
                              segment_ids=torch.from_numpy(seg))
    assert _counts() == before
    np.testing.assert_allclose(o.numpy(), _bshd(jo, b), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD_TOL)
    want = jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                               causal=causal, interpret=True,
                               segment_ids=jnp.asarray(seg))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_segment_backward_matches_pallas_interpret(causal):
    """dq / dk / dv of the plain backward versions with segment ids
    ([0]*48 + [1]*80, the JAX suite's gradient case) against ``_bwd_call``
    with the same ids in interpret mode at S 128, GQA 4:2, within 2e-4."""
    b, s, hq, hkv, d = 1, 128, 4, 2, 64
    q, k, v, do = _inputs((b, s, s, hq, hkv, d), seed=14)
    seg = _two_segments(b, s, 48)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv = _rows(q), _rows(k), _rows(v)
    jseg = jnp.asarray(seg, jnp.float32)
    jo, jlse = jfa.flash_attention_fwd_kernel_call(
        jq, jk, jv, causal, scale, interpret=True, n_q_heads=hq,
        n_kv_heads=hkv, segment_ids=jseg)
    jdq, jdk, jdv = jax.block_until_ready(jfa._bwd_call(
        (jq, jk, jv, jo, jlse), _rows(do), causal, scale, True,
        n_q_heads=hq, n_kv_heads=hkv, segment_ids=jseg))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tseg = torch.from_numpy(seg)
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, causal, scale,
                                     segment_ids=tseg)
    before = _counts()
    dq, dk, dv = tfa._bwd_call((tq, tk, tv, o, lse), tdo, causal, scale,
                               segment_ids=tseg)
    assert _counts() == before
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), _bshd(want, b), **BWD_TOL)


@pytest.mark.parametrize("with_ids", [False, True])
def test_pad_to_tile_equals_jax(with_ids):
    """``_pad_to_tile`` bit for bit against JAX's: q, k, v padded with zero
    rows to the next 128, the ids (zeros when none) as f32 with the padding
    in segment -1, and the unpadded length."""
    b, s, h, d = 2, 453, 2, 64
    q, k, v, _ = _inputs((b, s, s, h, h, d), seed=15)
    ids = np.random.default_rng(16).integers(0, 3, (b, s)).astype(np.int32) \
        if with_ids else None
    want = jfa._pad_to_tile(*(jnp.asarray(x) for x in (q, k, v)),
                            None if ids is None else jnp.asarray(ids))
    got = tfa._pad_to_tile(*(torch.from_numpy(x) for x in (q, k, v)),
                           None if ids is None else torch.from_numpy(ids))
    assert got[4] == want[4] == s
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3].shape == (b, 512) and bool((got[3][:, s:] == -1).all())


@pytest.mark.parametrize("s", [390, 577])
def test_pad_to_tile_matches_jax_ref(s):
    """An untileable S >= 384 (390, and ViT-L/16's 577 at 384 px) takes the
    pad path through the plain versions: the output and the three
    gradients against ``jax.vjp`` of JAX's ``flash_attention_ref`` on the
    unpadded inputs, within 2e-5 and 2e-4."""
    b, h, d = 1, 2, 64
    q, k, v, do = _inputs((b, s, s, h, h, d), seed=17)
    jout, vjp = jax.vjp(lambda a, b_, c: jfa.flash_attention_ref(a, b_, c),
                        *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    before = _counts()
    out = tfa.flash_attention(tq, tk, tv)
    out.backward(torch.from_numpy(do))
    assert _counts() == before
    assert out.shape == (b, s, h, d)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    for t, want in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   **BWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_segments_with_dropout_match_jax_masked_formula(causal):
    """Segment ids and dropout together (rate 0.1): the op against
    ``jax.vjp`` of JAX's masked formula with the same segments, fed the
    port's mask through numpy; o within 2e-5, gradients within 1e-4 of the
    tensor's max |grad|."""
    rate, seed = 0.1, 99991
    shape = (2, 128, 128, 4, 2, 32)
    q, k, v, do = _inputs(shape, seed=18)
    seg = np.random.default_rng(19).integers(0, 3, (2, 128)).astype(np.int32)
    seg.sort(axis=1)
    factor = _factor(seed, shape, rate)
    jout, vjp = jax.vjp(
        lambda a, b_, c: _jax_masked_attention(a, b_, c, factor, causal,
                                               jnp.asarray(seg)),
        *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal,
                              segment_ids=torch.from_numpy(seg),
                              dropout_rate=rate, dropout_seed=seed)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    for t, want in zip((tq, tk, tv), jgrads):
        want = np.asarray(want)
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_segment_ids_need_equal_lengths():
    """As in JAX, segment ids with s_q != s_k give None from the op; the
    wrappers raise on ids of another shape."""
    q, k = torch.zeros((1, 128, 2, 64)), torch.zeros((1, 256, 2, 64))
    assert tfa.flash_attention(q, k, k, segment_ids=torch.zeros((1, 128))) \
        is None
    jq, jk = jnp.zeros((1, 128, 2, 64)), jnp.zeros((1, 256, 2, 64))
    assert jfa.flash_attention(jq, jk, jk, interpret=True,
                               segment_ids=jnp.zeros((1, 128))) is None


# (B, S, Hq, Hkv, D), causal, the segment lengths of each batch row
SEG_CARD_CASES = [((2, 256, 8, 8, 64), False, [100, 156]),
                  ((2, 256, 8, 2, 64), True, [100, 156]),
                  ((1, 320, 4, 4, 128), True, [64, 10, 118, 128]),
                  ((1, 512, 4, 4, 64), False, [5, 37, 300, 9, 161]),
                  ((2, 640, 4, 4, 64), False, [577, 63])]


@pytest.mark.cuda
def test_segment_kernels_match_plain_versions_on_card():
    """The segment branch of the forward and both backward kernels against
    their plain versions on the card, f32 (1e-5) and bf16 (as
    ``chip_smoke.py`` holds it), at rate 0 and 0.1: boundaries on and off
    the 64-row tile, a segment inside one tile, many short segments, GQA,
    causal and not, and the pad-to-tile shape (577 real rows of 640)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for (b, s, hq, hkv, d), causal, lens in SEG_CARD_CASES:
        seg = torch.repeat_interleave(
            torch.arange(len(lens)), torch.tensor(lens))[None] \
            .repeat(b, 1).cuda()
        for dt in (torch.float32, torch.bfloat16):
            for rate in (0.0, 0.1):
                q, k, v, do = (torch.from_numpy(x).cuda().to(dt) for x in
                               _inputs((b, s, s, hq, hkv, d), seed=20))
                args = (causal, 1.0 / math.sqrt(d), rate, 4321, seg)
                o, lse = tfa.flash_attention_fwd(q, k, v, *args)
                ro, rlse = tfa.flash_attention_fwd_ref(q, k, v, *args)
                delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1) \
                    .reshape(lse.shape).contiguous()
                got = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                  *args)
                got += (tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                   *args),)
                want = tfa.flash_attention_bwd_dkv_ref(q, k, v, do, lse,
                                                       delta, *args)
                want += (tfa.flash_attention_bwd_dq_ref(q, k, v, do, lse,
                                                        delta, *args),)
                torch.cuda.synchronize()
                torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
                if dt == torch.float32:
                    for a, b_ in ((o, ro),) + tuple(zip(got, want)):
                        torch.testing.assert_close(a, b_, rtol=1e-5,
                                                   atol=1e-5)
                else:
                    _held_bf16(o, ro, 2.0 ** -8 * tfa.flash_attention_fwd_ref(
                        q, k, v.abs(), *args)[0].float())
                    for a, b_ in zip(got, want):
                        _held_bf16(a, b_)


# -- every head dim the JAX kernels take --------------------------------------
# head dims off and on the kernels' compiled widths (24 at 32, 40 at 48, 80,
# 160, 200 at 256), S <= 256
