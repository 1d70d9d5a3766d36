"""The tile plan of the segment kernels (``segment_tile_plan``), on the CPU.

The bf16 segment forward, dK/dV and dQ kernels classify every (q tile, key
tile) pair before they load it: skipped (no pair shares an id, or the tile
lies past the causal frontier), full (one id throughout, nothing past the
frontier or the keys) or masked.  The plan is that rule in PyTorch.  Here
it is held against the dense mask ``seg[:, :, None] == seg[:, None, :]`` on
drawn ids — sorted varlen boundaries on and off the tiles, the
``_pad_to_tile`` tail of -1, ids out of order, an id that recurs in two
spans, S off the tile, causal or not: no skipped tile holds a kept pair,
and no full tile a masked one.  Then plain attention restricted to the
plan's non-skipped tiles (the skipped tiles' pairs forced to NEG_INF) —
the forward, dK/dV and dQ — against JAX's segment kernels in interpret
mode, f32, within 2e-5: skipping changes no value."""
import importlib
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from paddle_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

TOL = dict(rtol=2e-5, atol=2e-5)
# (q tile, key tile): the forward's and dQ's (128 q rows, 64 keys; dQ's 64
# rows above W 128), and dK/dV's (64 keys against q tiles of 64 rows at
# W <= 64, of 32 above)
TILES = [(128, 64), (64, 64), (32, 64)]


def _kept(seg, s_q, s_k, causal):
    """bool [B, s_q, s_k]: the pairs attention keeps."""
    seg = torch.as_tensor(seg, dtype=torch.float32)
    keep = seg[:, :s_q, None] == seg[:, None, :s_k]
    if causal:
        keep &= (torch.arange(s_q)[:, None] + (s_k - s_q)
                 >= torch.arange(s_k)[None, :])
    return keep


def _check_sound(seg, s, causal, bq, bk):
    """No skipped tile holds a kept pair; no full tile a masked one (every
    pair of a full tile lies inside S and is kept)."""
    plan = tfa.segment_tile_plan(torch.as_tensor(seg), s, s, bq, bk, causal)
    keep = _kept(seg, s, s, causal)
    b, n_qt, n_kt = plan.shape
    assert (n_qt, n_kt) == (-(-s // bq), -(-s // bk))
    for i in range(n_qt):
        for j in range(n_kt):
            tile = keep[:, i * bq:(i + 1) * bq, j * bk:(j + 1) * bk]
            cls = plan[:, i, j]
            skip = cls == tfa.TILE_SKIP
            assert not bool(tile.flatten(1).any(1)[skip].any()), (i, j)
            full = cls == tfa.TILE_FULL
            if bool(full.any()):
                assert (j + 1) * bk <= s
                assert bool(tile[full].all()), (i, j)
    return plan


@st.composite
def _varlen(draw, pad_tail=False):
    """Sorted segment ids of drawn lengths (boundaries on and off the
    tiles), as ``segment_ids`` makes them; with ``pad_tail`` S rows padded
    to the next 128 with -1, as ``_pad_to_tile`` does."""
    lens = draw(st.lists(st.one_of(st.sampled_from([32, 64, 128]),
                                   st.integers(1, 150)),
                         min_size=1, max_size=8))
    ids = np.repeat(np.arange(len(lens)), lens)
    if pad_tail:
        ids = np.concatenate([ids, np.full((-len(ids)) % 128, -1)])
    return ids


@st.composite
def _spans(draw):
    """Spans of drawn ids out of order, an id free to recur in two spans."""
    n = draw(st.integers(1, 8))
    ids = draw(st.lists(st.integers(0, 3), min_size=n, max_size=n))
    lens = draw(st.lists(st.one_of(st.just(64), st.integers(1, 120)),
                         min_size=n, max_size=n))
    return np.repeat(np.asarray(ids), lens)


def _rows(ids, b, seed):
    """[B, S] f32 ids: the drawn row, and its rotations."""
    shifts = np.random.default_rng(seed).integers(0, len(ids), b)
    return np.stack([np.roll(ids, int(k)) if r else ids
                     for r, k in enumerate(shifts)]).astype(np.float32)


@pytest.mark.parametrize("bq,bk", TILES)
@pytest.mark.parametrize("causal", [False, True])
@settings(max_examples=40, deadline=None)
@given(ids=_varlen())
def test_plan_sound_on_sorted_varlen_ids(ids, causal, bq, bk):
    _check_sound(ids[None].astype(np.float32), len(ids), causal, bq, bk)


@pytest.mark.parametrize("causal", [False, True])
@settings(max_examples=30, deadline=None)
@given(ids=_varlen(pad_tail=True))
def test_plan_sound_on_the_pad_to_tile_tail(ids, causal):
    plan = _check_sound(ids[None].astype(np.float32), len(ids), causal, 64,
                        64)
    # a tile of padding rows shares no id with a tile of real keys
    real = int((ids >= 0).sum())
    for i in range(-(-real // 64), plan.shape[1]):
        for j in range(real // 64):
            assert int(plan[0, i, j]) == tfa.TILE_SKIP


@pytest.mark.parametrize("bq,bk", TILES)
@pytest.mark.parametrize("causal", [False, True])
@settings(max_examples=40, deadline=None)
@given(ids=_spans(), seed=st.integers(0, 2 ** 16))
def test_plan_sound_on_unsorted_and_recurring_ids(ids, seed, causal, bq,
                                                   bk):
    _check_sound(_rows(ids, 3, seed), len(ids), causal, bq, bk)


@pytest.mark.parametrize("s", [100, 200, 333])
def test_plan_without_segments_and_off_the_tile(s):
    """Without ids only the causal frontier and the end of the keys count:
    non-causal, every tile is full but a partial last key tile; causal,
    the tiles past the frontier are skipped and the diagonal ones
    masked."""
    plan = tfa.segment_tile_plan(None, s, s, 64, 64, False)
    n = -(-s // 64)
    want = torch.full((1, n, n), tfa.TILE_FULL)
    if s % 64:
        want[:, :, -1] = tfa.TILE_MASKED
    assert torch.equal(plan, want)
    plan = tfa.segment_tile_plan(None, s, s, 64, 64, True)
    i, j = torch.meshgrid(torch.arange(n), torch.arange(n), indexing="ij")
    assert torch.equal(plan[0] == tfa.TILE_SKIP, j > i)
    assert torch.equal(plan[0] == tfa.TILE_MASKED, (j == i) | ((j < i)
                                                              & (j == n - 1)
                                                              & (s % 64 > 0)))


def test_plan_counts_at_vit_and_varlen_shapes():
    """The counts phase 5d prints: ViT-L/16's 577 rows padded to 640 give 81
    full and 19 masked 64 x 64 tiles (dK/dV's), 36 full and 14 masked
    128 x 64 tiles (the forward's, and dQ's at D 64; dQ takes 64 x 64
    above W 128); a packed row of segments of 5..300 skips most tiles,
    at dK/dV's tiles and at dQ's."""
    ids = torch.tensor([[0.0] * 577 + [-1.0] * 63])
    for bq, want in ((64, [0, 81, 19]), (128, [0, 36, 14])):
        plan = tfa.segment_tile_plan(ids, 640, 640, bq, 64, False)
        counts = [int((plan == c).sum()) for c in
                  (tfa.TILE_SKIP, tfa.TILE_FULL, tfa.TILE_MASKED)]
        assert counts == want
    for d, want in ((64, [0, 36, 14]), (160, [0, 81, 19])):
        plan = tfa.segment_tile_plan(ids, 640, 640,
                                     *tfa.segment_tiles("bwd_dq", d), False)
        assert [int((plan == c).sum()) for c in
                (tfa.TILE_SKIP, tfa.TILE_FULL, tfa.TILE_MASKED)] == want
    rng = np.random.default_rng(3)
    lens = []
    while sum(lens) < 4096:
        lens.append(int(rng.integers(5, 301)))
    lens[-1] -= sum(lens) - 4096
    ids = torch.from_numpy(np.repeat(np.arange(len(lens)), lens)[None])
    plan = _check_sound(ids.float().numpy(), 4096, False, 64, 64)
    assert int((plan == tfa.TILE_SKIP).sum()) > 0.8 * plan.numel()
    plan = _check_sound(ids.float().numpy(), 4096, False,
                        *tfa.segment_tiles("bwd_dq", 64))
    assert int((plan == tfa.TILE_SKIP).sum()) > 0.8 * plan.numel()


@pytest.mark.parametrize("d", [24, 40, 64, 72, 128, 160, 200, 256])
def test_segment_tiles_of_each_body(d):
    """Each body's (q rows, keys) per classed pair, from the head width:
    the forward 128 x 64; dK/dV 64 x 64 up to W 64, then 32 x 64; dQ
    128 x 64 up to two 64-column panels (W 128), then 64 x 64."""
    w = tfa.head_width(d)
    assert tfa.segment_tiles("fwd", d) == (128, 64)
    assert tfa.segment_tiles("bwd_dkv", d) == ((64 if w <= 64 else 32), 64)
    assert tfa.segment_tiles("bwd_dq", d) == ((128 if w <= 128 else 64), 64)
    for tiles in (tfa.segment_tiles(x, d) for x in ("fwd", "bwd_dkv",
                                                     "bwd_dq")):
        assert tiles in TILES
    with pytest.raises(ValueError):
        tfa.segment_tiles("bwd", d)
    with pytest.raises(ValueError):
        tfa.segment_tiles("fwd", d + 4)


# -- skipping changes no value: plain attention over the non-skipped tiles
# against JAX's segment kernels in interpret mode ---------------------------
def _inputs(shape, seed):
    b, s, hq, hkv, d = shape
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal(sz).astype(np.float32) for sz in
                 ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d)))


def _jrows(x):
    b, s, h, d = x.shape
    return jnp.array(x.transpose(0, 2, 1, 3).reshape(b * h, s, d), copy=True)


def _bshd(x, b):
    x = np.asarray(x)
    bh, s, d = x.shape
    return x.reshape(b, bh // b, s, d).transpose(0, 2, 1, 3)


def _skipped_pairs(seg, s, causal, bq, bk):
    """bool [B, S, S]: the pairs inside the plan's skipped tiles."""
    plan = tfa.segment_tile_plan(seg, s, s, bq, bk, causal)
    skip = (plan == tfa.TILE_SKIP).repeat_interleave(bq, 1) \
        .repeat_interleave(bk, 2)
    return skip[:, :s, :s]


@pytest.fixture
def _restricted(monkeypatch):
    """Makes the plain versions' scores NEG_INF on the pairs of the plan's
    skipped tiles (``tiles`` = (bq, bk)), as if those tiles were never
    computed, whatever the segment mask already says."""
    tiles = {}
    scores = tfa._scores

    def restricted(q, k, causal, sm_scale, segment_ids=None):
        s = scores(q, k, causal, sm_scale, segment_ids)
        skip = _skipped_pairs(segment_ids, q.shape[1], causal, *tiles["bq_bk"])
        skip = skip.repeat_interleave(q.shape[2], dim=0)
        assert bool(skip.any()), "the case skips no tile"
        return torch.where(skip, torch.full_like(s, tfa.NEG_INF), s)

    monkeypatch.setattr(tfa, "_scores", restricted)
    return tiles


@pytest.fixture(autouse=True)
def _pinned_numerics():
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        torch.set_float32_matmul_precision(prec)


# ids out of order, id 3 recurring 192 rows apart, on and off the 64-row
# tiles: tiles of different ids are skipped, the recurring id's are not
SEG_ROW = np.repeat([3, 1, 0, 3, 2, 1], [64, 40, 88, 64, 56, 72])


@pytest.mark.parametrize("bq,bk", TILES)
@pytest.mark.parametrize("causal", [False, True])
def test_skipped_tiles_change_no_value(_restricted, causal, bq, bk):
    """o and lse of the restricted plain forward, dk / dv of the restricted
    plain dK/dV backward and dq of the restricted plain dQ backward,
    against JAX's segment forward kernel and ``_bwd_call`` in interpret
    mode (f32, S 384, GQA 4:2), within 2e-5."""
    b, s, hq, hkv, d = 2, 384, 4, 2, 32
    q, k, v, do = _inputs((b, s, hq, hkv, d), seed=41)
    seg = np.stack([SEG_ROW, np.roll(SEG_ROW, 64)]).astype(np.float32)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv = _jrows(q), _jrows(k), _jrows(v)
    jseg = jnp.asarray(seg)
    jo, jlse = jfa.flash_attention_fwd_kernel_call(
        jq, jk, jv, causal, scale, interpret=True, n_q_heads=hq,
        n_kv_heads=hkv, segment_ids=jseg)
    jdq, jdk, jdv = jax.block_until_ready(jfa._bwd_call(
        (jq, jk, jv, jo, jlse), _jrows(do), causal, scale, True,
        n_q_heads=hq, n_kv_heads=hkv, segment_ids=jseg))
    _restricted["bq_bk"] = (bq, bk)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tseg = torch.from_numpy(seg)
    o, lse = tfa.flash_attention_fwd_ref(tq, tk, tv, causal, scale,
                                         segment_ids=tseg)
    np.testing.assert_allclose(o.numpy(), _bshd(jo, b), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)
    delta = (tdo * o).sum(-1).permute(0, 2, 1).reshape(b * hq, s)
    dk, dv = tfa.flash_attention_bwd_dkv_ref(tq, tk, tv, tdo, lse, delta,
                                             causal, scale,
                                             segment_ids=tseg)
    np.testing.assert_allclose(dk.numpy(), _bshd(jdk, b), **TOL)
    np.testing.assert_allclose(dv.numpy(), _bshd(jdv, b), **TOL)
    dq = tfa.flash_attention_bwd_dq_ref(tq, tk, tv, tdo, lse, delta, causal,
                                        scale, segment_ids=tseg)
    np.testing.assert_allclose(dq.numpy(), _bshd(jdq, b), **TOL)


# (S, causal, head dim): the UNet's three self-attention shapes (phase 3h,
# non-causal) and the LLaMA step's causal one (phase 3c), which the wgmma
# dK/dV and dQ take without segments
NO_SEGMENT_SHAPES = [(4096, False, 40), (1024, False, 80), (256, False, 160),
                     (2048, True, 64)]
# the (query, key) pairs each body executes at 3c's shape, per head: every
# pair of a tile that is not skipped (dK/dV's 64 x 64 tiles: 528 of 1,024;
# dQ's 128 x 64: 272 of 512)
EXECUTED_3C = {"bwd_dkv": 528 * 64 * 64, "bwd_dq": 272 * 128 * 64}


@pytest.mark.parametrize("which", ["bwd_dkv", "bwd_dq"])
@pytest.mark.parametrize("s,causal,d", NO_SEGMENT_SHAPES,
                         ids=[f"S{s}-{'causal' if c else 'full'}-d{d}"
                              for s, c, d in NO_SEGMENT_SHAPES])
def test_plan_without_segments_against_the_mask(s, causal, d, which):
    """The plan of the wgmma dK/dV and dQ launches without segments, at
    each body's tiles (``segment_tiles``), against a brute count of the
    pairs ``_mask`` keeps per tile: no kept pair lies in a skipped tile, and
    no masked pair in a full one; the executed pairs (those of every tile
    not skipped) hold every kept pair, are all S^2 pairs without the causal
    mask and ``EXECUTED_3C`` with it."""
    bq, bk = tfa.segment_tiles(which, d)
    plan = tfa.segment_tile_plan(None, s, s, bq, bk, causal)[0]
    keep = tfa._mask(s, s, "cpu") if causal \
        else torch.ones(s, s, dtype=torch.bool)
    n_qt, n_kt = -(-s // bq), -(-s // bk)
    assert plan.shape == (n_qt, n_kt)
    padded = torch.zeros(n_qt * bq, n_kt * bk, dtype=torch.bool)
    padded[:s, :s] = keep
    kept = padded.reshape(n_qt, bq, n_kt, bk).sum((1, 3))
    assert int(kept[plan == tfa.TILE_SKIP].sum()) == 0
    assert bool((kept[plan == tfa.TILE_FULL] == bq * bk).all())
    executed = int((plan != tfa.TILE_SKIP).sum()) * bq * bk
    assert int(kept[plan != tfa.TILE_SKIP].sum()) == int(keep.sum())
    if causal:
        assert int(keep.sum()) == s * (s + 1) // 2
        assert executed == EXECUTED_3C[which]
    else:
        assert executed == s * s
        assert bool((plan == tfa.TILE_FULL).all())
