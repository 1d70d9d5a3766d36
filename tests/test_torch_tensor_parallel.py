"""Tensor parallelism of the port at dp 2 x mp 2 (the counterpart of
``tests/test_launch_multiprocess.py:207`` and ``tests/test_parallel.py:105,
132``): one gang of four ranks on gloo
(``tests/torch_launch_scripts/tp_rank.py``) under ``fleet.init``'s hybrid
groups trains ``hybrid4_rank.py``'s model (held against the same analytic
reference as the JAX test), runs each tensor-parallel layer against its
dense counterpart under ``jax.vjp``, runs ``llama_config_tiny`` with
``mp_axis="mp"`` on JAX's weights against JAX's dense
``build_functional_llama`` and JAX's ``shard_map`` tensor parallelism over
2 devices (loss within 1e-5, gradients within 1e-4 of each tensor's max
|grad|), and steps the hybrid optimizer's global-norm clip."""
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from torch_gang import SCRIPTS, start_gang

sys.path.insert(0, SCRIPTS)
from layer_inputs import inputs  # noqa: E402

sys.path.remove(SCRIPTS)

LAYERS = 2


def _cfg():
    from paddle_tpu.models.llama import llama_config_tiny
    return llama_config_tiny(vocab=64, hidden=32, layers=LAYERS, heads=4,
                             seq=16)


def _llama_loss(ea, ba, hl, mp=None):
    def loss(ep, bp, hp, ids, labels):
        x = ea(ep, (ids, labels))[0]
        if mp:
            x = jax.lax.pcast(x, (mp,), to="varying")
        y, _ = jax.lax.scan(lambda c, lp: (ba(lp, c), None), x, bp)
        out = hl(hp, y[None], (ids, labels))
        return jax.lax.pmean(out, mp) if mp else out
    return loss


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's weights and batch, written for the gang; then, while the gang
    runs, JAX's dense loss and gradients and the same through
    ``shard_map`` over mp = 2."""
    import paddle_tpu
    from paddle_tpu.distributed.topology import build_mesh
    from paddle_tpu.models.llama import (build_functional_llama,
                                         llama_block_specs)
    prev = paddle_tpu.get_flags(["use_pallas_kernels"])
    paddle_tpu.set_flags({"use_pallas_kernels": False})
    try:
        cfg = _cfg()
        ep, bp, hp, ea, ba, hl = build_functional_llama(
            cfg, key=jax.random.PRNGKey(0))
        rng = np.random.default_rng(5)
        ids = rng.integers(0, 64, (2, 16)).astype(np.int32)
        labels = rng.integers(0, 64, (2, 16)).astype(np.int32)
        d = str(tmp_path_factory.mktemp("tp"))
        np.savez(os.path.join(d, "llama.npz"), ids=ids, labels=labels,
                 **{f"{p}.{k}": np.asarray(v)
                    for p, tree in (("ep", ep), ("bp", bp), ("hp", hp))
                    for k, v in tree.items()})
        wait = start_gang("tp_rank.py", d, nproc=4)
        vg = jax.jit(jax.value_and_grad(_llama_loss(ea, ba, hl),
                                        argnums=(0, 1, 2)))
        dense = vg(ep, bp, hp, ids, labels)
        _, _, _, ea2, ba2, hl2 = build_functional_llama(
            cfg, init_params=False, mp_axis="mp")
        bspec = {k: P(None, *v) for k, v in llama_block_specs("mp").items()}
        mesh = build_mesh({"mp": 2}, devices=jax.devices()[:2])
        tp = jax.jit(jax.shard_map(
            jax.value_and_grad(_llama_loss(ea2, ba2, hl2, "mp"),
                               argnums=(0, 1, 2)),
            mesh=mesh, in_specs=(P(), bspec, P(), P(), P()),
            out_specs=(P(), (P(), bspec, P()))))(ep, bp, hp, ids, labels)
    finally:
        paddle_tpu.set_flags(prev)
    as_np = lambda r: (float(r[0]), [{k: np.asarray(v) for k, v in t.items()}  # noqa: E731,E501
                                     for t in r[1]])
    return wait(), as_np(dense), as_np(tp)


@pytest.fixture(scope="module")
def gang(runs):
    return runs[0]


@pytest.fixture(scope="module")
def llama_ref(runs):
    return runs


def test_hybrid_grid_and_groups(gang):
    """Rank r sits at (dp, mp) = divmod(r, 2); its groups carry their axis
    names."""
    for r, res in enumerate(gang):
        dp_r, mp_r = divmod(r, 2)
        assert res["coords"] == [dp_r, mp_r]
        assert res["mp_ranks"] == [2 * dp_r, 2 * dp_r + 1]
        assert res["dp_ranks"] == [mp_r, mp_r + 2]
        assert res["axis"] == "mp"


def test_dp2_mp2_matches_analytic_reference(gang):
    rng = np.random.default_rng(7)
    X = rng.normal(0, 1, (8, 4)).astype(np.float32)
    Y = (X @ np.arange(1, 5).astype(np.float32)[:, None] * 0.1)
    W1 = rng.normal(0, 0.3, (4, 8)).astype(np.float32)
    W2 = rng.normal(0, 0.3, (8, 1)).astype(np.float32)
    ref = []
    for _ in range(8):
        H = np.tanh(X @ W1)
        diff = H @ W2 - Y
        ref.append(float(np.mean(diff ** 2)))
        g_out = 2 * diff / len(X)
        gW2 = H.T @ g_out
        gH = g_out @ W2.T * (1 - H ** 2)
        W1 -= 0.1 * (X.T @ gH)
        W2 -= 0.1 * gW2
    for res in gang:
        np.testing.assert_allclose(res["hybrid4"], ref, rtol=2e-4, atol=1e-5)


def _vjp(f, args, dy):
    y, back = jax.vjp(f, *[jnp.asarray(a) for a in args])
    return np.asarray(y), [np.asarray(g) for g in back(jnp.asarray(dy))]


def _cols(a, r, n=2):
    w = a.shape[-1] // n
    return a[..., r * w:(r + 1) * w]


def _rows(a, r, n=2):
    w = a.shape[0] // n
    return a[r * w:(r + 1) * w]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("gather", [True, False], ids=["gather", "split"])
def test_column_parallel_linear_matches_dense(gang, gather):
    v = inputs()
    y, (dx, dw, db) = _vjp(lambda x, w, b: x @ w + b,
                           (v["x8"], v["wc"], v["bc"]), v["dy6"])
    for r, res in enumerate(gang):
        got = res["layers"][f"column_gather{int(gather)}"]
        mp_r = r % 2
        _close(got["y"], y)
        _close(got["dx"], dx)
        _close(got["dw"], _cols(dw, mp_r))
        _close(got["db"], _cols(db, mp_r))


@pytest.mark.parametrize("parallel", [False, True], ids=["scatter", "input"])
def test_row_parallel_linear_matches_dense(gang, parallel):
    v = inputs()
    y, (dx, dw, db) = _vjp(lambda x, w, b: x @ w + b,
                           (v["x6"], v["wr"], v["br"]), v["dy4"])
    for r, res in enumerate(gang):
        got = res["layers"][f"row_parallel{int(parallel)}"]
        mp_r = r % 2
        _close(got["y"], y)
        _close(got["dx"], _cols(dx, mp_r) if parallel else dx)
        _close(got["dw"], _rows(dw, mp_r))
        _close(got["db"], db)


def test_vocab_parallel_embedding_matches_dense(gang):
    v = inputs()
    y, (dw,) = _vjp(lambda w: w[v["ids"]], (v["emb"],), v["dye"])
    for r, res in enumerate(gang):
        got = res["layers"]["vocab_embedding"]
        _close(got["y"], y)
        _close(got["dw"], _rows(dw, r % 2))


def test_parallel_cross_entropy_matches_dense(gang):
    v = inputs()
    lab = v["labels"]
    keep = lab != -100

    def ce(logits):
        lp = jax.nn.log_softmax(logits, -1)
        nll = -jnp.take_along_axis(lp, jnp.where(keep, lab, 0)[:, None], -1)
        return jnp.where(keep[:, None], nll, 0.0)
    y, (dl,) = _vjp(ce, (v["logits"],), np.ones((4, 1), np.float32))
    for r, res in enumerate(gang):
        got = res["layers"]["cross_entropy"]
        _close(got["loss"], y)
        _close(got["dlogits"], _cols(dl, r % 2))


def _llama_block_slice(name, g, r):
    from paddle_tpu.models.llama import llama_block_specs
    spec = llama_block_specs("mp")[name]
    if spec == (None, "mp"):
        return _cols(g, r)
    if spec == ("mp", None):
        w = g.shape[1] // 2
        return g[:, r * w:(r + 1) * w]
    return g


@pytest.mark.parametrize("oracle", ["dense", "shard_map"])
def test_llama_mp2_matches_jax(gang, llama_ref, oracle):
    loss, grads = llama_ref[1] if oracle == "dense" else llama_ref[2]
    for r, res in enumerate(gang):
        got = res["llama"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5, atol=1e-5)
        for p, tree in zip(("ep", "bp", "hp"), grads):
            for k, g in tree.items():
                want = _llama_block_slice(k, g, r % 2) if p == "bp" else g
                np.testing.assert_allclose(
                    np.asarray(got["grads"][f"{p}.{k}"]), want, rtol=0,
                    atol=1e-4 * np.abs(want).max(), err_msg=f"{p}.{k}")


def test_llama_mp2_issues_the_megatron_collectives(gang):
    """Two all-reduces a block forward (after wo and wdown) and two in the
    backward (the column-parallel inputs' gradients); the sharded block
    weights are marked ``is_distributed``."""
    for res in gang:
        assert res["llama"]["counts"] == {"all_reduce": 4 * LAYERS}
        assert res["llama"]["distributed"] == sorted(
            ["wq", "wk", "wv", "wo", "wgate", "wup", "wdown"])


def test_hybrid_clip_takes_the_dense_global_norm(gang):
    v = inputs()
    h = v["x8"] @ v["wc"] + v["bc"]
    dy = v["dy4"]
    g_wr, g_br = h.T @ dy, dy.sum(0)
    dh = dy @ v["wr"].T
    g_wc, g_bc = v["x8"].T @ dh, dh.sum(0)
    dense = [g_wc, g_bc, g_wr, g_br]
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in dense))
    scale = 0.1 / max(norm, 0.1)
    for r, res in enumerate(gang):
        got = res["hybrid_clip"]
        assert got["clip"] == "_HybridClip"
        mp_r = r % 2
        want = [_cols(g_wc, mp_r), _cols(g_bc, mp_r), _rows(g_wr, mp_r),
                g_br]
        for s, w in zip(got["steps"], want):
            np.testing.assert_allclose(np.asarray(s), w * scale, rtol=1e-5,
                                       atol=1e-6)


def test_mp_axis_absent_from_the_mesh_runs_each_rank_alone(gang,
                                                            llama_ref):
    """On the default ``{"dp": 4}`` mesh, which has no ``mp`` axis, the
    LLaMA built with ``mp_axis="mp"`` runs each rank alone, on its own
    batch: it issues no collective, its loss and gradients equal the dense
    model's on that batch (rank 0's batch is JAX's, so its loss is JAX's
    dense loss), and the ranks' losses differ; ``ShardedTrainStep`` over
    the absent ``sharding`` axis raises."""
    losses = []
    for res in gang:
        got = res["lone_axis"]
        assert got["axes"] == ["dp"]
        assert got["counts"] == {}
        assert got["loss"] == got["dense_loss"] and got["gap"] == 0.0
        assert "sharding" in got["raised"]
        losses.append(got["loss"])
    np.testing.assert_allclose(losses[0], llama_ref[1][0], rtol=1e-5,
                               atol=1e-5)
    assert len(set(losses)) == len(losses)
