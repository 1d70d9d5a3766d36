"""ZeRO stages 0-3 of the port at world 2 (the counterpart of
``tests/test_zero_sharded.py``): one gang of two ranks on gloo
(``tests/torch_launch_scripts/zero_rank.py``) runs ``ShardedTrainStep``
at every stage, with and without buckets, on the JAX test's model and
data; each stage's losses and parameters after 3 steps are held against
JAX's ``ShardedTrainStep`` on a 2-device mesh (the tolerances of the JAX
test: rtol 1e-4, atol 1e-5), and the eager ``group_sharded_parallel``
levels and ``save_group_sharded_model`` against JAX's on the same mesh.
Where the JAX test reads the collective out of the compiled HLO, these
read the port's per-kind counters.  One test in one process holds
``remat`` against the step without it with ERNIE's dropout on."""
import contextlib
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from torch_gang import start_gang

STAGES = [(s, b) for s in (0, 1, 2, 3) for b in (False, True)]
LEVELS = ("os", "os_g", "p_g_os")
NAMES = ("b1", "b2", "w1", "w2")
TOL = dict(rtol=1e-4, atol=1e-5)
IDS = [f"stage{s}{'-bucket' if b else ''}" for s, b in STAGES]


@contextlib.contextmanager
def _plain_jax():
    """The JAX oracle runs its plain ops (no Pallas override another test
    of this worker registered)."""
    import paddle_tpu
    prev = paddle_tpu.get_flags(["use_pallas_kernels"])
    paddle_tpu.set_flags({"use_pallas_kernels": False})
    try:
        yield
    finally:
        paddle_tpu.set_flags(prev)


def _init_params(key):
    k1, k2 = jax.random.split(key)
    return {"w1": jax.random.normal(k1, (16, 32)) * 0.1,
            "b1": jnp.zeros((32,)),
            "w2": jax.random.normal(k2, (32, 1)) * 0.1,
            "b2": jnp.zeros((1,))}


def _loss_fn(p, batch):
    x, y = batch
    h = jnp.maximum(x @ p["w1"] + p["b1"], 0)
    return jnp.mean((h @ p["w2"] + p["b2"] - y) ** 2)


def _data():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(32, 16)).astype("float32"))
    y = jnp.asarray(rng.normal(size=(32, 1)).astype("float32"))
    return x, y


def _jax_step(stage, bucket=False, **kw):
    from paddle_tpu import optimizer
    from paddle_tpu.distributed.topology import build_mesh
    from paddle_tpu.parallel.sharded import ShardedTrainStep
    mesh = build_mesh({"dp": 2}, devices=jax.devices()[:2])
    return ShardedTrainStep(
        mesh, _loss_fn, _init_params(jax.random.PRNGKey(0)),
        optimizer.AdamW(learning_rate=1e-2, parameters=[]), stage=stage,
        axis="dp", bucket=bucket, **kw)


def _jax_mlp(init):
    """The rank script's ``MLP`` as a JAX ``Layer`` on ``init``'s weights
    (parameters in ``NAMES`` order)."""
    import paddle_tpu as paddle
    from paddle_tpu import nn
    from paddle_tpu.nn import functional as F

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            for k in NAMES:
                p = self.create_parameter(list(init[k].shape))
                p.set_value(np.asarray(init[k]))
                setattr(self, k, p)

        def forward(self, x, y):
            h = F.relu(x @ self.w1 + self.b1)
            return paddle.mean((h @ self.w2 + self.b2 - y) ** 2)
    return MLP()


def _jax_group_sharded(out_root, steps=3):
    """JAX's eager ``group_sharded_parallel`` at each level on a 2-device
    ``dp`` mesh (the accumulators, and at ``p_g_os`` the parameters,
    sharded over it), the whole batch a step: the parameters after
    ``steps`` steps, and what its ``save_group_sharded_model`` wrote (the
    optimizer state keyed by parameter name)."""
    import paddle_tpu as paddle
    from paddle_tpu import framework, optimizer
    from paddle_tpu.distributed import topology
    from paddle_tpu.distributed.sharding import (group_sharded_parallel,
                                                 save_group_sharded_model)
    init = _init_params(jax.random.PRNGKey(0))
    x, y = (paddle.to_tensor(np.asarray(a)) for a in _data())
    prev = topology._DEFAULT_MESH
    topology.set_default_mesh(topology.build_mesh(
        {"dp": 2}, devices=jax.devices()[:2]))
    out = {}
    try:
        for level in LEVELS:
            model = _jax_mlp(init)
            opt = optimizer.AdamW(learning_rate=1e-2,
                                  parameters=model.parameters())
            model, opt, _ = group_sharded_parallel(model, opt, level)
            for _ in range(steps):
                model(x, y).backward()
                opt.step()
                opt.clear_grad()
            d = os.path.join(out_root, f"jax_{level}")
            save_group_sharded_model(model, d, opt)
            pname = opt._param_names()
            by_name = {pname[id(getattr(model, k))]: k for k in NAMES}
            so = framework.load(os.path.join(d, "model.pdopt"),
                                return_numpy=True)
            sd = framework.load(os.path.join(d, "model.pdparams"),
                                return_numpy=True)
            out[level] = dict(
                params={k: np.asarray(getattr(model, k).numpy())
                        for k in NAMES},
                saved={k: np.asarray(sd[k]) for k in NAMES},
                opt={f"{by_name[n.split('.')[0]]}.{n.split('.')[1]}":
                     np.asarray(v) for n, v in so.items()
                     if n != "global_step"},
                global_step=so["global_step"])
    finally:
        topology._DEFAULT_MESH = prev
    return out


def _jax_oracle(out_root):
    """JAX's ShardedTrainStep on a 2-device mesh: each stage's losses,
    parameters after 3 steps and bytes per device; the clipped stage-2
    run's losses."""
    out = {}
    data = _data()
    with _plain_jax():
        for stage, bucket in STAGES:
            step = _jax_step(stage, bucket)
            losses = [float(step(data)) for _ in range(3)]
            out[(stage, bucket)] = dict(
                losses=losses, params={k: np.asarray(v) for k, v in
                                       step.materialized_params().items()},
                bytes=list(step.bytes_per_device()))
        clip = _jax_step(2, clip_norm=0.05)
        out["clip"] = [float(clip(data)) for _ in range(4)]
        out["eager"] = _jax_group_sharded(out_root)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gang's results and JAX's oracle, computed while the gang runs."""
    d = str(tmp_path_factory.mktemp("zero"))
    np.savez(os.path.join(d, "params.npz"),
             **{k: np.asarray(v) for k, v in
                _init_params(jax.random.PRNGKey(0)).items()})
    wait = start_gang("zero_rank.py", d)
    ref = _jax_oracle(d)
    return wait(), ref


@pytest.fixture(scope="module")
def gang(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_ref(runs):
    return runs[1]


@pytest.mark.parametrize("stage,bucket", STAGES, ids=IDS)
def test_stage_matches_jax_sharded_train_step(gang, jax_ref, stage, bucket):
    want = jax_ref[(stage, bucket)]
    for r in gang:
        got = r[f"s{stage}_b{int(bucket)}"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4,
                                   atol=1e-5)
        for k, v in want["params"].items():
            np.testing.assert_allclose(np.asarray(got["params"][k]), v,
                                       rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("stage,bucket", STAGES, ids=IDS)
def test_bytes_per_device_match_jax(gang, jax_ref, stage, bucket):
    for r in gang:
        assert r[f"s{stage}_b{int(bucket)}"]["bytes"] \
            == jax_ref[(stage, bucket)]["bytes"]


def test_stage3_param_bytes_shrink(gang):
    """Stage 3 holds half the parameters a rank of stage 2 holds; the
    optimizer state is sharded in both; each flat buffer's local slice is
    half its padded length."""
    for r in gang:
        p2, o2 = r["s2_b0"]["bytes"]
        p3, o3 = r["s3_b0"]["bytes"]
        assert p3 * 2 == p2 and o2 == o3
        assert r["s3_b1"]["names"] == ["b_float32"]
        assert sum(r["s3_b1"]["local"].values()) * 2 \
            == sum(r["s2_b1"]["local"].values())


def test_materialized_params_roundtrip(gang):
    for r in gang:
        assert r["s3_roundtrip"] == 0.0


@pytest.mark.parametrize("stage,bucket,want", [
    (0, False, {"all_reduce": 5}), (0, True, {"all_reduce": 2}),
    (1, False, {"all_reduce": 5, "all_gather": 4}),
    (1, True, {"all_reduce": 2, "all_gather": 1}),
    (2, False, {"reduce_scatter": 4, "all_reduce": 1, "all_gather": 4}),
    (2, True, {"reduce_scatter": 1, "all_reduce": 1, "all_gather": 1}),
    (3, False, {"all_gather": 4, "reduce_scatter": 4, "all_reduce": 1}),
    (3, True, {"all_gather": 1, "reduce_scatter": 1, "all_reduce": 1}),
], ids=IDS)
def test_collectives_per_step(gang, stage, bucket, want):
    """Per step: stage 0/1 all-reduce every gradient buffer (one a leaf,
    or one a bucket) and the loss; stages 2/3 reduce-scatter the
    gradients and all-reduce only the loss; stages 1/2 all-gather the
    updated slices, stage 3 the parameters for the forward."""
    got = {k: v for k, v in gang[0][f"s{stage}_b{int(bucket)}"]["counts"]
           .items()}
    assert got == {k: float(v) for k, v in want.items()}
    assert gang[1][f"s{stage}_b{int(bucket)}"]["counts"] == got


def test_clip_norm_matches_jax(gang, jax_ref):
    for r in gang:
        np.testing.assert_allclose(r["clip"], jax_ref["clip"], rtol=1e-4,
                                   atol=1e-5)


def test_bucketed_stage3_with_remat_trains(gang):
    """Stage 3 with buckets under remat: the loss falls, and the backward
    gathers the bucket again (2 all-gathers a step)."""
    for r in gang:
        losses = r["s3_bucket_remat"]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]
        assert r["s3_bucket_remat_counts"] == {
            "all_gather": 12, "reduce_scatter": 6, "all_reduce": 6}


@pytest.mark.parametrize("level,want", [
    ("os", {"all_reduce": 12, "all_gather": 12}),
    ("os_g", {"reduce_scatter": 12, "all_gather": 12}),
    ("p_g_os", {"all_gather": 12, "reduce_scatter": 12}),
])
def test_group_sharded_parallel_levels(gang, jax_ref, level, want):
    """The eager ZeRO levels on each rank's half of the batch end where
    JAX's ``group_sharded_parallel`` on a 2-device mesh ends (the whole
    batch, 3 steps), and where one process's AdamW of the port on the whole
    batch ends, with the collectives of their level (4 parameters, 3
    steps)."""
    want_params = jax_ref["eager"][level]["params"]
    for r in gang:
        got = r[f"eager_{level}"]
        for k in NAMES:
            np.testing.assert_allclose(np.asarray(got["params"][k]),
                                       want_params[k], err_msg=k, **TOL)
        assert got["gap"] < 1e-5
        assert got["counts"] == want


@pytest.mark.parametrize("level", LEVELS)
def test_save_group_sharded_model_writes_whole_state(gang, jax_ref, level):
    """``save_group_sharded_model``, called by every rank, writes the whole
    parameters (gathered first at ``p_g_os``, released again after) and the
    optimizer's state gathered from the slices: equal to what JAX's
    ``save_group_sharded_model`` writes after the same 3 steps (every
    state key of every parameter, and the step count), and to one
    process's AdamW of the port on the whole batch."""
    for r in gang:
        assert r[f"eager_{level}"]["released"] == (level == "p_g_os")
    saved = gang[0][f"eager_{level}"]["saved"]
    want = jax_ref["eager"][level]
    for k in NAMES:
        np.testing.assert_allclose(np.asarray(saved["params"][k]),
                                   want["saved"][k], err_msg=k, **TOL)
    assert sorted(saved["opt"]) == sorted(want["opt"])
    for k, v in want["opt"].items():
        np.testing.assert_allclose(np.asarray(saved["opt"][k]), v,
                                   err_msg=k, **TOL)
    assert saved["global_step"] == want["global_step"]
    assert saved["keys"] and saved["step"]
    assert saved["params_gap"] < 1e-5 and saved["moments_gap"] < 1e-6


@pytest.mark.parametrize("stage", [0, 3])
def test_remat_replays_the_modules_dropout(stage):
    """ERNIE at dropout 0.1 through ``ShardedTrainStep`` in one process:
    under ``remat`` the recompute draws the forward's masks from the
    model's own generators, so two steps give the losses and parameters of
    the steps without ``remat``, and the generators end where they do
    there (each advanced once a step)."""
    import torch
    from torch.func import functional_call
    from paddle_tpu_torch.models import ErnieConfig, ErnieForMaskedLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainStep
    cfg = ErnieConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=128,
                      max_position_embeddings=32, hidden_dropout_prob=0.1,
                      attention_probs_dropout_prob=0.1)
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, 256, (2, 32)))
    labels = torch.from_numpy(rng.integers(0, 256, (2, 32)))

    def run(remat):
        model = ErnieForMaskedLM(cfg, device="cpu", seed=0)

        def loss_fn(params, batch):
            return functional_call(model, params, (batch[0],),
                                   {"labels": batch[1]})[0]
        step = ShardedTrainStep(None, loss_fn, model,
                                AdamW(learning_rate=1e-2), stage=stage,
                                remat=remat, device="cpu")
        losses = [float(step((ids, labels))) for _ in range(2)]
        gens = (model.ernie.dropout_generator,
                model.ernie.attention_seed_generator)
        return (losses, step.materialized_params(),
                [g.get_state() for g in gens])

    want_l, want_p, want_g = run(False)
    got_l, got_p, got_g = run(True)
    assert got_l == want_l
    for k, v in want_p.items():
        np.testing.assert_allclose(got_p[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))


def test_level_name_mapping():
    from paddle_tpu.parallel.sharded import zero_stage_name as jname
    from paddle_tpu_torch.parallel import zero_stage_name
    for level in ("os", "os_g", "p_g_os", "stage1", "stage2", "stage3",
                  "none", 0, 1, 2, 3, "0", "3"):
        assert zero_stage_name(level) == jname(level)
    with pytest.raises(ValueError):
        zero_stage_name("p_os")
