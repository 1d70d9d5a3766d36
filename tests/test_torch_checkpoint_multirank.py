"""The distributed checkpoint at world 2 across both packages: one gang of
two ranks on gloo (``tests/torch_launch_scripts/ckpt_rank.py``) saves its
ZeRO-3 and bucketed ZeRO-2 slices into one directory each, which JAX's
``load_state_dict`` reads back to JAX's own ``ShardedTrainStep`` state,
and loads the directory JAX's 2-device step wrote; a replicated extent is
written once, by the coordinator."""
import json
import os
import pickle

import numpy as np
import pytest

import jax

from test_torch_zero_sharded import _data, _init_params, _jax_step, _plain_jax
from torch_gang import start_gang


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The gang, and while it runs JAX's stage-3 step on a 2-device mesh
    after 3 steps (its state saved as ``jax_s3``, which the ranks wait
    for) and its fourth loss."""
    from paddle_tpu.distributed.checkpoint.save_state_dict import \
        save_state_dict
    d = str(tmp_path_factory.mktemp("ckpt"))
    np.savez(os.path.join(d, "params.npz"),
             **{k: np.asarray(v) for k, v in
                _init_params(jax.random.PRNGKey(0)).items()})
    wait = start_gang("ckpt_rank.py", d)
    data = _data()
    with _plain_jax():
        step = _jax_step(3)
        for _ in range(3):
            step(data)
        state = {"params": {k: np.asarray(v)
                            for k, v in step.flat_params.items()},
                 "opt": {k: {m: np.asarray(t) for m, t in st.items()}
                         for k, st in step.opt_state.items()}}
        save_state_dict({"params": step.flat_params, "opt": step.opt_state},
                        os.path.join(d, "jax_s3"))
        fourth = float(step(data))
    return d, state, fourth, wait()


def _jax_targets(state):
    import jax.numpy as jnp
    from paddle_tpu.core.tensor import Tensor
    return {"params": {k: Tensor(jnp.zeros(v.shape, v.dtype))
                       for k, v in state["params"].items()},
            "opt": {k: {m: Tensor(jnp.zeros(t.shape, t.dtype))
                        for m, t in st.items()}
                    for k, st in state["opt"].items()}}


def test_jax_loads_the_port_world2_save(ckpt):
    """JAX's loader reassembles the two ranks' extents into the global flat
    buffers and moments, equal to JAX's own step after the same 3 steps."""
    from paddle_tpu.distributed.checkpoint.load_state_dict import \
        load_state_dict
    d, state, _, gang = ckpt
    got = load_state_dict(_jax_targets(state), os.path.join(d, "port_s3"))
    for k, v in state["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for k, st in state["opt"].items():
        for m, t in st.items():
            np.testing.assert_allclose(got["opt"][k][m].numpy(), t,
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{k}.{m}")


def test_each_rank_writes_its_own_extents(ckpt):
    d, _, _, gang = ckpt
    with open(os.path.join(d, "port_s3", "metadata.json")) as f:
        meta = json.load(f)["tensors"]
    for k in ("p0", "p1", "p2", "p3"):
        shards = meta[f"params.{k}"]["shards"]
        assert [s["file"] for s in shards] == ["rank0.data", "rank1.data"]
        n = meta[f"params.{k}"]["shape"][0]
        assert [s["index"] for s in shards] == [[[0, n // 2]],
                                                [[n // 2, n]]]
    assert meta["step"] == {"py": True, "value": 3}


def test_replicated_extents_are_written_once(ckpt):
    """Stage 2's replicated bucket and the 0-d beta powers: one extent, in
    the coordinator's file only; the sharded moments: one extent a
    rank."""
    d, _, _, _ = ckpt
    path = os.path.join(d, "port_s2")
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)["tensors"]
    assert [s["file"] for s in meta["params.b_float32"]["shards"]] \
        == ["rank0.data"]
    assert [s["file"] for s in meta["opt.b_float32.beta1_pow"]["shards"]] \
        == ["rank0.data"]
    assert [s["file"] for s in meta["opt.b_float32.moment1"]["shards"]] \
        == ["rank0.data", "rank1.data"]
    with open(os.path.join(path, "rank1.data"), "rb") as f:
        names = {name for name, _ in pickle.load(f)}
    assert names == {"opt.b_float32.moment1", "opt.b_float32.moment2"}


def test_port_world2_loads_the_jax_save(ckpt):
    """Each rank reads its extents of JAX's save; the resumed fourth step
    gives JAX's fourth loss."""
    _, state, fourth, gang = ckpt
    for r, res in enumerate(gang):
        for k, v in state["params"].items():
            half = len(v) // 2
            np.testing.assert_allclose(res["loaded"]["params"][k],
                                       v[r * half:(r + 1) * half], rtol=0,
                                       atol=0, err_msg=k)
        for k, st in state["opt"].items():
            for m, t in st.items():
                want = t[r * (len(t) // 2):(r + 1) * (len(t) // 2)] \
                    if t.ndim else t
                np.testing.assert_allclose(res["loaded"]["opt"][k][m], want,
                                           rtol=0, atol=0)
        np.testing.assert_allclose(res["resumed_loss"], fourth, rtol=1e-4,
                                   atol=1e-5)
