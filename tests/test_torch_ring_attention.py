"""Ring, Ulysses and ring flash attention of the port against JAX's
(the counterpart of ``tests/test_ring_attention.py``): one gang of four
ranks on gloo (``tests/torch_launch_scripts/ring_rank.py``) runs
``parallel.ring_attention`` with the sequence split over a ``sep`` axis of
4; while it runs, the module fixture runs JAX's functions under
``shard_map`` over 4 devices on the same numpy inputs (the flash ring's
Pallas kernels in interpret mode).

Held, in f32: ring and Ulysses attention, causal and not, within 2e-5 of
JAX's ``shard_map`` results (and of dense attention); the differentiable
ring's gradients; the ring flash forward at ``hkv`` 4 and 2 (GQA); its
backward's gradients (each within 1e-4 of the tensor's max |grad|); and
the ring flash forward saves only local shards for its backward."""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from torch_gang import start_gang

N = 4
TOL = dict(rtol=2e-5, atol=2e-5)
FLASH = (("full", False, 4), ("causal", True, 4), ("causal_gqa", True, 2))
FLASH_S_LOCAL = 128


def _inputs():
    """Every case's inputs, [B, S, H, D] f32: ring (2, 64, 4, 16), Ulysses
    (2, 64, 8, 16), the differentiable ring (1, 64, 2, 16) and the flash
    ring (1, 512, 4 / 2 heads, 64), drawn from seeded numpy."""
    rng = np.random.default_rng(8)
    out = {}
    for name, shape in (("ring", (2, 64, 4, 16)), ("uly", (2, 64, 8, 16)),
                        ("rgrad", (1, 64, 2, 16)),
                        ("fgrad", (1, N * FLASH_S_LOCAL, 2, 64))):
        for x in "qkv":
            out[f"{name}_{x}"] = rng.standard_normal(shape).astype(np.float32)
    for case, _, hkv in FLASH:
        S = N * FLASH_S_LOCAL
        out[f"flash_{case}_q"] = rng.normal(0, 1, (1, S, 4, 64)) \
            .astype(np.float32)
        for x in "kv":
            out[f"flash_{case}_{x}"] = rng.normal(0, 1, (1, S, hkv, 64)) \
                .astype(np.float32)
    return out


def _dense(q, k, v, causal):
    d = q.shape[-1]
    rep = q.shape[2] // k.shape[2]
    k, v = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(d)
    if causal:
        S = s.shape[-1]
        s = np.where(np.tril(np.ones((S, S), bool)), s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v.astype(np.float64))


def _jax_oracle(inp):
    from paddle_tpu.parallel.ring_attention import (ring_attention,
                                                    ring_flash_attention,
                                                    ulysses_attention)
    mesh = Mesh(np.array(jax.devices()[:N]), ("sep",))
    specs = dict(mesh=mesh, in_specs=(P(None, "sep"),) * 3,
                 out_specs=P(None, "sep"), check_vma=False)

    def sm(fn):
        return jax.jit(jax.shard_map(fn, **specs))

    def args(name):
        return [inp[f"{name}_{x}"] for x in "qkv"]

    ref = {}
    for c in (False, True):
        ref[f"ring_{int(c)}"] = sm(lambda q, k, v, c=c: ring_attention(
            q, k, v, axis="sep", causal=c))(*args("ring"))
        ref[f"uly_{int(c)}"] = sm(lambda q, k, v, c=c: ulysses_attention(
            q, k, v, axis="sep", causal=c))(*args("uly"))

    def ring_loss(q, k, v):
        o = sm(lambda q, k, v: ring_attention(q, k, v, axis="sep",
                                              causal=True))(q, k, v)
        return (o.astype(jnp.float32) ** 2).sum()
    g = jax.jit(jax.grad(ring_loss, argnums=(0, 1, 2)))(*args("rgrad"))
    ref.update({f"rgrad_d{x}": t for x, t in zip("qkv", g)})
    for case, causal, _ in FLASH:
        ref[f"flash_{case}"] = sm(
            lambda q, k, v, c=causal: ring_flash_attention(
                q, k, v, axis="sep", causal=c, interpret=True))(
            *args(f"flash_{case}"))

    def flash_loss(q, k, v):
        def body(q, k, v):
            o = ring_flash_attention(q, k, v, axis="sep", causal=True,
                                     interpret=True)
            return jax.lax.psum(jnp.sum(o.astype(jnp.float32) ** 2), "sep")
        return jax.shard_map(body, mesh=mesh, in_specs=(P(None, "sep"),) * 3,
                             out_specs=P(), check_vma=False)(q, k, v)
    g = jax.jit(jax.grad(flash_loss, argnums=(0, 1, 2)))(*args("fgrad"))
    ref.update({f"fgrad_d{x}": t for x, t in zip("qkv", g)})
    return {k: np.asarray(v) for k, v in ref.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' shards joined along the sequence, their saved shapes,
    JAX's oracle and the inputs."""
    d = str(tmp_path_factory.mktemp("ring"))
    inp = _inputs()
    np.savez(os.path.join(d, "inputs.npz"), **inp)
    wait = start_gang("ring_rank.py", d, nproc=N)
    ref = _jax_oracle(inp)
    meta = wait()
    shards = [np.load(os.path.join(d, f"rank{r}.npz")) for r in range(N)]
    got = {k: np.concatenate([s[k] for s in shards], axis=1)
           for k in shards[0].files}
    return got, meta, ref, inp


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["ring", "uly"])
def test_ring_and_ulysses_match_jax_and_full_attention(runs, kind, causal):
    got, _, ref, inp = runs
    key = f"{kind}_{int(causal)}"
    np.testing.assert_allclose(got[key], ref[key], **TOL)
    want = _dense(*(inp[f"{kind}_{x}"] for x in "qkv"), causal)
    np.testing.assert_allclose(got[key], want, **TOL)


def _grads_close(got, ref, prefix):
    for x in "qkv":
        g, r = got[f"{prefix}_d{x}"], ref[f"{prefix}_d{x}"]
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max(), x


def test_ring_attention_differentiable(runs):
    """Gradients of sum(out^2) through the causal ring (the hops' backward
    sends the gradients back along the ring) equal JAX's ``jax.grad`` of its
    ``shard_map`` ring."""
    got, _, ref, _ = runs
    _grads_close(got, ref, "rgrad")


@pytest.mark.parametrize("case", [c for c, _, _ in FLASH])
def test_ring_flash_forward_matches_jax_and_dense(runs, case):
    """Every hop through the flash forward (row 3's plain version here),
    the hops merged through their lse: JAX's ring flash forward at ``hkv``
    4 and 2, and dense attention."""
    got, _, ref, inp = runs
    key = f"flash_{case}"
    np.testing.assert_allclose(got[key], ref[key], **TOL)
    causal = dict((c, k) for c, k, _ in FLASH)[case]
    want = _dense(*(inp[f"{key}_{x}"] for x in "qkv"), causal)
    np.testing.assert_allclose(got[key], want, **TOL)


def test_ring_flash_backward_matches_jax(runs):
    """The ring flash backward (rows 5 / 6 a hop, with the global lse and
    delta; the dK / dV sums travelling the whole ring home) gives JAX's
    ``jax.grad`` of its ``shard_map`` ring flash."""
    got, _, ref, _ = runs
    _grads_close(got, ref, "fgrad")


def test_ring_flash_residuals_are_local_shards(runs):
    """What the ring flash forward saves for its backward is the local q,
    k, v, out and lse: no tensor with the global sequence length, none
    longer than the local shard, none saved per hop."""
    _, meta, _, _ = runs
    S = N * FLASH_S_LOCAL
    for r in meta:
        assert r["saved"], "nothing saved"
        assert len(r["saved"]) == 5
        for shape in r["saved"]:
            assert S not in shape, shape
            assert FLASH_S_LOCAL in shape, shape
