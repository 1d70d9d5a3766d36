"""What the expert-parallel gang (``moe_rank.py``) and its test share: the
world, the inputs (numpy only, so the test process imports this module as
it is) and the cases."""
import numpy as np

W = 4                          # the ep gang's world
A2A = (8, 3, 5)                # E, C, d of the all-to-all round trip
# moe_ffn at ep 4: name -> (tokens a rank, E, d, h, capacity, activation)
FFN_CASES = {"ample": (16, 8, 16, 32, 16, "gelu"),
             "tight": (16, 8, 16, 32, 5, "relu")}
# the tiny MoE LLaMA of JAX's tests/test_moe_pipeline.py:20: 4 layers at pp
# 2, E 4, top-2 at factor E / k (C = T: nothing drops), B 4 x S 16 in 2
# microbatches, AdamW lr 1e-2, 4 steps
LLAMA = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
             num_hidden_layers=4, num_attention_heads=4,
             num_key_value_heads=4, max_position_embeddings=16,
             num_experts=4, moe_topk=2, moe_capacity_factor=2.0)
N_MICRO, STEPS, LR = 2, 4, 1e-2
# JAX's initial gate (0.02 a weight) leaves a few tokens within ~1e-4 of a
# routing tie; 25x its logits give a margin far above f32's error
GATE_GAIN = 25.0


def ffn_inputs(name):
    """x [W * T, d], gate_weight [d, E], w1 [E, d, h], b1 [E, h], w2 [E, h,
    d], b2 [E, d].  The gate reads only x's first E features (the identity
    there), which are a permutation of E values 0.5 apart, so every top-2
    choice has a wide margin by construction."""
    T, E, d, h, _, _ = FFN_CASES[name]
    rng = np.random.default_rng(5 + len(name))
    x = rng.normal(size=(W * T, d)).astype(np.float32)
    x[:, :E] = rng.permuted(np.broadcast_to(
        np.arange(E, dtype=np.float32) * 0.5, (W * T, E)), axis=-1)
    gw = np.eye(d, E, dtype=np.float32)
    w1 = rng.normal(0, 0.05, (E, d, h)).astype(np.float32)
    b1 = rng.normal(0, 0.05, (E, h)).astype(np.float32)
    w2 = rng.normal(0, 0.05, (E, h, d)).astype(np.float32)
    b2 = rng.normal(0, 0.05, (E, d)).astype(np.float32)
    return x, gw, w1, b1, w2, b2


def clip_grads():
    """A shared gradient (the same on every rank) and each rank's expert
    gradient."""
    rng = np.random.default_rng(3)
    shared = rng.normal(size=(6,)).astype(np.float32)
    expert = rng.normal(size=(W, 6)).astype(np.float32)
    return shared, expert


def llama_ids():
    return np.random.default_rng(7).integers(0, 64, (4, 16)).astype(np.int32)
