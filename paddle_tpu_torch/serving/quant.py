"""Quantized serving: the int8/fp8 KV codec and the serving-weight
quantizer (port of ``paddle_tpu/serving/quant.py``).

  * :func:`quantize_kv` / :func:`dequantize_kv` — the one symmetric-absmax
    KV codec, one f32 scale per (page, kv head, token row).  Per-row scales
    make quantization independent of write order: a token row quantizes the
    same whether a dense prefill, a chunk, a decode step or a speculative
    verify wrote it, so the quantized engine stays exact against itself.
  * :func:`kv_spec` — ``kv_dtype`` name -> (storage dtype, qmax).
  * :func:`page_bytes` — bytes of one KV page (K and V, all layers, scales
    included).
  * :func:`quantize_params` — per-channel weight quantization of the
    serving parameters, stored dequantized in their own dtype.
  * :func:`parity_scenarios` / :func:`logit_drift` / :func:`parity_report`
    — the quantized plane's parity harness: greedy exact match and the
    teacher-forced logit drift of a quantized engine against the
    unquantized one on the same parameters.

Codes and scales equal the JAX codec's bit for bit: the same f32 divide,
round half to even, clip, and the same f32 -> float8_e4m3fn cast.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..quantization import dequantize_weight, quantize_weight

__all__ = ["KV_DTYPES", "kv_spec", "quantize_kv", "dequantize_kv",
           "page_bytes", "quantize_params", "parity_scenarios",
           "logit_drift", "parity_report"]

# kv_dtype name -> (storage dtype, qmax): 127 keeps the int8 grid symmetric
# (-128 is never emitted); 448 is the largest finite e4m3 value, so the
# absmax maps onto the whole fp8 range without rounding into NaN.
KV_DTYPES = {"int8": (torch.int8, 127.0),
             "fp8": (torch.float8_e4m3fn, 448.0)}


def kv_spec(kv_dtype):
    """``kv_dtype`` name -> (storage torch dtype, qmax); ValueError for an
    unknown name."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(
            f"unknown kv_dtype {kv_dtype!r} (expected one of "
            f"{sorted(KV_DTYPES)}, or None for the f32/bf16 page store)")
    return KV_DTYPES[kv_dtype]


def quantize_kv(x, *, qmax, dtype):
    """Symmetric absmax quantization of K/V rows: ``x [..., D]`` (any float
    dtype) -> ``(q [..., D] in dtype, scale [...] f32)``, one scale per row.
    Zero rows round-trip to exact zeros."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp(min=1e-8) / qmax
    y = xf / scale[..., None]
    if dtype.is_floating_point:
        # fp8: the cast is the rounding; |y| <= qmax, so it never overflows
        return y.to(dtype), scale
    return torch.clamp(torch.round(y), -qmax, qmax).to(dtype), scale


def dequantize_kv(q, scale):
    """``(q [..., D], scale [...])`` -> f32 values; the one dequant
    expression every attention path uses."""
    return q.float() * scale[..., None].float()


def page_bytes(config, page_size: int, kv_dtype=None, dtype=None) -> int:
    """Bytes of ONE page of KV cache: K and V across all layers, with the
    per-row f32 scales for a quantized ``kv_dtype``."""
    L = config.num_hidden_layers
    hkv = config.num_key_value_heads
    d = config.hidden_size // config.num_attention_heads
    rows = 2 * L * hkv * page_size
    if kv_dtype is None:
        item = torch.empty(0, dtype=dtype or torch.float32).element_size()
        return rows * d * item
    storage, _ = kv_spec(kv_dtype)
    return rows * d * torch.empty(0, dtype=storage).element_size() + rows * 4


def _quant_leaf(w, bits, reduce_axis):
    q, scale = quantize_weight(w, bits=bits, axis=reduce_axis)
    return dequantize_weight(q, scale, dtype=w.dtype)


def quantize_params(params, bits: int = 8):
    """Snap the ``(embed, block, head)`` serving parameters onto the
    per-channel int grid: matmul weights with one absmax scale per output
    channel (reducing the contraction axis), the embedding per row; the
    norm gains (``ln*``) pass through.  Values come back dequantized in
    their own dtype."""
    ep, bp, hp = params
    ep = dict(ep, tok=_quant_leaf(ep["tok"], bits, -1))
    bp = {k: (v if k.startswith("ln") else _quant_leaf(v, bits, -2))
          for k, v in bp.items()}
    hp = dict(hp, lm=_quant_leaf(hp["lm"], bits, -2))
    return ep, bp, hp


# ---------------------------------------------------------------------------
# Parity harness (JAX ``serving/quant.py:167-341``)
# ---------------------------------------------------------------------------
def parity_scenarios(vocab: int, seed: int = 0, page_size: int = 8):
    """The standard parity scenario set, the JAX package's draws: seeded
    prompts that are short, on a page boundary (len % page_size == 0 and ==
    page_size - 1), long / multi-page, and a shared-prefix pair (the
    prefix-cache hit path).  Returns ``[(prompt int32 ndarray,
    max_new_tokens)]``."""
    rng = np.random.default_rng(seed)
    lens = [3, page_size, page_size - 1, 2 * page_size,
            3 * page_size + 2, 2 * page_size + 1]
    out = [(rng.integers(1, vocab, (int(t),)).astype(np.int32), 16)
           for t in lens]
    shared = rng.integers(1, vocab, (2 * page_size,)).astype(np.int32)
    for t in (3, page_size - 2):
        tail = rng.integers(1, vocab, (int(t),)).astype(np.int32)
        out.append((np.concatenate([shared, tail]), 16))
    return out


def _run_engine(factory, scenarios):
    eng = factory()
    rids = [eng.submit(p, max_new_tokens=m) for p, m in scenarios]
    done = eng.run()
    return [[int(t) for t in done[r].generated] for r in rids], eng


def _build_params(params, build_kw):
    """``params`` as the functions a ``build_kw`` build makes take them:
    this rank's shard where the build is tensor-parallel (a ``mesh`` whose
    ``mp_axis`` has more than one rank), else as they are."""
    from ..distributed.topology import axis_group
    from ..models.llama import _mp_degree, shard_llama_paged_params
    mesh = build_kw.get("mesh")
    axis = build_kw.get("mp_axis", "mp")
    tp = _mp_degree(mesh, axis)
    if tp == 1:
        return params
    return shard_llama_paged_params(params, axis_group(axis, mesh).rank, tp)


def logit_drift(params_ref, params_q, config, prompts, *, kv_dtype,
                page_size: int = 8, steps: int = 8, dtype=None,
                attention_impl: str = "auto", device=None,
                ref_build_kw=None, q_build_kw=None):
    """Max |logits_q - logits_ref| over a TEACHER-FORCED greedy decode:
    both page stores replay the reference's token trajectory, so the drift
    measures each step's quantization error on its own (a free-running
    comparison would conflate one early argmax flip with everything after
    it).  Returns (max drift, per-prompt lists of per-step drifts).

    ``ref_build_kw`` / ``q_build_kw``: extra ``build_llama_paged_decode``
    arguments per arm — how the quantized all-reduce is drifted against
    the f32-collective build: both arms ``mesh=<mesh>``, the q arm also
    ``quantized_allreduce=True``, with ``kv_dtype=None``.  A
    tensor-parallel arm takes this rank's shard of its parameters, and
    every rank of the mesh calls this function alike."""
    from .. import resolve_device
    from ..models.llama import build_llama_paged_decode

    dev = resolve_device(device)
    per = max(math.ceil((len(p) + steps) / page_size) for p in prompts)
    bkw = {"ref": dict(ref_build_kw or {}), "q": dict(q_build_kw or {})}
    builds = {tag: build_llama_paged_decode(
        config, page_size=page_size, num_pages=per + 1, dtype=dtype,
        attention_impl=attention_impl, device=dev, kv_dtype=kvd, **bkw[tag])
        for tag, kvd in (("ref", None), ("q", kv_dtype))}
    prm = {"ref": _build_params(params_ref, bkw["ref"]),
           "q": _build_params(params_q, bkw["q"])}
    i32 = dict(dtype=torch.int32, device=dev)
    drifts = []
    for prompt in prompts:
        T = len(prompt)
        ids = torch.as_tensor(np.asarray(prompt, np.int32)[None], **i32)
        row = torch.arange(per, **i32)
        state = {}
        for tag in ("ref", "q"):
            pages = builds[tag][0]()
            state[tag] = list(builds[tag][1](
                prm[tag], ids, torch.tensor(T, **i32), row, pages["k"],
                pages["v"]))
        step_drift = [float((state["q"][0].float()
                             - state["ref"][0].float()).abs().max())]
        tok = int(state["ref"][0].argmax())
        for i in range(steps - 1):
            for tag in ("ref", "q"):
                logits, pk, pv = builds[tag][3](
                    prm[tag], torch.tensor([tok], **i32),
                    torch.tensor([T + i], **i32), row[None], state[tag][1],
                    state[tag][2], torch.tensor([True], device=dev))
                state[tag] = [logits, pk, pv]
            step_drift.append(float((state["q"][0].float()
                                     - state["ref"][0].float()).abs().max()))
            tok = int(state["ref"][0][0].argmax())
        drifts.append(step_drift)
    return max(d for row_ in drifts for d in row_), drifts


def parity_report(params, config, *, kv_dtype="int8", quantize=8,
                  scenarios=None, engine_kw=None, drift_steps=8,
                  drift_prompts=2, ref_engine_kw=None, q_engine_kw=None,
                  ref_build_kw=None, q_build_kw=None, device=None):
    """Greedy exact-match rate and max logit drift of the quantized serving
    plane against the unquantized engine on the standard scenarios.

    Builds two engines from the same ``params`` — the reference, and one
    with ``kv_dtype`` pages (and per-channel ``quantize``-bit weights when
    ``quantize`` is set) — runs every scenario greedily on both, and
    reports ``exact_match`` (the share of requests whose whole greedy
    output matches), ``token_match`` (the mean matched-prefix share) and
    ``max_logit_drift`` (:func:`logit_drift` over the first
    ``drift_prompts`` scenarios), with ``mismatched`` request indices.
    ``ref_engine_kw`` / ``q_engine_kw`` merge per arm on top of
    ``engine_kw`` — with both arms ``mesh=<mesh>``, the q arm
    ``quantized_allreduce=True`` and ``kv_dtype=None, quantize=None``, the
    report measures the quantized all-reduce alone; ``ref_build_kw`` /
    ``q_build_kw`` forward to :func:`logit_drift` the same way.
    Deterministic for given params, config and scenarios."""
    from ..inference.paged import ServingEngine

    kw = dict(num_slots=4, page_size=8, attention_impl="auto",
              prompt_bucket=8, decode_horizon=4, device=device)
    kw.update(engine_kw or {})
    if scenarios is None:
        scenarios = parity_scenarios(config.vocab_size,
                                     page_size=kw["page_size"])
    need = max(math.ceil((len(p) + m) / kw["page_size"]) + 1
               for p, m in scenarios)
    kw.setdefault("max_pages_per_seq", need)
    kw.setdefault("num_pages", need * (len(scenarios) + kw["num_slots"]))
    params_q = quantize_params(params, bits=int(quantize)) if quantize \
        else params
    ref_kw = dict(kw, **(ref_engine_kw or {}))
    q_kw = dict(kw, **(q_engine_kw or {}))
    ref_outs, ref_eng = _run_engine(
        lambda: ServingEngine(params, config, **ref_kw), scenarios)
    q_outs, q_eng = _run_engine(
        lambda: ServingEngine(params_q, config, kv_dtype=kv_dtype, **q_kw),
        scenarios)
    matches = [a == b for a, b in zip(ref_outs, q_outs)]
    tok_fracs = []
    for a, b in zip(ref_outs, q_outs):
        m = 0
        while m < min(len(a), len(b)) and a[m] == b[m]:
            m += 1
        tok_fracs.append(m / max(len(a), 1))
    max_drift = 0.0            # drift pass skipped (cheap smoke mode)
    if drift_prompts > 0:
        max_drift, _ = logit_drift(
            params, params_q, config,
            [p for p, _m in scenarios[:drift_prompts]], kv_dtype=kv_dtype,
            page_size=kw["page_size"], steps=drift_steps,
            dtype=kw.get("dtype"), attention_impl=kw["attention_impl"],
            device=ref_eng.device, ref_build_kw=ref_build_kw,
            q_build_kw=q_build_kw)
    ref_eng.check_invariants()
    q_eng.check_invariants()
    return {
        "kv_dtype": kv_dtype,
        "weight_bits": int(quantize) if quantize else None,
        "scenarios": len(scenarios),
        "exact_match": round(sum(matches) / len(matches), 4),
        "token_match": round(float(np.mean(tok_fracs)), 4),
        "max_logit_drift": round(max_drift, 6),
        "mismatched": [i for i, ok in enumerate(matches) if not ok],
    }
