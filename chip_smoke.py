"""Smoke run of paddle_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``paddle_tpu_torch/ops/csrc`` and drives
the port's main paths — the paged continuous-batching LLaMA server with a
bf16 KV cache, and with an int8 KV cache and speculative decoding — at the
full width of LLaMA-2 7B with random weights made from a seed:

  1. build     nvcc for every kernel source, all started together;
  2. kernel    both kernels against their plain PyTorch version on the
               card: 7B decode (kv_len 0/5/16/1024/..), a 256-token prefill
               chunk over a cached prefix, GQA 16:4 at D = 64 / page 64, a
               ragged q_len 0/1/3/5 mix (the verify shape); f32 and bf16
               inputs, bf16 and f32 outputs; the quantized kernel over int8
               and fp8 pages, and its fp8 -> f32 code table against
               torch's over all 256 codes;
  3. serving   (a) a bf16 ServingEngine at 7B widths serves 8 requests in
               4 slots: chunked prefill, a prefix-cache hit served by a
               suffix prefill, greedy decode; the plain kernel's launch
               counter must cover every layer of every decode step and the
               plain version must not run; then a decode step's wall time
               against its kernels' device time (torch.profiler);
               (b) the same 7B model with kv_dtype="int8" and
               speculative=4, its pool the same KV bytes as (a), serves
               traffic whose prompts repeat a segment: the quantized
               kernel's launches must equal layers x attention dispatches
               (decode steps + verify steps + prefill chunks), the plain
               kernel and the plain version must not run, and drafts must
               be proposed and verified;
  4. engine    a 2-layer f32 engine at 7B widths with margin-engineered
               weights gives the same greedy tokens with the kernel as with
               the plain version, for f32, int8 and fp8 pages, and with
               speculative=4 as without;
  5. timing    each kernel, its plain version and the bound (bytes over
               3.35 TB/s, operations over 989 TFLOP/s bf16) at the decode,
               verify and chunk shapes of phase 3;
  6. summary   the card's name and power limit, a ``kernels`` JSON line and
               the result line.

Any failed check raises and exits non-zero; so does a machine with no CUDA
device, or a directory without the package.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor cores
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
# quantized pages at bf16: the plain version rounds each dequantized K/V row
# to bf16 before attending (as the JAX reference does) and the kernel keeps
# it in f32, so the two differ by that rounding (2**-9 relative per
# element) on top of the bf16 output rounding
TOL_QUANT_BF16 = (2e-2, 2e-2)
CSRC = "paddle_tpu_torch/ops/csrc/"
PLAIN = dict(name="ragged_paged_attention", route="cuda",
             source=CSRC + "ragged_paged_attention.cu",
             replaces="paddle_tpu/ops/pallas/paged_attention.py:124")
QUANT = dict(name="ragged_paged_attention_quant", route="cuda",
             source=CSRC + "ragged_paged_attention_quant.cu",
             replaces="paddle_tpu/ops/pallas/paged_attention.py:147")
KV_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def require(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# -- phase 2: the kernel against its plain version ---------------------------
def make_case(gen, S, Qmax, Hq, Hkv, D, ps, NP, P, q_start, q_len, kv_len,
              dtype):
    dev = "cuda"
    q = torch.randn(S, Qmax, Hq, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(Hkv, NP, ps, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(Hkv, NP, ps, D, generator=gen, device=dev).to(dtype)
    pt = torch.randint(0, NP, (S, P), generator=gen, device=dev,
                       dtype=torch.int32)
    seg = [torch.tensor(x, dtype=torch.int32, device=dev)
           for x in (q_start, q_len, kv_len)]
    return q, k, v, pt, *seg


def reset_counts(pa):
    pa.ragged_paged_attention.launches = 0
    pa.ragged_paged_attention.quant_launches = 0
    pa.ragged_paged_attention_ref.calls = 0


def counts(pa):
    return (pa.ragged_paged_attention.launches,
            pa.ragged_paged_attention.quant_launches,
            pa.ragged_paged_attention_ref.calls)


def quantize_pages(args, kv_dtype):
    """The case's f32/bf16 pages as int8 / fp8 codes + per-row scales."""
    from paddle_tpu_torch.serving.quant import kv_spec, quantize_kv
    dt, qmax = kv_spec(kv_dtype)
    (kq, ks), (vq, vs) = (quantize_kv(p, qmax=qmax, dtype=dt)
                          for p in args[1:3])
    return (args[0], kq, vq, *args[3:]), dict(k_scales=ks, v_scales=vs)


def compare(pa, name, args, out_dtype, **scales):
    got = pa.ragged_paged_attention(*args, out_dtype=out_dtype, **scales)
    want = pa.ragged_paged_attention_ref(*args, out_dtype=out_dtype,
                                         **scales)
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    atol, rtol = TOL_QUANT_BF16 if scales and args[0].dtype == torch.bfloat16 \
        else TOL[out_dtype]
    err = (got - want).abs()
    max_err = err.max().item()
    require(bool((err <= atol + rtol * want.abs()).all()),
            f"{name}: kernel vs plain max abs err {max_err:.3e} "
            f"(atol {atol}, rtol {rtol})")
    q_len = args[5].long()
    pad = torch.arange(got.shape[1], device="cuda")[None, :] >= q_len[:, None]
    require(bool((got[pad] == 0).all()),
            f"{name}: padding rows / q_len=0 slots not exactly zero")
    print(f"  {name:<44} out={str(out_dtype)[6:]:<8} max_abs_err="
          f"{max_err:.3e} (tol {atol:g} + {rtol:g}*|ref|)")
    return max_err


KERNEL_CASES = [
        ("7B decode S=8 ps=16 kv_len 0/5/16/1024/..",
         dict(S=8, Qmax=1, Hq=32, Hkv=32, D=128, ps=16, NP=600, P=64,
              q_start=[0, 4, 15, 1023, 299, 16, 0, 776],
              q_len=[0, 1, 1, 1, 1, 1, 1, 1],
              kv_len=[0, 5, 16, 1024, 300, 17, 1, 777])),
        ("7B prefill chunk Qmax=256 over 256 cached",
         dict(S=1, Qmax=256, Hq=32, Hkv=32, D=128, ps=16, NP=64, P=40,
              q_start=[256], q_len=[256], kv_len=[512])),
        ("GQA 16:4 D=64 ps=64",
         dict(S=3, Qmax=8, Hq=16, Hkv=4, D=64, ps=64, NP=9, P=4,
              q_start=[0, 60, 130], q_len=[8, 1, 5], kv_len=[8, 61, 135])),
        ("ragged multi-query q_len 0/1/3/5 (verify)",
         dict(S=4, Qmax=5, Hq=32, Hkv=32, D=128, ps=16, NP=20, P=8,
              q_start=[10, 100, 63, 0], q_len=[0, 1, 3, 5],
              kv_len=[10, 101, 66, 5])),
]
DTYPE_PAIRS = ((torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float32))


def phase_kernel(pa):
    """Both kernels against the plain version; returns the worst absolute
    error of each."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"plain": 0.0, "quant": 0.0}
    for name, kw in KERNEL_CASES:
        for dtype, out_dtype in DTYPE_PAIRS:
            args = make_case(gen, dtype=dtype, **kw)
            err = compare(pa, f"{name} [{str(dtype)[6:]}]", args, out_dtype)
            worst["plain"] = max(worst["plain"], err)
            for kv_dtype in KV_DTYPES:
                qargs, scales = quantize_pages(args, kv_dtype)
                err = compare(pa, f"{name} [{str(dtype)[6:]}, {kv_dtype}]",
                              qargs, out_dtype, **scales)
                worst["quant"] = max(worst["quant"], err)
    fp8_code_table(pa)
    return worst


def fp8_code_table(pa):
    """Every one of the 256 codes through the quantized kernel: one KV token,
    scale 1, so each output element is exactly the kernel's f32 value of a
    V code — held bit for bit to torch's own conversion (NaN codes
    included)."""
    for kv_dtype, dt in KV_DTYPES.items():
        codes = torch.arange(256, dtype=torch.uint8, device="cuda")
        vq = torch.zeros(2, 1, 16, 128, dtype=torch.uint8, device="cuda")
        vq[:, 0, 0] = codes.reshape(2, 128)
        kq, vq = torch.zeros_like(vq).view(dt), vq.view(dt)
        ones = torch.ones(2, 1, 16, device="cuda")
        one = torch.ones(1, dtype=torch.int32, device="cuda")
        out = pa.ragged_paged_attention(
            torch.randn(1, 1, 2, 128, device="cuda"), kq, vq,
            torch.zeros(1, 1, dtype=torch.int32, device="cuda"),
            torch.zeros(1, dtype=torch.int32, device="cuda"), one, one,
            k_scales=ones, v_scales=ones)
        want = codes.view(dt).float().reshape(1, 1, 2, 128)
        same = (out == want) | (out.isnan() & want.isnan())
        require(bool(same.all()), f"{kv_dtype} code table: "
                f"{int((~same).sum())} of 256 codes convert differently")
        print(f"  {kv_dtype} -> f32 over all 256 codes: equal to torch's "
              f"({int(want.isnan().sum())} NaN codes)")


# -- phase 3: serving at 7B widths -------------------------------------------
def traffic(vocab):
    """8 requests: prompts of 64-1024 tokens, two sharing a 512-token
    prefix (the second one is queued behind the first four, so it arrives
    after the first has finished its prefill), 32-64 new tokens each."""
    r = np.random.default_rng(0)

    def toks(n):
        return r.integers(1, vocab, n).astype(np.int32)

    prefix = toks(512)
    return [(np.concatenate([prefix, toks(100)]), 48), (toks(64), 64),
            (toks(1024), 32), (toks(200), 40), (toks(128), 56),
            (np.concatenate([prefix, toks(200)]), 48), (toks(300), 32),
            (toks(96), 64)]


def phase_serving(pa, cfg, params):
    from paddle_tpu_torch.inference.paged import ServingEngine
    from paddle_tpu_torch.models.llama import build_llama_paged_decode

    # finite logits of the expected shape from the model functions
    init_pages, _, prefill_chunk, decode_step, _ = build_llama_paged_decode(
        cfg, page_size=16, num_pages=8, dtype=torch.bfloat16, device="cuda")
    pages = init_pages()
    ids = torch.randint(1, cfg.vocab_size, (1, 64), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(3), dtype=torch.int32)
    row = torch.arange(8, dtype=torch.int32, device="cuda")
    logits, tok, _, _ = prefill_chunk(params, ids, 0, 64, row, pages["k"],
                                      pages["v"])
    require(logits.shape == (cfg.vocab_size,)
            and bool(torch.isfinite(logits).all()), "prefill logits finite")
    logits, _, _ = decode_step(
        params, tok.reshape(1), torch.tensor([64], dtype=torch.int32,
                                             device="cuda"),
        row[None], pages["k"], pages["v"],
        torch.tensor([True], device="cuda"))
    require(logits.shape == (1, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()), "decode logits finite")
    del pages

    eng = ServingEngine(params, cfg, num_slots=4, page_size=16,
                        num_pages=320, max_pages_per_seq=72,
                        dtype=torch.bfloat16, prompt_bucket=32,
                        decode_horizon=8, prefill_chunk=256, device="cuda")
    # warm-up (cuBLAS handles, allocator, kernel load): one dense and one
    # chunked prefill, a few horizons
    warm = np.random.default_rng(1)
    for n in (64, 300):
        eng.submit(warm.integers(1, cfg.vocab_size, n), max_new_tokens=9)
    eng.run()
    torch.cuda.synchronize()

    reqs = traffic(cfg.vocab_size)
    base = eng.stats()
    reset_counts(pa)
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, quant_launches, ref_calls = counts(pa)
    st = eng.stats()
    delta = {k: st[k] - base[k] for k in st}

    out = [done[r] for r in rids]
    for (p, m), rq in zip(reqs, out):
        require(len(rq.generated) == m, f"request {rq.rid} finished with "
                f"{len(rq.generated)} of {m} tokens")
        require(all(0 <= t < cfg.vocab_size for t in rq.generated),
                f"request {rq.rid} token ids in range")
    require(out[5].cached_prefix_tokens >= 512,
            f"the shared-prefix request attached "
            f"{out[5].cached_prefix_tokens} cached tokens (want >= 512)")
    L = cfg.num_hidden_layers
    dispatches = delta["decode_model_steps"] + delta["prefill_chunks"]
    require(launches == L * dispatches and launches > 0,
            f"kernel launches {launches} != layers x attention dispatches "
            f"{L} x {dispatches}")
    require(ref_calls == 0 and quant_launches == 0,
            f"plain version ran {ref_calls} times, quantized kernel "
            f"{quant_launches}")
    eng.check_invariants()

    n_tok = sum(len(r.generated) for r in out)
    ttft = np.array([r.ttft for r in out]) * 1e3
    print(f"  requests {len(out)} in 4 slots, tokens {n_tok}, wall "
          f"{wall:.3f} s, {n_tok / wall:.1f} tokens/s")
    print(f"  TTFT p50 {np.percentile(ttft, 50):.1f} ms, p95 "
          f"{np.percentile(ttft, 95):.1f} ms (all submitted at t=0)")
    print(f"  engine counters: {json.dumps(delta)}")
    print(f"  kernel launches {launches} (= {L} layers x ("
          f"{delta['decode_model_steps']} decode steps + "
          f"{delta['prefill_chunks']} chunks)), plain-version calls "
          f"{ref_calls}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB")
    decode_breakdown(eng, cfg)
    return dict(launches=launches, tokens=n_tok, wall_s=wall,
                kv_bytes=eng.pool.num_pages * eng.page_bytes,
                tokens_per_s=n_tok / wall,
                ttft_p50_ms=float(np.percentile(ttft, 50)),
                ttft_p95_ms=float(np.percentile(ttft, 95)),
                decode_kv_lens=[len(reqs[i][0]) + reqs[i][1] // 2
                                for i in range(4)])


def timed_steps(eng, steps):
    """Host wall time of ``steps`` engine steps, then the same number under
    torch.profiler: the device time of their kernels in ms, split into the
    attention kernels, matrix products and the rest, and the kernel count."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    groups = {"attention": 0.0, "matmul": 0.0, "other": 0.0}
    launches = 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if not dev_us or ev.key.startswith(("cuda", "aten::")):
            continue
        launches += ev.count
        key = ev.key.lower()
        g = "attention" if "ragged_paged_attention" in key else \
            "matmul" if any(s in key for s in ("gemm", "gemv", "cutlass",
                                               "sm90_xmma", "nvjet")) \
            else "other"
        groups[g] += dev_us / 1e3
    return wall, groups, launches


def print_breakdown(what, eng, wall, n, groups, launches):
    busy = sum(groups.values())
    weights = sum(t.numel() * t.element_size()
                  for tree in eng.params for t in tree.values())
    per = {k: v / n for k, v in groups.items()}
    print(f"  {what}: wall {wall / n * 1e3:.2f} ms unprofiled, device busy "
          f"{busy / n:.2f} ms ({busy / (wall * 1e3) * 100:.1f}%: attention "
          f"{per['attention']:.3f}, matmul {per['matmul']:.3f}, other "
          f"{per['other']:.3f} ms), {launches / n:.0f} kernels; weight "
          f"bytes bound {weights / HBM_BYTES_PER_S * 1e3:.2f} ms")


def decode_breakdown(eng, cfg, steps=2):
    """Where a decode step's time goes: four slots of 512-token contexts,
    pure decode horizons (K = 8 steps each) — first timed on the host
    clock, then the same number under torch.profiler for the device time
    of their kernels."""
    r = np.random.default_rng(4)
    for _ in range(4):
        eng.submit(r.integers(1, cfg.vocab_size, 512),
                   max_new_tokens=1 + eng.decode_horizon * (2 * steps + 1))
    eng.step()                      # admissions: the first prefill chunks
    eng.step()                      # the second chunks, the first horizon
    n0, c0 = eng.decode_model_steps, eng.prefill_chunks
    wall, groups, launches = timed_steps(eng, steps)
    n = (eng.decode_model_steps - n0) // 2
    require(n == steps * eng.decode_horizon and eng.prefill_chunks == c0,
            "the timed windows ran pure decode horizons")
    eng.run()
    print_breakdown(f"decode step ({eng.num_slots} slots, 512-token "
                    f"contexts)", eng, wall, n, groups, launches)


def verify_breakdown(eng, cfg, succ, steps=2):
    """The same for a verify step of the speculative engine: four slots of
    512-token contexts whose prompts hold 64 tokens of the greedy path, so
    every step verifies four drafts per slot (five tokens each when all
    are accepted)."""
    r = np.random.default_rng(9)
    for _ in range(4):
        x = int(r.integers(1, cfg.vocab_size))
        eng.submit(np.concatenate([r.integers(1, cfg.vocab_size, 447),
                                   path(succ, x, 64), [x]]),
                   max_new_tokens=48)
    eng.step()                      # admissions: the first prefill chunks
    eng.step()                      # the second chunks, the first verify
    v0, t0, c0 = eng.verify_steps, eng.tokens_generated, eng.prefill_chunks
    wall, groups, launches = timed_steps(eng, steps)
    require(eng.verify_steps - v0 == 2 * steps and eng.prefill_chunks == c0,
            "the timed windows ran verify steps only")
    tokens = (eng.tokens_generated - t0) / (2 * steps)
    eng.run()
    print_breakdown(f"verify step ({eng.num_slots} slots, 512-token "
                    f"contexts, {tokens:.1f} tokens per step)", eng, wall,
                    steps, groups, launches)


def successor_model(params, seed):
    """Turn ``(ep, bp, hp)`` IN PLACE into a model whose greedy continuation
    of token t is SUCC[t] by a wide margin: block weights x0.15, the
    embedding x50 so that it dominates the residual stream through every
    layer, and the LM head the embedding of the vocabulary permuted by
    SUCC's inverse.  Returns SUCC.  Every layer still runs at full width on
    real data; only the answer becomes known in advance."""
    ep, bp, hp = params
    vocab = ep["tok"].shape[0]
    succ = np.random.default_rng(seed).permutation(vocab)
    for k, v in bp.items():
        if k.startswith("w"):
            v.mul_(0.15)
    ep["tok"].mul_(50.0)
    inv = torch.as_tensor(np.argsort(succ), device=ep["tok"].device)
    hp["lm"] = ep["tok"][inv].T.contiguous()
    return succ


def path(succ, t, n):
    """n tokens of the successor model's greedy path from t."""
    out = [int(t)]
    for _ in range(n - 1):
        out.append(int(succ[out[-1]]))
    return out


def spec_traffic(vocab, succ):
    """8 requests whose prompts repeat a stretch of the model's greedy path:
    random tokens, the stretch from x, 8 random tokens, then x again — so
    from its first decode step on the n-gram index proposes the stretch and
    the drafts are accepted until the stretch runs out.  Two share a
    512-token prefix, one is chunked four ways; 32-64 new tokens each."""
    r = np.random.default_rng(6)

    def prompt(n, stretch):
        x = int(r.integers(1, vocab))
        return np.concatenate([r.integers(1, vocab, n - stretch - 9),
                               path(succ, x, stretch),
                               r.integers(1, vocab, 8), [x]]).astype(np.int32)

    first = prompt(612, 32)
    return [(first, 48), (prompt(64, 24), 64), (prompt(1024, 40), 32),
            (prompt(200, 30), 40), (prompt(128, 48), 56),
            (np.concatenate([first[:512], prompt(200, 30)]), 48),
            (prompt(300, 36), 32), (prompt(96, 24), 64)]


def phase_serving_quant(pa, cfg, params, kv_bytes):
    """The int8-KV + speculative=4 engine at 7B widths, its pool holding the
    same KV bytes as phase 3a's."""
    from paddle_tpu_torch.inference.paged import ServingEngine
    from paddle_tpu_torch.serving.quant import page_bytes

    succ = successor_model(params, seed=7)
    num_pages = kv_bytes // page_bytes(cfg, 16, kv_dtype="int8")
    eng = ServingEngine(params, cfg, num_slots=4, page_size=16,
                        num_pages=num_pages, max_pages_per_seq=72,
                        dtype=torch.bfloat16, prompt_bucket=32,
                        decode_horizon=8, prefill_chunk=256,
                        kv_dtype="int8", speculative=4, device="cuda")
    require(eng._pages_k["q"].dtype == torch.int8, "int8 page store")
    print(f"  pool {num_pages} int8 pages x {eng.page_bytes} B = "
          f"{num_pages * eng.page_bytes / 1e9:.3f} GB (phase 3a: "
          f"{kv_bytes / 1e9:.3f} GB)")
    r = np.random.default_rng(8)
    for n in (64, 300):                   # warm-up: dense + chunked prefill
        x = int(r.integers(1, cfg.vocab_size))
        eng.submit(np.concatenate([r.integers(1, cfg.vocab_size, n - 13),
                                   path(succ, x, 12), [x]]),
                   max_new_tokens=17)
    eng.run()
    torch.cuda.synchronize()

    reqs = spec_traffic(cfg.vocab_size, succ)
    base = eng.stats()
    reset_counts(pa)
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, quant_launches, ref_calls = counts(pa)
    st = eng.stats()
    delta = {k: st[k] - base[k] for k in st if k != "draft_accept_rate"}
    out = [done[r] for r in rids]
    for (p, m), rq in zip(reqs, out):
        require(rq.generated == path(succ, succ[p[-1]], m),
                f"request {rq.rid}: the tokens leave the model's greedy path")
    require(out[5].cached_prefix_tokens >= 512,
            f"the shared-prefix request attached "
            f"{out[5].cached_prefix_tokens} cached tokens (want >= 512)")
    L = cfg.num_hidden_layers
    dispatches = delta["decode_model_steps"] + delta["verify_steps"] \
        + delta["prefill_chunks"]
    require(quant_launches == L * dispatches,
            f"quantized kernel launches {quant_launches} != layers x "
            f"attention dispatches {L} x {dispatches}")
    require(launches == 0 and ref_calls == 0,
            f"plain kernel ran {launches} times, plain version {ref_calls}")
    require(delta["verify_steps"] > 0 and delta["draft_tokens_proposed"] > 0,
            "no draft was proposed and verified")
    eng.check_invariants()

    n_tok = sum(len(r.generated) for r in out)
    ttft = np.array([r.ttft for r in out]) * 1e3
    acc = delta["draft_tokens_accepted"] / delta["draft_tokens_proposed"]
    print(f"  requests {len(out)} in 4 slots, tokens {n_tok}, wall "
          f"{wall:.3f} s, {n_tok / wall:.1f} tokens/s; every request on "
          f"the model's greedy path")
    print(f"  TTFT p50 {np.percentile(ttft, 50):.1f} ms, p95 "
          f"{np.percentile(ttft, 95):.1f} ms (all submitted at t=0)")
    print(f"  drafts proposed {delta['draft_tokens_proposed']}, accepted "
          f"{delta['draft_tokens_accepted']} (acceptance {acc:.3f}) in "
          f"{delta['verify_steps']} verify steps")
    print(f"  engine counters: {json.dumps(delta)}")
    print(f"  quantized kernel launches {quant_launches} (= {L} layers x ("
          f"{delta['decode_model_steps']} decode steps + "
          f"{delta['verify_steps']} verify steps + {delta['prefill_chunks']}"
          f" chunks)), plain kernel {launches}, plain version {ref_calls}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB")
    verify_breakdown(eng, cfg, succ)
    return dict(quant_launches=quant_launches, tokens_per_s=n_tok / wall,
                ttft_p50_ms=float(np.percentile(ttft, 50)),
                ttft_p95_ms=float(np.percentile(ttft, 95)), acceptance=acc,
                decode_kv_lens=[len(reqs[i][0]) + reqs[i][1] // 2
                                for i in range(4)])


# -- phase 4: kernel engine == plain engine ----------------------------------
def engine_tokens(params, cfg, prompts, **kw):
    from paddle_tpu_torch.inference.paged import ServingEngine
    eng = ServingEngine(params, cfg, num_slots=3, page_size=16,
                        num_pages=160, max_pages_per_seq=32,
                        prompt_bucket=32, decode_horizon=8,
                        prefill_chunk=128, device="cuda", **kw)
    rids = [eng.submit(p, max_new_tokens=24) for p in prompts]
    done = eng.run()
    eng.check_invariants()
    return [list(done[i].generated) for i in rids], eng.stats()


def phase_engine(pa, cfg7b):
    from paddle_tpu_torch.models.llama import init_llama_params

    cfg = dataclasses.replace(cfg7b, num_hidden_layers=2)
    ep, bp, hp = init_llama_params(cfg, dtype=torch.float32, device="cuda",
                                   seed=1)
    bp = {k: (v * 0.15 if k.startswith("w") else v) for k, v in bp.items()}
    hp = dict(hp, lm=(ep["tok"].T * 4.0).contiguous())
    r = np.random.default_rng(2)
    prefix = r.integers(1, cfg.vocab_size, 160)
    prompts = [r.integers(1, cfg.vocab_size, n) for n in (20, 300, 75)]
    prompts += [np.concatenate([prefix, r.integers(1, cfg.vocab_size, n)])
                for n in (10, 40)]
    prompts.insert(1, prefix)
    for kv_dtype in (None, "int8", "fp8"):
        reset_counts(pa)
        kern, st = engine_tokens((ep, bp, hp), cfg, prompts,
                                 kv_dtype=kv_dtype)
        used = counts(pa)
        plain, _ = engine_tokens((ep, bp, hp), cfg, prompts,
                                 kv_dtype=kv_dtype, attention_impl="ref")
        require(used[0 if kv_dtype is None else 1] > 0 and used[2] == 0,
                f"engine check [{kv_dtype}]: kernel launches / plain calls "
                f"{used}")
        require(st["cache_hits"] >= 1,
                "engine check: the shared prefix hit the cache")
        print(f"  2-layer f32 engine at 7B widths, {kv_dtype or 'f32'} "
              f"pages: {len(prompts)} requests x 24 greedy tokens, kernel "
              f"== plain: {kern == plain}")
        require(kern == plain, f"greedy tokens differ between kernel and "
                f"plain version [{kv_dtype}]")
    # speculative=4 against no speculation, both through the quantized
    # kernel, on the successor model with prompts holding its path
    ep, bp, hp = init_llama_params(cfg, dtype=torch.float32, device="cuda",
                                   seed=3)
    succ = successor_model((ep, bp, hp), seed=4)
    prompts = []
    for n, stretch in ((40, 12), (300, 30), (75, 20), (20, 6)):
        x = int(r.integers(1, cfg.vocab_size))
        prompts.append(np.concatenate([
            r.integers(1, cfg.vocab_size, n - stretch - 5),
            path(succ, x, stretch), r.integers(1, cfg.vocab_size, 4), [x]]))
    spec, st = engine_tokens((ep, bp, hp), cfg, prompts, kv_dtype="int8",
                             speculative=4)
    nospec, _ = engine_tokens((ep, bp, hp), cfg, prompts, kv_dtype="int8")
    print(f"  speculative=4 vs none, int8 pages, through the kernel: "
          f"{st['verify_steps']} verify steps, drafts {st['draft_tokens_accepted']}"
          f"/{st['draft_tokens_proposed']} accepted, same tokens: "
          f"{spec == nospec}")
    require(st["verify_steps"] > 0, "engine check: no verify step ran")
    require(spec == nospec, "speculative decoding changed greedy tokens")
    require(all(t == path(succ, succ[p[-1]], 24)
                for p, t in zip(prompts, spec)),
            "engine check: tokens leave the successor model's path")


# -- phase 5: timing ---------------------------------------------------------
def time_ms(fn, iters, warmup=3):
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound(q_len, q_start, kv_len, Hq, Hkv, D, ps, elt, flop_rate,
          kv_dtype=None):
    """Least time for the work these inputs need: each input byte read once
    (q rows, the K/V rows the segments can see — with one f32 scale per row
    on quantized pages — their page-table entries, the descriptors), each
    output byte written once; QK^T and PV at 2 operations per multiply-add
    over the visible (query, key) pairs."""
    rows_visible = sum(
        min(kl, qs + j + 1) for qs, ql, kl in zip(q_start, q_len, kv_len)
        for j in range(ql))
    kv_tokens = sum(min(kl, qs + ql) if ql else 0
                    for qs, ql, kl in zip(q_start, q_len, kv_len))
    n_q = sum(q_len)
    row_bytes = D * elt if kv_dtype is None else D + 4
    nbytes = (2 * n_q * Hq * D * elt                  # q read, out written
              + 2 * kv_tokens * Hkv * row_bytes       # K and V read
              + 4 * sum(-(-kl // ps) for kl in kv_len)  # page-table rows
              + 3 * 4 * len(kv_len))
    flops = 4 * D * Hq * rows_visible
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def time_shape(pa, gen, sh, kv_dtype):
    """Kernel and plain-version ms at one segment shape (bf16 q, 32 heads,
    D = 128, page 16), rotating over 4 page pools (> the 50 MB L2)."""
    from paddle_tpu_torch.serving.quant import kv_spec, quantize_kv
    dt, Hq, Hkv, D, ps = torch.bfloat16, 32, 32, 128, 16
    S, Qmax = sh["S"], sh["Qmax"]
    P = max(-(-k // ps) for k in sh["kv_len"])
    NP = S * P
    n_copies = 4
    q = torch.randn(S, Qmax, Hq, D, generator=gen, device="cuda").to(dt)
    pools = []
    for _ in range(n_copies):
        kv = [torch.randn(Hkv, NP, ps, D, generator=gen, device="cuda")
              for _ in range(2)]
        if kv_dtype is None:
            pools.append(([t.to(dt) for t in kv], {}))
        else:
            sd, qmax = kv_spec(kv_dtype)
            (kq, ks), (vq, vs) = (quantize_kv(t, qmax=qmax, dtype=sd)
                                  for t in kv)
            pools.append(([kq, vq], dict(k_scales=ks, v_scales=vs)))
    pt = torch.randperm(NP, generator=gen, device="cuda") \
        .to(torch.int32).reshape(S, P)
    seg = [torch.tensor(sh[k], dtype=torch.int32, device="cuda")
           for k in ("q_start", "q_len", "kv_len")]

    def kern(i):
        (k, v), sc = pools[i % n_copies]
        pa.ragged_paged_attention(q, k, v, pt, *seg, **sc)

    def plain(i):
        (k, v), sc = pools[i % n_copies]
        pa.ragged_paged_attention_ref(q, k, v, pt, *seg, **sc)

    ms = time_ms(kern, 200)
    plain_ms = time_ms(plain, 20)
    b_ms, b_by, nbytes, flops = bound(sh["q_len"], sh["q_start"],
                                      sh["kv_len"], Hq, Hkv, D, ps, 2,
                                      BF16_FLOP_PER_S, kv_dtype)
    print(f"  {kv_dtype or 'bf16':<5} {sh['name']:<6} S={S} Qmax={Qmax} "
          f"kv_len={sh['kv_len']}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP), "
          f"{b_ms / ms * 100:.1f}% of bound; library_ms null")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def shapes(kv_lens):
    """The decode, verify (q_len = 5) and chunk segments of a phase-3 run
    whose first four requests sit at kv_lens."""
    return [dict(name="decode", S=4, Qmax=1, q_start=[k - 1 for k in kv_lens],
                 q_len=[1] * 4, kv_len=list(kv_lens)),
            dict(name="verify", S=4, Qmax=5, q_start=[k - 5 for k in kv_lens],
                 q_len=[5] * 4, kv_len=list(kv_lens)),
            dict(name="chunk", S=1, Qmax=256, q_start=[256], q_len=[256],
                 kv_len=[512])]


def phase_timing(pa, layers, plain_kv, quant_kv):
    """Row 1 at phase 3a's decode and chunk shapes (and the verify shape of
    phase 3b's lengths), row 2 over int8 pages at phase 3b's decode, verify
    and chunk shapes, and over fp8 pages at its decode shape."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    plain_shapes = shapes(plain_kv)
    res = {"plain": {}, "quant": {}}
    for sh in (plain_shapes[0], shapes(quant_kv)[1], plain_shapes[2]):
        res["plain"][sh["name"]] = time_shape(pa, gen, sh, None)
    for sh in shapes(quant_kv):
        res["quant"][sh["name"]] = time_shape(pa, gen, sh, "int8")
    time_shape(pa, gen, shapes(quant_kv)[0], "fp8")
    print(f"  launches: {layers} per decode step, per verify step and per "
          f"prefill chunk (one per layer), of row 1 on an f32/bf16 store "
          f"and of row 2 on an int8/fp8 store")
    print("  library_ms is null: no single PyTorch call attends over a paged,"
          " ragged KV cache (SDPA needs the pages gathered dense first)")
    return res


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is visible")
    from paddle_tpu_torch.models.llama import (init_llama_params,
                                               llama_config_7b)
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import paged_attention as pa

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; {card}")

    print("phase 1: build")
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s")

    print("phase 2: kernels vs plain version on the card")
    max_err = phase_kernel(pa)

    print("phase 3a: serving at LLaMA-2 7B widths (bf16 KV, 32 layers)")
    cfg = llama_config_7b()
    t0 = time.perf_counter()
    params = init_llama_params(cfg, dtype=torch.bfloat16, device="cuda",
                               seed=0)
    torch.cuda.synchronize()
    print(f"  random weights on the card in {time.perf_counter() - t0:.1f} s")
    serve = phase_serving(pa, cfg, params)
    print("phase 3b: serving at LLaMA-2 7B widths (int8 KV, speculative=4, "
          "32 layers)")
    serve_q = phase_serving_quant(pa, cfg, params, serve["kv_bytes"])
    del params
    torch.cuda.empty_cache()

    print("phase 4: engine checks, kernels vs plain version")
    phase_engine(pa, cfg)

    print("phase 5: kernel timing at the phase-3 shapes")
    timing = phase_timing(pa, cfg.num_hidden_layers,
                          serve["decode_kv_lens"], serve_q["decode_kv_lens"])

    print("phase 6: summary")
    for name, sv in (("bf16 KV", serve), ("int8 KV + speculative=4", serve_q)):
        print(f"  serving, {name}: {sv['tokens_per_s']:.1f} tokens/s, TTFT "
              f"p50 {sv['ttft_p50_ms']:.1f} ms, p95 {sv['ttft_p95_ms']:.1f} "
              f"ms on {card}")
    print(f"  draft acceptance {serve_q['acceptance']:.3f}")
    print(f"  total wall time {time.perf_counter() - t_start:.1f} s")
    rows = []
    for meta, key, launches in ((PLAIN, "plain", serve["launches"]),
                                (QUANT, "quant", serve_q["quant_launches"])):
        dec = timing[key]["decode"]
        rows.append(dict(meta, launches=launches, max_abs_err=max_err[key],
                         ms=dec["ms"], plain_ms=dec["plain_ms"],
                         bound_ms=dec["bound_ms"], bound_by=dec["bound_by"],
                         library_ms=None))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
