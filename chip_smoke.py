"""Smoke run of paddle_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``paddle_tpu_torch/ops/csrc`` and drives
the port's main path — the paged continuous-batching LLaMA server — at the
full width of LLaMA-2 7B with random weights made from a seed:

  1. build     nvcc for every kernel source, all started together;
  2. kernel    ragged_paged_attention against its plain PyTorch version on
               the card: 7B decode, a 256-token prefill chunk over a cached
               prefix, GQA 16:4 at D = 64 / page 64, a ragged multi-query
               mix; f32 and bf16 inputs, bf16 and f32 outputs;
  3. serving   a bf16 ServingEngine at 7B widths (32 layers) serves 8
               requests in 4 slots: chunked prefill, a prefix-cache hit
               served by a suffix prefill, greedy decode; the kernel's
               launch counter must cover every layer of every decode step
               and the plain version must not run; then a decode step's
               wall time against its kernels' device time (torch.profiler);
  4. engine    a 2-layer f32 engine at 7B widths with margin-engineered
               weights gives the same greedy tokens with the kernel as with
               the plain version;
  5. timing    the kernel, its plain version and the bound (bytes over
               3.35 TB/s, operations over 989 TFLOP/s bf16) at the decode
               and chunk shapes of phase 3;
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
KERNEL_SOURCE = "paddle_tpu_torch/ops/csrc/ragged_paged_attention.cu"
TPU_KERNEL = "paddle_tpu/ops/pallas/paged_attention.py:180"


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


def compare(pa, name, args, out_dtype):
    got = pa.ragged_paged_attention(*args, out_dtype=out_dtype)
    want = pa.ragged_paged_attention_ref(*args, out_dtype=out_dtype)
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    atol, rtol = TOL[out_dtype]
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


def phase_kernel(pa):
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
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
        ("ragged multi-query q_len 0/1/3/5",
         dict(S=4, Qmax=5, Hq=32, Hkv=32, D=128, ps=16, NP=20, P=8,
              q_start=[10, 100, 63, 0], q_len=[0, 1, 3, 5],
              kv_len=[10, 101, 66, 5])),
    ]
    worst = 0.0
    for name, kw in cases:
        for dtype, out_dtype in ((torch.float32, torch.float32),
                                 (torch.bfloat16, torch.bfloat16),
                                 (torch.bfloat16, torch.float32)):
            args = make_case(gen, dtype=dtype, **kw)
            err = compare(pa, f"{name} [{str(dtype)[6:]}]", args, out_dtype)
            worst = max(worst, err)
    return worst


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
    init_pages, _, prefill_chunk, decode_step = build_llama_paged_decode(
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
    pa.ragged_paged_attention.launches = 0
    pa.ragged_paged_attention_ref.calls = 0
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.ragged_paged_attention.launches
    ref_calls = pa.ragged_paged_attention_ref.calls
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
    require(launches >= L * delta["decode_model_steps"] and launches > 0,
            f"kernel launches {launches} < layers x decode steps "
            f"{L} x {delta['decode_model_steps']}")
    require(ref_calls == 0, f"plain version ran {ref_calls} times")
    eng.check_invariants()

    n_tok = sum(len(r.generated) for r in out)
    ttft = np.array([r.ttft for r in out]) * 1e3
    print(f"  requests {len(out)} in 4 slots, tokens {n_tok}, wall "
          f"{wall:.3f} s, {n_tok / wall:.1f} tokens/s")
    print(f"  TTFT p50 {np.percentile(ttft, 50):.1f} ms, p95 "
          f"{np.percentile(ttft, 95):.1f} ms (all submitted at t=0)")
    print(f"  engine counters: {json.dumps(delta)}")
    print(f"  kernel launches {launches} (= {L} layers x "
          f"{delta['decode_model_steps']} decode steps + chunk layers), "
          f"plain-version calls {ref_calls}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB")
    decode_breakdown(eng, cfg)
    return dict(launches=launches, tokens=n_tok, wall_s=wall,
                tokens_per_s=n_tok / wall,
                ttft_p50_ms=float(np.percentile(ttft, 50)),
                ttft_p95_ms=float(np.percentile(ttft, 95)),
                decode_kv_lens=[len(reqs[i][0]) + reqs[i][1] // 2
                                for i in range(4)])


def decode_breakdown(eng, cfg, steps=2):
    """Where a decode step's time goes: four slots of 512-token contexts,
    pure decode horizons (K = 8 steps each) — first timed on the host
    clock, then the same number under torch.profiler for the device time
    of their kernels, split into the attention kernel, matrix products and
    the rest."""
    from torch.profiler import ProfilerActivity, profile

    r = np.random.default_rng(4)
    for _ in range(4):
        eng.submit(r.integers(1, cfg.vocab_size, 512),
                   max_new_tokens=1 + eng.decode_horizon * (2 * steps + 1))
    eng.step()                      # admissions + the first horizon
    torch.cuda.synchronize()
    n0 = eng.decode_model_steps
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = eng.decode_model_steps - n0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    require(eng.decode_model_steps - n0 == 2 * n,
            "the profiled window ran pure decode horizons")
    eng.run()
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
    busy = sum(groups.values())
    weights = sum(t.numel() * t.element_size()
                  for tree in eng.params for t in tree.values())
    per = {k: v / n for k, v in groups.items()}
    print(f"  decode step ({eng.num_slots} slots, 512-token contexts): wall "
          f"{wall / n * 1e3:.2f} ms unprofiled, device busy {busy / n:.2f} "
          f"ms ({busy / (wall * 1e3) * 100:.1f}%: attention "
          f"{per['attention']:.3f}, matmul {per['matmul']:.3f}, other "
          f"{per['other']:.3f} ms), {launches / n:.0f} kernels; weight "
          f"bytes bound {weights / HBM_BYTES_PER_S * 1e3:.2f} ms")


# -- phase 4: kernel engine == plain engine ----------------------------------
def phase_engine(cfg7b):
    from paddle_tpu_torch.inference.paged import ServingEngine
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
    outs = {}
    for impl in ("auto", "ref"):
        eng = ServingEngine((ep, bp, hp), cfg, num_slots=3, page_size=16,
                            num_pages=160, max_pages_per_seq=32,
                            attention_impl=impl, prompt_bucket=32,
                            decode_horizon=8, prefill_chunk=128,
                            device="cuda")
        rids = [eng.submit(p, max_new_tokens=24) for p in prompts]
        done = eng.run()
        outs[impl] = [list(done[i].generated) for i in rids]
        eng.check_invariants()
        if impl == "auto":
            require(eng.stats()["cache_hits"] >= 1,
                    "engine check: the shared prefix hit the cache")
    same = outs["auto"] == outs["ref"]
    print(f"  2-layer f32 engine at 7B widths: {len(prompts)} requests x 24 "
          f"greedy tokens, kernel == plain: {same}")
    require(same, "greedy tokens differ between kernel and plain version")


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


def bound(q_len, q_start, kv_len, Hq, Hkv, D, ps, elt, flop_rate):
    """Least time for the work these inputs need: each input byte read once
    (q rows, the K/V rows the segments can see, their page-table entries,
    the descriptors), each output byte written once; QK^T and PV at 2
    operations per multiply-add over the visible (query, key) pairs."""
    rows_visible = sum(
        min(kl, qs + j + 1) for qs, ql, kl in zip(q_start, q_len, kv_len)
        for j in range(ql))
    kv_tokens = sum(min(kl, qs + ql) if ql else 0
                    for qs, ql, kl in zip(q_start, q_len, kv_len))
    n_q = sum(q_len)
    nbytes = (2 * n_q * Hq * D * elt                  # q read, out written
              + 2 * kv_tokens * Hkv * D * elt         # K and V read
              + 4 * sum(-(-kl // ps) for kl in kv_len)  # page-table rows
              + 3 * 4 * len(kv_len))
    flops = 4 * D * Hq * rows_visible
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def phase_timing(pa, layers, decode_kv):
    gen = torch.Generator(device="cuda").manual_seed(5)
    dt, Hq, Hkv, D, ps = torch.bfloat16, 32, 32, 128, 16
    shapes = {
        "decode": dict(S=4, Qmax=1, q_start=[k - 1 for k in decode_kv],
                       q_len=[1] * 4, kv_len=decode_kv),
        "chunk": dict(S=1, Qmax=256, q_start=[256], q_len=[256],
                      kv_len=[512]),
    }
    res = {}
    for name, sh in shapes.items():
        S, Qmax = sh["S"], sh["Qmax"]
        P = max(-(-k // ps) for k in sh["kv_len"])
        NP = S * P
        n_copies = 4          # rotate over 4 page pools: > the 50 MB L2
        q = torch.randn(S, Qmax, Hq, D, generator=gen, device="cuda").to(dt)
        kc = torch.randn(n_copies, Hkv, NP, ps, D, generator=gen,
                         device="cuda").to(dt)
        vc = torch.randn(n_copies, Hkv, NP, ps, D, generator=gen,
                         device="cuda").to(dt)
        pt = torch.randperm(NP, generator=gen, device="cuda") \
            .to(torch.int32).reshape(S, P)
        seg = [torch.tensor(sh[k], dtype=torch.int32, device="cuda")
               for k in ("q_start", "q_len", "kv_len")]

        def kern(i):
            pa.ragged_paged_attention(q, kc[i % n_copies], vc[i % n_copies],
                                      pt, *seg)

        def plain(i):
            pa.ragged_paged_attention_ref(q, kc[i % n_copies],
                                          vc[i % n_copies], pt, *seg)

        ms = time_ms(kern, 200)
        plain_ms = time_ms(plain, 20)
        b_ms, b_by, nbytes, flops = bound(sh["q_len"], sh["q_start"],
                                          sh["kv_len"], Hq, Hkv, D, ps, 2,
                                          BF16_FLOP_PER_S)
        res[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by)
        print(f"  {name:<6} S={S} Qmax={Qmax} kv_len={sh['kv_len']} bf16: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.3f} GFLOP), {b_ms / ms * 100:.1f}% of bound; "
              f"library_ms null")
    print(f"  launches per decode step: {layers} (one per layer)")
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

    print("phase 2: kernel vs plain version on the card")
    max_err = phase_kernel(pa)

    print("phase 3: serving at LLaMA-2 7B widths (bf16, 32 layers)")
    cfg = llama_config_7b()
    t0 = time.perf_counter()
    params = init_llama_params(cfg, dtype=torch.bfloat16, device="cuda",
                               seed=0)
    torch.cuda.synchronize()
    print(f"  random weights on the card in {time.perf_counter() - t0:.1f} s")
    serve = phase_serving(pa, cfg, params)
    del params
    torch.cuda.empty_cache()

    print("phase 4: engine check, kernel vs plain version")
    phase_engine(cfg)

    print("phase 5: kernel timing at the phase-3 shapes")
    timing = phase_timing(pa, cfg.num_hidden_layers, serve["decode_kv_lens"])

    print("phase 6: summary")
    print(f"  serving: {serve['tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{serve['ttft_p50_ms']:.1f} ms, p95 {serve['ttft_p95_ms']:.1f} ms "
          f"on {card}")
    dec = timing["decode"]
    print(card)
    print(json.dumps({"kernels": [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
        "launches": serve["launches"], "max_abs_err": max_err,
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
