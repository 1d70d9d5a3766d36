"""LLaMA train and paged-KV serving functions (port of
``paddle_tpu.models.llama``: ``build_functional_llama`` and
``build_llama_paged_decode``).

Parameters are the JAX package's ``(embed, block, head)`` dicts with the
same leaf names — ``tok``; ``ln1 wq wk wv wo ln2 wgate wup wdown`` stacked
``[L, ...]``; ``ln_f lm`` — and weights stored ``[in, out]`` (``x @ W``), so
converting weights is a plain per-leaf copy (``models.convert``).  The
JAX ``lax.scan`` over layers is a Python loop over ``l`` here, and the page
pool is updated IN PLACE where the JAX functions donated and rebound it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..nn.functional.norm import rms_norm_ref
from ..ops.paged_attention import (_byte_view, ragged_paged_attention,
                                   ragged_paged_attention_ref)
from ..serving.quant import dequantize_kv, kv_spec, quantize_kv
from ..tensor.search import _top_p_mask

__all__ = ["LlamaConfig", "llama_config_7b", "llama_config_tiny",
           "init_llama_params", "build_functional_llama",
           "build_llama_paged_decode", "make_paged_decode_horizon",
           "gather_kv_pages", "scatter_kv_pages"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0


def llama_config_7b():
    return LlamaConfig()


def llama_config_tiny(vocab=1024, hidden=128, layers=2, heads=4, seq=128):
    return LlamaConfig(vocab_size=vocab, hidden_size=hidden,
                       intermediate_size=hidden * 3, num_hidden_layers=layers,
                       num_attention_heads=heads, num_key_value_heads=heads,
                       max_position_embeddings=seq)


def _rope_tables(seq_len, head_dim, theta, dtype=torch.float32, device=None):
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(pos, inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.sin().to(dtype), emb.cos().to(dtype)


def init_llama_params(config: LlamaConfig, dtype=torch.float32, device=None,
                      seed: int = 0):
    """Random dense parameters with the shapes and scales of the JAX
    ``build_functional_llama`` initialiser (normal / sqrt(fan_in) for block
    weights, 0.02 for the embedding and LM head, ones for the norms), drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (``None``: the CUDA device, raising without one).  Each layer is drawn
    and cast on its own, so a 7B model never holds a second f32 copy of its
    weights."""
    c = config
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    head_dim = c.hidden_size // c.num_attention_heads
    kv_dim = c.num_key_value_heads * head_dim
    L, H, I = c.num_hidden_layers, c.hidden_size, c.intermediate_size

    def draw(shape, scale=None):
        scale = 1.0 / math.sqrt(shape[0]) if scale is None else scale
        return (torch.randn(shape, generator=gen, device=dev) * scale) \
            .to(dtype)

    def stacked(shape):
        out = torch.empty((L,) + shape, dtype=dtype, device=dev)
        for i in range(L):
            out[i] = draw(shape)
        return out

    ep = {"tok": draw((c.vocab_size, H), 0.02)}
    bp = {"ln1": torch.ones((L, H), dtype=dtype, device=dev),
          "wq": stacked((H, H)), "wk": stacked((H, kv_dim)),
          "wv": stacked((H, kv_dim)), "wo": stacked((H, H)),
          "ln2": torch.ones((L, H), dtype=dtype, device=dev),
          "wgate": stacked((H, I)), "wup": stacked((H, I)),
          "wdown": stacked((I, H))}
    hp = {"ln_f": torch.ones((H,), dtype=dtype, device=dev),
          "lm": draw((H, c.vocab_size), 0.02)}
    return ep, bp, hp


def _apply_rope(x, sin, cos):
    # x: [B, S, H, D]; sin/cos: [S, D]
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[None, :, None, :] + rot * sin[None, :, None, :]


def build_functional_llama(config: LlamaConfig, dtype=None, n_micro: int = 1,
                           mp_axis: str = None, ep_axis: str = None,
                           init_params: bool = True, head_chunks: int = 0,
                           device=None, seed: int = 0, kernels: bool = True):
    """The train path's functions; returns ``(embed_params,
    block_params_stacked, head_params, embed_apply, block_apply,
    head_loss_apply)`` like the JAX function, with parameters from
    :func:`init_llama_params` (seeded ``torch.Generator``; ``None`` each
    when ``init_params`` is False).

      x = embed_apply(ep, (ids, labels))       [n_micro, B / n_micro, S, H]
      x = block_apply(lp, x_mb)                one layer, lp = {k: v[l]}
      loss = head_loss_apply(hp, y, batch)     mean NLL, f32 scalar

    Each block runs RMSNorm, QKV, RoPE, causal (GQA) attention, wo,
    RMSNorm and a SwiGLU MLP; the head runs RMSNorm and the LM head, dense
    or (``head_chunks`` > 0) vocab-chunked so the [T, V] logits never
    exist.  With ``kernels`` (the counterpart of the JAX flag
    ``use_pallas_kernels``) attention and RMSNorm go through
    :func:`~paddle_tpu_torch.ops.flash_attention.flash_attention` and
    :func:`~paddle_tpu_torch.ops.fused.rms_norm` — the CUDA kernels for
    CUDA tensors, their plain versions for CPU tensors — and fall back to
    plain attention / ``rms_norm_ref`` on the shapes those decline, as the
    JAX dispatch does; ``kernels=False`` runs plain attention and
    ``rms_norm_ref`` under autograd everywhere.  ``device=None`` means the
    CUDA device and raises without one.  Tensor / expert parallelism
    (``mp_axis``, ``ep_axis``) and MoE blocks are not ported yet."""
    if mp_axis is not None or ep_axis is not None \
            or getattr(config, "num_experts", 1) > 1:
        raise NotImplementedError(
            "build_functional_llama: tensor/expert parallelism and MoE "
            "blocks are not ported yet")
    from ..incubate.nn.functional import fused_linear_cross_entropy_impl
    from ..ops.flash_attention import flash_attention
    from ..ops.fused import rms_norm

    c = config
    d = torch.float32 if dtype is None else dtype
    dev = resolve_device(device)
    head_dim = c.hidden_size // c.num_attention_heads
    eps = c.rms_norm_eps
    if init_params:
        ep, bp, hp = init_llama_params(c, dtype=d, device=dev, seed=seed)
    else:
        ep = bp = hp = None
    sin_t, cos_t = _rope_tables(c.max_position_embeddings, head_dim,
                                c.rope_theta, d, dev)

    def rms(x, w):
        if kernels:
            out = rms_norm(x, w, eps)
            if out is not None:
                return out
        return rms_norm_ref(x, w, eps)

    def embed_apply(p, batch):
        ids, _ = batch
        x = p["tok"][ids.long()]
        mbs = x.shape[0] // n_micro
        return x.reshape((n_micro, mbs) + tuple(x.shape[1:]))

    def block_apply(lp, x):
        B, S, _ = x.shape
        nh = lp["wq"].shape[-1] // head_dim
        nkv = lp["wk"].shape[-1] // head_dim
        h = rms(x, lp["ln1"])
        q = (h @ lp["wq"]).reshape(B, S, nh, head_dim)
        k = (h @ lp["wk"]).reshape(B, S, nkv, head_dim)
        v = (h @ lp["wv"]).reshape(B, S, nkv, head_dim)
        sin, cos = sin_t[:S], cos_t[:S]
        q = _apply_rope(q, sin, cos)
        k = _apply_rope(k, sin, cos)
        # GQA: the kernel indexes KV heads natively; only the plain
        # fallback repeats them
        o = flash_attention(q, k, v, causal=True) if kernels else None
        if o is None:
            if nh != nkv:
                k = k.repeat_interleave(nh // nkv, dim=2)
                v = v.repeat_interleave(nh // nkv, dim=2)
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) \
                / math.sqrt(head_dim)
            mask = torch.ones((S, S), dtype=torch.bool, device=x.device) \
                .tril()
            logits = logits.float().masked_fill(~mask, float("-inf"))
            w = torch.softmax(logits, dim=-1).to(x.dtype)
            o = torch.einsum("bhqk,bkhd->bqhd", w, v)
        x = x + o.reshape(B, S, nh * head_dim) @ lp["wo"]
        h = rms(x, lp["ln2"])
        ff = F.silu(h @ lp["wgate"]) * (h @ lp["wup"])
        return x + ff @ lp["wdown"]

    def head_loss_apply(p, y, batch):
        # y: [n_micro, mbs, S, H]
        _, labels = batch
        lab = labels.reshape(-1).long()
        h = rms(y, p["ln_f"])
        if head_chunks:
            return fused_linear_cross_entropy_impl(
                h.reshape(-1, c.hidden_size), p["lm"], lab,
                n_chunks=head_chunks).mean()
        logp = torch.log_softmax((h @ p["lm"]).float(), dim=-1)
        return -logp.reshape(-1, c.vocab_size).gather(1, lab[:, None]).mean()

    return ep, bp, hp, embed_apply, block_apply, head_loss_apply


def gather_kv_pages(store, idx):
    """Pages ``idx`` of one side of the paged-KV store (a raw tensor or a
    quantized ``{"q", "s"}`` dict alike), in ``idx`` order.  The page axis
    is axis 2 of the ``[L, Hkv, NP + 1, ps, D]`` data planes and of the
    ``[L, Hkv, NP + 1, ps]`` scale planes; snapshot, restore and the KV
    handoff all move pages through this function and
    :func:`scatter_kv_pages`."""
    if isinstance(store, dict):
        return {k: v[:, :, idx] for k, v in store.items()}
    return store[:, :, idx]


def scatter_kv_pages(store, ids, planes):
    """Write ``planes`` (a :func:`gather_kv_pages` result, same page order)
    into the store at page ids ``ids`` IN PLACE (``index_copy_`` into the
    existing tensors, whose addresses captured CUDA graphs hold; the JAX
    function returned a new store).  A quantized store takes its codes and
    scales together.  A plane whose dtype differs from its tensor's but has
    the same item size (fp8 codes as uint8, bf16 as int16) is taken as that
    tensor's bits; any other plane is cast.  Returns ``store``."""
    if isinstance(store, dict):
        for k, leaf in store.items():
            _copy_pages(leaf, ids, planes[k])
    else:
        _copy_pages(store, ids, planes)
    return store


def _copy_pages(leaf, ids, plane):
    a = np.asarray(plane)
    if a.dtype.kind not in "biuf":            # ml_dtypes float8 / bfloat16
        a = a.view({1: np.uint8, 2: np.int16}[a.dtype.itemsize])
    t = torch.from_numpy(np.array(a)).to(leaf.device)
    if t.dtype != leaf.dtype:
        t = t.view(leaf.dtype) if not t.is_floating_point() \
            and t.element_size() == leaf.element_size() else t.to(leaf.dtype)
    idx = torch.as_tensor(ids, dtype=torch.long, device=leaf.device)
    _byte_view(leaf).index_copy_(2, idx, _byte_view(t))


def build_llama_paged_decode(config: LlamaConfig, page_size: int = 16,
                             num_pages: int = 64, dtype=None,
                             attention_impl: str = "auto", device=None,
                             kv_dtype=None):
    """Paged-KV serving functions; returns
    ``(init_pages, prefill, prefill_chunk, decode_step, verify_step)``.

      pages = init_pages()
          {"k","v": [L, Hkv, num_pages + 1, page_size, head_dim]} — the last
          page is the TRASH page inactive lanes and padding write into.
          With ``kv_dtype`` ("int8" / "fp8") each side is a dict
          {"q": codes [L, Hkv, NP + 1, ps, D] int8 | float8_e4m3fn,
           "s": scales [L, Hkv, NP + 1, ps] f32}.

      logits, pages_k, pages_v = prefill(params, ids, true_len, page_row,
                                         pages_k, pages_v)
          Dense causal prefill of the right-padded prompt ``ids [1, T_pad]``
          (``true_len`` real tokens, ``page_row [P]`` its page table);
          post-RoPE K/V scatter into the pages; logits [vocab] (f32) of the
          last real token.  A quantized store attends over the dequantized
          round trip of its own K/V, as a chunk reading them back would.

      logits, greedy_tok, pages_k, pages_v = prefill_chunk(
              params, ids, start, chunk_len, page_row, pages_k, pages_v)
          Chunked / suffix prefill: ``ids [1, C_pad]`` holds the prompt's
          tokens ``start .. start + chunk_len - 1``; their K/V land at those
          positions, then the chunk attends as ONE ragged query segment of
          the paged-attention kernel.  Also returns the argmax token.

      logits, pages_k, pages_v = decode_step(params, toks, lengths,
                                             page_tables, pages_k, pages_v,
                                             active)
          One token per slot at position ``lengths[s]``; inactive slots
          write the trash page and return logits the engine discards.

      logits0, greedy, pages_k, pages_v = verify_step(
              params, toks, lengths, page_tables, pages_k, pages_v, n_q)
          Speculative verify: ``toks [S, K+1]`` holds each slot's pending
          token and its drafts, ``n_q [S]`` the valid queries (0 = idle
          slot).  Valid queries scatter their K/V at ``lengths[s] + i`` and
          each slot attends as one ragged segment of ``q_len = n_q[s]``.
          Returns the position-0 logits [S, vocab] f32 and the argmax of
          every position [S, K+1] int32.  K/V written for drafts the engine
          then rejects sits at or past the rewound length, where every
          attention path masks it until a later write replaces it.

    The page tensors are updated IN PLACE (the JAX functions donated and
    rebound them) and returned for symmetry with the JAX signatures.
    Decode, verify and chunked prefill all attend through
    :func:`~paddle_tpu_torch.ops.paged_attention.ragged_paged_attention`
    (``attention_impl`` "auto" or "kernel": the CUDA kernel for CUDA
    tensors — the fused-dequant one on a quantized store — its plain
    version for CPU tensors) or always through the plain version
    (``"ref"``).  The dense prefill masks with -inf, the paged kernel and
    its plain version with NEG_INF = -1e30, as in JAX.  ``device=None``
    means the CUDA device and raises without one.

    Every gather whose result the JAX code masks afterwards is clamped
    here: JAX clips or fills an out-of-range index where torch raises, and
    the rows it touches (padding positions) go only to the trash page."""
    if attention_impl not in ("auto", "kernel", "ref"):
        raise ValueError(f"attention_impl must be auto, kernel or ref, "
                         f"got {attention_impl!r}")
    attend = ragged_paged_attention_ref if attention_impl == "ref" \
        else ragged_paged_attention
    c = config
    d = torch.float32 if dtype is None else dtype
    dev = resolve_device(device)
    if kv_dtype is not None:
        kv_storage, kv_qmax = kv_spec(kv_dtype)
    head_dim = c.hidden_size // c.num_attention_heads
    L = c.num_hidden_layers
    nkv = c.num_key_value_heads
    nh = c.num_attention_heads
    rep = nh // nkv
    eps = c.rms_norm_eps
    max_pos = c.max_position_embeddings
    TRASH = num_pages
    sin_t, cos_t = _rope_tables(max_pos, head_dim, c.rope_theta, d, dev)

    def init_pages():
        shape = (L, nkv, num_pages + 1, page_size, head_dim)
        if kv_dtype is None:
            return {"k": torch.zeros(shape, dtype=d, device=dev),
                    "v": torch.zeros(shape, dtype=d, device=dev)}

        def side():
            # zero bytes are the zero code of both int8 and e4m3
            return {"q": torch.zeros(shape, dtype=torch.uint8, device=dev)
                    .view(kv_storage),
                    "s": torch.zeros(shape[:-1], dtype=torch.float32,
                                     device=dev)}
        return {"k": side(), "v": side()}

    def _rope_at(x, sin_p, cos_p):
        # x: [..., H, D]; sin_p/cos_p: [..., D] per-row positions
        half = x.shape[-1] // 2
        rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
        return x * cos_p[..., None, :] + rot * sin_p[..., None, :]

    def _head(hp, h_last):
        h = rms_norm_ref(h_last, hp["ln_f"], eps)
        return (h @ hp["lm"]).float()

    def _qkv(x, lp, sin, cos):
        lead = x.shape[:-1]
        h = rms_norm_ref(x, lp["ln1"], eps)
        q = (h @ lp["wq"]).reshape(*lead, nh, head_dim)
        k = (h @ lp["wk"]).reshape(*lead, nkv, head_dim)
        v = (h @ lp["wv"]).reshape(*lead, nkv, head_dim)
        return _rope_at(q, sin, cos), _rope_at(k, sin, cos), v

    def _mlp(x, lp):
        h = rms_norm_ref(x, lp["ln2"], eps)
        ff = F.silu(h @ lp["wgate"]) * (h @ lp["wup"])
        return x + ff @ lp["wdown"]

    def _scatter(store_l, vals, page, off):
        """Write rows ``vals [..., Hkv, D]`` into the layer's store at
        ``[:, page, off]`` (``page``/``off`` of vals' leading shape);
        returns what a later gather will read back: ``vals`` on an f32/bf16
        store, the dequantized round trip in the compute dtype on a
        quantized one."""
        if kv_dtype is None:
            store_l[:, page, off] = vals.to(d).movedim(-2, 0)
            return vals
        codes, scales = quantize_kv(vals, qmax=kv_qmax, dtype=kv_storage)
        _byte_view(store_l["q"])[:, page, off] = \
            _byte_view(codes).movedim(-2, 0)
        store_l["s"][:, page, off] = scales.movedim(-1, 0)
        return dequantize_kv(codes, scales).to(d)

    def _layer(bp, pages_k, pages_v, l):
        lp = {k: v[l] for k, v in bp.items()}
        if kv_dtype is None:
            return lp, pages_k[l], pages_v[l]
        return (lp, {k: v[l] for k, v in pages_k.items()},
                {k: v[l] for k, v in pages_v.items()})

    def _attn(q, kc_l, vc_l, tables, q_start, q_len, kv_len):
        # every paged path attends through this one call; a quantized
        # store passes its codes and scale pages straight through
        if kv_dtype is None:
            return attend(q.contiguous(), kc_l, vc_l, tables, q_start,
                          q_len, kv_len)
        return attend(q.contiguous(), kc_l["q"], vc_l["q"], tables, q_start,
                      q_len, kv_len, k_scales=kc_l["s"], v_scales=vc_l["s"])

    def prefill(params, ids, true_len, page_row, pages_k, pages_v):
        ep, bp, hp = params
        T = ids.shape[1]
        x = ep["tok"][ids[0].long()].to(d)                 # [T, H]
        t_idx = torch.arange(T, device=dev)
        valid = t_idx < true_len
        P = page_row.shape[0]
        page = torch.where(valid, page_row[(t_idx // page_size)
                                           .clamp(max=P - 1)].long(), TRASH)
        off = t_idx % page_size
        sin, cos = sin_t[:T], cos_t[:T]
        mask = (t_idx[None, :] <= t_idx[:, None]) & valid[None, :]
        for l in range(L):
            lp, kc_l, vc_l = _layer(bp, pages_k, pages_v, l)
            q, k, v = _qkv(x, lp, sin, cos)
            k = _scatter(kc_l, k, page, off)
            v = _scatter(vc_l, v, page, off)
            kf = k.repeat_interleave(rep, dim=1) if rep > 1 else k
            vf = v.repeat_interleave(rep, dim=1) if rep > 1 else v
            s = torch.einsum("qhd,khd->hqk", q.float(), kf.float()) \
                / math.sqrt(head_dim)
            s = s.masked_fill(~mask[None], float("-inf"))
            p = torch.softmax(s, dim=-1).to(x.dtype)
            o = torch.einsum("hqk,khd->qhd", p, vf)
            x = x + o.reshape(T, nh * head_dim) @ lp["wo"]
            x = _mlp(x, lp)
        return _head(hp, x[int(true_len) - 1]), pages_k, pages_v

    def prefill_chunk(params, ids, start, chunk_len, page_row, pages_k,
                      pages_v):
        ep, bp, hp = params
        C = ids.shape[1]
        x = ep["tok"][ids[0].long()].to(d)                 # [C, H]
        i_idx = torch.arange(C, device=dev)
        valid = i_idx < chunk_len
        pos = start + i_idx                                 # absolute
        P = page_row.shape[0]
        page = torch.where(valid, page_row[(pos // page_size)
                                           .clamp(max=P - 1)].long(), TRASH)
        off = pos % page_size
        # padded positions may run past the rope table (JAX fills them with
        # NaN); they only ever reach the trash page, so clamp instead
        pos_c = pos.clamp(max=max_pos - 1)
        sin, cos = sin_t[pos_c], cos_t[pos_c]
        start_r = torch.tensor([int(start)], dtype=torch.int32, device=dev)
        clen_r = torch.tensor([int(chunk_len)], dtype=torch.int32,
                              device=dev)
        kvlen_r = start_r + clen_r
        page_tab = page_row.to(torch.int32).reshape(1, -1).contiguous()
        for l in range(L):
            lp, kc_l, vc_l = _layer(bp, pages_k, pages_v, l)
            q, k, v = _qkv(x, lp, sin, cos)
            _scatter(kc_l, k, page, off)
            _scatter(vc_l, v, page, off)
            o = _attn(q[None], kc_l, vc_l, page_tab, start_r, clen_r,
                      kvlen_r)[0]
            x = x + o.reshape(C, nh * head_dim) @ lp["wo"]
            x = _mlp(x, lp)
        logits = _head(hp, x[int(chunk_len) - 1])
        return logits, torch.argmax(logits).to(torch.int32), pages_k, pages_v

    def decode_step(params, toks, lengths, page_tables, pages_k, pages_v,
                    active):
        ep, bp, hp = params
        S = toks.shape[0]
        P = page_tables.shape[1]
        x = ep["tok"][toks.long()].to(d)                   # [S, H]
        pos = torch.where(active, lengths, torch.zeros_like(lengths)).long()
        page = torch.where(
            active,
            torch.gather(page_tables, 1, (pos // page_size)
                         .clamp(max=P - 1)[:, None])[:, 0].long(), TRASH)
        off = pos % page_size
        eff_len = torch.where(active, lengths + 1, torch.zeros_like(lengths)) \
            .to(torch.int32)
        n_q = active.to(torch.int32)                       # q_len 1 or 0
        pos32 = pos.to(torch.int32)
        pos_c = pos.clamp(max=max_pos - 1)
        sin_p, cos_p = sin_t[pos_c], cos_t[pos_c]          # [S, D]
        tables = page_tables.to(torch.int32).contiguous()
        for l in range(L):
            lp, kc_l, vc_l = _layer(bp, pages_k, pages_v, l)
            q, k, v = _qkv(x, lp, sin_p, cos_p)
            _scatter(kc_l, k, page, off)
            _scatter(vc_l, v, page, off)
            o = _attn(q[:, None], kc_l, vc_l, tables, pos32, n_q,
                      eff_len)[:, 0]
            x = x + o.reshape(S, nh * head_dim) @ lp["wo"]
            x = _mlp(x, lp)
        return _head(hp, x), pages_k, pages_v

    def verify_step(params, toks, lengths, page_tables, pages_k, pages_v,
                    n_q):
        ep, bp, hp = params
        S, Q = toks.shape
        P = page_tables.shape[1]
        x = ep["tok"][toks.long()].to(d)                   # [S, Q, H]
        q_idx = torch.arange(Q, device=dev)
        valid = q_idx[None, :] < n_q[:, None]              # [S, Q]
        pos = lengths.long()[:, None] + q_idx[None, :]     # absolute
        # padding lanes may index past the page row and the rope table
        # (JAX clips); they only ever reach the trash page
        page = torch.where(valid, torch.gather(
            page_tables, 1, (pos // page_size).clamp(max=P - 1)).long(),
            TRASH)
        off = pos % page_size
        pos_c = pos.clamp(max=max_pos - 1)
        sin, cos = sin_t[pos_c], cos_t[pos_c]              # [S, Q, D]
        q_start = lengths.to(torch.int32).contiguous()
        q_len = n_q.to(torch.int32).contiguous()
        kv_len = q_start + q_len
        tables = page_tables.to(torch.int32).contiguous()
        for l in range(L):
            lp, kc_l, vc_l = _layer(bp, pages_k, pages_v, l)
            q, k, v = _qkv(x, lp, sin, cos)
            _scatter(kc_l, k, page, off)
            _scatter(vc_l, v, page, off)
            o = _attn(q, kc_l, vc_l, tables, q_start, q_len, kv_len)
            x = x + o.reshape(S, Q, nh * head_dim) @ lp["wo"]
            x = _mlp(x, lp)
        logits = _head(hp, x)                              # [S, Q, V] f32
        return (logits[:, 0], torch.argmax(logits, dim=-1).to(torch.int32),
                pages_k, pages_v)

    return init_pages, prefill, prefill_chunk, decode_step, verify_step


def _sample_per_request(logits, generator, temps, top_ps):
    """Per-request sampling: logits [S, V], temps / top_ps [S] -> token ids
    [S] int32.  ``temp <= 0`` rows decode greedily; the rest draw from the
    per-row nucleus (``tensor.search._top_p_mask``) by the Gumbel-max trick
    with noise from ``generator`` — the same distribution as the JAX
    version's ``jax.random.categorical``, not the same draws."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / temps.clamp(min=1e-6)[:, None]
    masked = _top_p_mask(scaled, top_ps)
    u = torch.rand(masked.shape, generator=generator, device=masked.device)
    u = u.clamp(min=torch.finfo(u.dtype).tiny)
    sampled = torch.argmax(masked - torch.log(-torch.log(u)), dim=-1) \
        .to(torch.int32)
    return torch.where(temps <= 0.0, greedy, sampled)


def make_paged_decode_horizon(decode_step, sample_fn=None):
    """The K-step decode loop with per-slot freeze (port of the JAX
    ``make_paged_decode_horizon``; a Python loop of K ``decode_step`` calls
    where JAX fused one ``fori_loop``).  Token feedback stays on the device:
    nothing in the loop reads back to the host.

    A slot freezes once it emits ``eos_ids[s]`` (where >= 0) or its
    ``remaining`` budget reaches zero; frozen slots echo ``eos_ids`` into
    ``out`` and stop advancing ``lengths``/``remaining``.  Inactive slots
    (``active`` False) are frozen for the whole horizon and their returned
    ``done`` is the ``done0`` passthrough.

    Returns ``horizon(params, toks, lengths, page_tables, pk, pv, active,
    generator, temps, top_ps, remaining, eos_ids, done0, *, K, greedy) ->
    (out [S, K], toks, lengths, remaining, done, pk, pv)``."""
    if sample_fn is None:
        sample_fn = _sample_per_request

    def horizon(params, toks, lengths, page_tables, pk, pv, active,
                generator, temps, top_ps, remaining, eos_ids, done0, *, K,
                greedy):
        S = toks.shape[0]
        out = torch.zeros((S, K), dtype=torch.int32, device=toks.device)
        done = ~active | done0
        rem = remaining
        for t in range(K):
            live = ~done
            logits, pk, pv = decode_step(params, toks, lengths, page_tables,
                                         pk, pv, live)
            if greedy:
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                tok = sample_fn(logits, generator, temps, top_ps)
            tok = torch.where(done, eos_ids, tok)
            out[:, t] = tok
            toks = tok
            lengths = lengths + live.to(lengths.dtype)
            rem = rem - live.to(rem.dtype)
            done = done | ((eos_ids >= 0) & (tok == eos_ids)) | (rem <= 0)
        done = torch.where(active, done, done0)
        return out, toks, lengths, rem, done, pk, pv

    return horizon
