"""LLaMA train and paged-KV serving functions and the eager model (port of
``paddle_tpu.models.llama``: ``build_functional_llama``,
``build_llama_paged_decode``, ``LlamaForCausalLM`` and its layers), dense
or Mixtral-style MoE (``num_experts`` > 1).

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
           "init_llama_params", "llama_block_specs",
           "shard_llama_block_params", "build_functional_llama",
           "llama_microbatch_fns", "llama_paged_param_specs",
           "llama_paged_page_spec", "shard_llama_paged_params",
           "build_llama_paged_decode", "make_paged_decode_horizon",
           "gather_kv_pages", "scatter_kv_pages", "LlamaAttention",
           "LlamaMLP", "LlamaMoEBlock", "LlamaDecoderLayer", "LlamaModel",
           "LlamaForCausalLM", "functional_params_from_layer"]


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
    tie_word_embeddings: bool = False
    use_flash_attention: bool = True
    tensor_parallel_degree: int = 1
    dtype: str = "float32"
    # the MoE variant (LLaMA-MoE / Mixtral): num_experts > 1 swaps the
    # dense MLP for top-k routed SwiGLU experts
    num_experts: int = 1
    moe_topk: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_weight: float = 0.01


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
    """Random parameters with the shapes and scales of the JAX
    ``build_functional_llama`` initialiser (normal / sqrt(fan_in) for block
    weights, 0.02 for the embedding and LM head, ones for the norms), drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (``None``: the CUDA device, raising without one).  With
    ``num_experts`` > 1 the MLP leaves are JAX's expert stacks: ``gate_w``
    [L, H, E] at 0.02, ``we_gate`` / ``we_up`` [L, E, H, I] at 1 / sqrt(H)
    and ``we_down`` [L, E, I, H] at 1 / sqrt(I).  Each layer is drawn and
    cast on its own, so a 7B model never holds a second f32 copy of its
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

    def stacked(shape, scale=None):
        out = torch.empty((L,) + shape, dtype=dtype, device=dev)
        for i in range(L):
            out[i] = draw(shape, scale)
        return out

    ep = {"tok": draw((c.vocab_size, H), 0.02)}
    bp = {"ln1": torch.ones((L, H), dtype=dtype, device=dev),
          "wq": stacked((H, H)), "wk": stacked((H, kv_dim)),
          "wv": stacked((H, kv_dim)), "wo": stacked((H, H)),
          "ln2": torch.ones((L, H), dtype=dtype, device=dev)}
    if c.num_experts > 1:
        E = c.num_experts
        bp.update(gate_w=stacked((H, E), 0.02),
                  we_gate=stacked((E, H, I), 1.0 / math.sqrt(H)),
                  we_up=stacked((E, H, I), 1.0 / math.sqrt(H)),
                  we_down=stacked((E, I, H), 1.0 / math.sqrt(I)))
    else:
        bp.update(wgate=stacked((H, I)), wup=stacked((H, I)),
                  wdown=stacked((I, H)))
    hp = {"ln_f": torch.ones((H,), dtype=dtype, device=dev),
          "lm": draw((H, c.vocab_size), 0.02)}
    return ep, bp, hp


def _apply_rope(x, sin, cos):
    # x: [B, S, H, D]; sin/cos: [S, D]
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[None, :, None, :] + rot * sin[None, :, None, :]


def llama_block_specs(mp_axis: str = "mp", moe: bool = False,
                      ep_axis: str = None):
    """Per-leaf sharding of the block weights (the entries after the
    leading layer axis) for Megatron tensor parallelism over ``mp_axis``, as
    JAX's function gives them: ``wq wk wv wgate wup`` column-parallel
    (output axis split), ``wo wdown`` row-parallel (input axis split),
    ``ln1 ln2`` replicated.  With ``moe`` the MLP leaves are the expert
    stacks: ``gate_w`` replicated, ``we_gate we_up we_down`` split on their
    expert axis over ``ep_axis`` (expert parallelism)."""
    col = (None, mp_axis)
    row = (mp_axis, None)
    specs = {"ln1": (None,), "wq": col, "wk": col, "wv": col, "wo": row,
             "ln2": (None,)}
    if moe:
        exp = (ep_axis, None, None)
        specs.update({"gate_w": (None, None), "we_gate": exp, "we_up": exp,
                      "we_down": exp})
    else:
        specs.update({"wgate": col, "wup": col, "wdown": row})
    return specs


def shard_llama_block_params(bp, rank: int, size: int,
                             specs: dict = None, axis: str = None):
    """Rank ``rank``'s shards, of ``size``, of the stacked block weights
    ``bp`` per ``specs`` (:func:`llama_block_specs`): the column-parallel
    leaves cut on their last axis, the row-parallel ones on the first
    after the layer axis, the expert stacks on their expert axis; with
    ``axis``, only the leaves split over that mesh axis are cut.  The cut
    leaves are contiguous copies marked ``is_distributed``, the others
    pass as they are."""
    specs = llama_block_specs() if specs is None else specs
    out = {}
    for k, v in bp.items():
        entries = specs.get(k, ())
        axes = [i for i, e in enumerate(entries)
                if e is not None and (axis is None or e == axis)]
        if not axes or size == 1:
            out[k] = v
            continue
        dim = 1 + axes[0]
        if v.shape[dim] % size:
            raise ValueError(f"{k}: axis {dim} of {tuple(v.shape)} does not "
                             f"split over {size} ranks")
        w = v.shape[dim] // size
        t = v.detach().narrow(dim, rank * w, w).contiguous()
        t.is_distributed = True
        out[k] = t
    return out


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
    CUDA device and raises without one.

    With ``mp_axis`` the blocks are tensor-parallel over that axis of the
    default mesh (``distributed.topology``; this rank alone without one):
    the returned block parameters are this rank's shards
    (:func:`shard_llama_block_params` of the seed's full weights, so every
    mp size makes one model), head counts come from the local shapes, and
    each block issues the Megatron collectives — ``copy_to_group`` before
    the column-parallel products (its backward all-reduces the input's
    gradient, so the replicated norm weights get whole gradients) and
    ``reduce_from_group`` after ``wo`` and ``wdown`` (JAX's
    ``_mp_reduce``).  The embedding and the head stay replicated, as in
    JAX.  Requires heads and KV heads divisible by the mp size.

    With ``num_experts`` > 1 the MLP is JAX's ``_moe_ffn_block``: the gate
    ``gate_w`` routes each layer's T tokens top-``moe_topk`` into C =
    ``compute_capacity(T, E, k, moe_capacity_factor)`` slots an expert
    (``incubate.distributed.models.moe``; the dispatch and combine by slot
    index), and each expert is a SwiGLU of batched matmuls over the
    ``we_gate`` / ``we_up`` / ``we_down`` stacks.  The balance loss is
    dropped, as JAX drops it here (weight 0: the eager
    :class:`LlamaForCausalLM` trains it).  With ``ep_axis`` the experts are
    split over that axis of the default mesh: the returned stacks are this
    rank's experts (``shard_llama_block_params(axis=ep_axis)`` of the
    seed's full weights), the batch is this rank's, and the slots travel
    to their experts' ranks and back by :func:`~paddle_tpu_torch.incubate.
    distributed.models.moe.ep_all_to_all`, whose backward is the reverse
    all-to-all.  The MoE MLP has no mp collective (JAX's has none)."""
    from ..incubate.distributed.models.moe import gate as moe_gate
    from ..incubate.distributed.models.moe import moe_layer
    from ..incubate.nn.functional import fused_linear_cross_entropy_impl
    from ..ops.flash_attention import flash_attention
    from ..ops.fused import rms_norm

    c = config
    d = torch.float32 if dtype is None else dtype
    dev = resolve_device(device)
    head_dim = c.hidden_size // c.num_attention_heads
    eps = c.rms_norm_eps
    mp_group = None
    if mp_axis is not None:
        from ..distributed.topology import axis_group
        mp_group = axis_group(mp_axis)
        if c.num_attention_heads % mp_group.nranks \
                or c.num_key_value_heads % mp_group.nranks:
            raise ValueError(f"heads {c.num_attention_heads} / KV heads "
                             f"{c.num_key_value_heads} do not split over "
                             f"mp = {mp_group.nranks}")
    moe = c.num_experts > 1
    ep_group = None
    if ep_axis is not None:
        from ..distributed.topology import axis_group
        ep_group = axis_group(ep_axis)
        if c.num_experts % ep_group.nranks:
            raise ValueError(f"{c.num_experts} experts do not split over "
                             f"ep = {ep_group.nranks}")
    if init_params:
        ep, bp, hp = init_llama_params(c, dtype=d, device=dev, seed=seed)
        specs = llama_block_specs(mp_axis, moe=moe, ep_axis=ep_axis)
        for group, ax in ((mp_group, mp_axis), (ep_group, ep_axis)):
            if group is not None:
                bp = shard_llama_block_params(bp, max(group.rank, 0),
                                              group.nranks, specs, axis=ax)
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

    if mp_group is not None:
        from ..distributed.communication.differentiable import (
            copy_to_group, reduce_from_group)

        def mp_in(h):
            return copy_to_group(h, mp_group)

        def mp_out(y):
            return reduce_from_group(y, mp_group)
    else:
        def mp_in(h):
            return h
        mp_out = mp_in

    def block_apply(lp, x):
        B, S, _ = x.shape
        nh = lp["wq"].shape[-1] // head_dim
        nkv = lp["wk"].shape[-1] // head_dim
        h = mp_in(rms(x, lp["ln1"]))
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
        x = x + mp_out(o.reshape(B, S, nh * head_dim) @ lp["wo"])
        if moe:
            return x + moe_ffn_block(lp, rms(x, lp["ln2"]))
        h = mp_in(rms(x, lp["ln2"]))
        ff = F.silu(h @ lp["wgate"]) * (h @ lp["wup"])
        return x + mp_out(ff @ lp["wdown"])

    def moe_ffn_block(lp, h):
        """JAX's ``_moe_ffn_block`` on h [B, S, H]: the sparse SwiGLU over
        the expert stacks (this rank's under ``ep_axis``)."""
        B, S, _ = h.shape
        xf = h.reshape(B * S, -1)
        E = lp["gate_w"].shape[-1]
        logits = (xf @ lp["gate_w"].to(xf.dtype)).float()

        def swiglu(disp):
            ff = F.silu(torch.bmm(disp, lp["we_gate"].to(disp.dtype))) \
                * torch.bmm(disp, lp["we_up"].to(disp.dtype))
            return torch.bmm(ff, lp["we_down"].to(ff.dtype))
        out, _ = moe_layer.routed_ffn(
            xf, logits, swiglu, top_k=c.moe_topk,
            capacity=moe_gate.compute_capacity(B * S, E, c.moe_topk,
                                               c.moe_capacity_factor),
            ep_axis=ep_group, balance_loss_weight=0.0)
        return out.reshape(B, S, -1).to(h.dtype)

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


def llama_microbatch_fns(config: LlamaConfig, mp_axis: str = None,
                         dtype=None, ep_axis: str = None,
                         head_chunks: int = 0, device=None,
                         kernels: bool = True):
    """The per-microbatch (embed, block, head) functions of the pipeline
    steps (``parallel.Pipeline1F1BTrainStep``; JAX ``models/llama.py:324``),
    made by :func:`build_functional_llama` with ``init_params=False`` (no
    second parameter set): ``embed(ep, mb)`` gives one microbatch's ``[mbs,
    S, H]``, ``head(hp, y, mb)`` its mean loss on one activation.
    ``mp_axis``, ``dtype``, ``head_chunks``, ``device`` and ``kernels`` are
    :func:`build_functional_llama`'s, and so is ``ep_axis`` (the blocks'
    experts split over that axis)."""
    _, _, _, ea1, ba1, hl1 = build_functional_llama(
        config, dtype=dtype, n_micro=1, mp_axis=mp_axis, ep_axis=ep_axis,
        init_params=False,
        head_chunks=head_chunks, device=device, kernels=kernels)

    def embed_mb(p, mb):
        return ea1(p, mb)[0]

    def head_mb(p, y, mb):
        return hl1(p, y[None], mb)
    return embed_mb, ba1, head_mb


def llama_paged_param_specs(mp_axis: str = "mp"):
    """Per-leaf sharding of the paged-decode ``(ep, bp, hp)`` parameters
    under tensor parallelism over ``mp_axis`` (JAX
    ``llama_paged_param_specs``), in :func:`llama_block_specs`' style: the
    entries after the leading layer axis of each block leaf.  ``wq wk wv
    wgate wup`` column-parallel (heads / FFN columns split), ``wdown``
    row-parallel (its product gives the partial sums the layer's one
    all-reduce combines), ``wo`` REPLICATED (it multiplies the all-gathered
    head outputs, so its product equals one card's), the norms, ``tok``
    and ``lm`` replicated."""
    col = (None, mp_axis)
    rep2 = (None, None)
    bp = {"ln1": (None,), "wq": col, "wk": col, "wv": col, "wo": rep2,
          "ln2": (None,), "wgate": col, "wup": col,
          "wdown": (mp_axis, None)}
    return {"tok": rep2}, bp, {"ln_f": (None,), "lm": rep2}


def llama_paged_page_spec(mp_axis: str = "mp"):
    """The sharding of one side of the paged-KV store (JAX
    ``llama_paged_page_spec``): the KV-head axis, axis 1 of the ``[L, Hkv,
    NP + 1, ps, D]`` data pages and of the ``[L, Hkv, NP + 1, ps]`` scale
    pages, split over ``mp_axis``; one spec for the raw and the quantized
    store alike."""
    return (None, mp_axis)


def shard_llama_paged_params(params, rank: int, size: int):
    """Rank ``rank``'s shard, of ``size``, of the full paged-decode
    parameters ``(ep, bp, hp)`` per :func:`llama_paged_param_specs`:
    ``wq wk wv wgate wup`` cut into column blocks, ``wdown`` into row
    blocks, ``wo``, the norms, ``tok`` and ``lm`` passed as they are.  A
    rank's column block r holds heads ``r * nh / size ..``, the global head
    order the attention all-gather restores."""
    ep, bp, hp = params
    specs = llama_paged_param_specs()[1]
    return ep, shard_llama_block_params(bp, rank, size, specs), hp


def _mp_degree(mesh, mp_axis):
    """The size of ``mp_axis`` of ``mesh`` (1 without a mesh); raises where
    the mesh lacks the axis, as JAX's ``mesh.shape[mp_axis]`` does."""
    if mesh is None:
        return 1
    from ..distributed.topology import require_axis
    require_axis(mesh, mp_axis)
    return int(mesh.size(list(mesh.mesh_dim_names).index(mp_axis)))


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
                             kv_dtype=None, mesh=None, mp_axis: str = "mp",
                             quantized_allreduce: bool = False):
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
    the rows it touches (padding positions) go only to the trash page.

    ``mesh`` (tensor-parallel serving): a ``topology.build_mesh`` mesh whose
    ``mp_axis`` has tp > 1 ranks makes every function this rank's part of
    the head-sharded model.  The functions then take this rank's shard of
    the parameters (:func:`shard_llama_paged_params`; JAX's take the full
    parameters and ``shard_map`` cuts them), the pages hold this rank's
    ``Hkv / tp`` KV heads (``[L, Hkv / tp, NP + 1, ps, D]``, scale planes
    alike), and each layer pushes its local heads through the one ragged
    attention call, then pays two collectives over the axis's group
    (``topology.axis_group``): an all-gather of the heads' outputs in
    global head order before the replicated ``wo`` (exact: ``wo``'s
    product equals one card's), and the ONE all-reduce of the ``wdown``
    partials (the f32 sum, or the EQuARX int8 grid with
    ``quantized_allreduce``; ``distributed.quant_collectives``).  Logits
    come out replicated, so every rank samples the same greedy token.
    Requires tp | num_key_value_heads (hence tp | num_attention_heads);
    MoE blocks are not supported.  Every rank calls every function in the
    same order (the collectives pair up across ranks)."""
    if attention_impl not in ("auto", "kernel", "ref"):
        raise ValueError(f"attention_impl must be auto, kernel or ref, "
                         f"got {attention_impl!r}")
    attend = ragged_paged_attention_ref if attention_impl == "ref" \
        else ragged_paged_attention
    c = config
    tp = _mp_degree(mesh, mp_axis)
    if tp > 1:
        if getattr(c, "num_experts", 1) > 1:
            raise NotImplementedError(
                "tensor-parallel paged decode does not support MoE blocks")
        if c.num_key_value_heads % tp or c.num_attention_heads % tp:
            raise ValueError(
                f"mp={tp} must divide num_key_value_heads="
                f"{c.num_key_value_heads} (and num_attention_heads="
                f"{c.num_attention_heads}) to head-shard paged decode")
        from ..distributed.communication.collectives import all_gather
        from ..distributed.quant_collectives import allreduce
        from ..distributed.topology import axis_group
        group = axis_group(mp_axis, mesh)
    d = torch.float32 if dtype is None else dtype
    dev = resolve_device(device)
    if kv_dtype is not None:
        kv_storage, kv_qmax = kv_spec(kv_dtype)
    head_dim = c.hidden_size // c.num_attention_heads
    L = c.num_hidden_layers
    nh = c.num_attention_heads
    rep = nh // c.num_key_value_heads
    nkv = c.num_key_value_heads // tp          # this rank's heads
    nh_l = nh // tp
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
        q = (h @ lp["wq"]).reshape(*lead, nh_l, head_dim)
        k = (h @ lp["wk"]).reshape(*lead, nkv, head_dim)
        v = (h @ lp["wv"]).reshape(*lead, nkv, head_dim)
        return _rope_at(q, sin, cos), _rope_at(k, sin, cos), v

    def _out(o, lp):
        """The heads' outputs ``o [..., nh_l, D]`` through ``wo``: at tp > 1
        first all-gathered over the group into ``[..., nh, D]``, rank r's
        block r in global head order (JAX's ``_gather_heads``)."""
        if tp > 1:
            o = torch.cat(all_gather(None, o.contiguous(), group).unbind(0),
                          dim=-2)
        return o.reshape(*o.shape[:-2], nh * head_dim) @ lp["wo"]

    def _mlp(x, lp):
        h = rms_norm_ref(x, lp["ln2"], eps)
        ff = F.silu(h @ lp["wgate"]) * (h @ lp["wup"])
        y = ff @ lp["wdown"]
        if tp > 1:                 # the layer's one all-reduce
            y = allreduce(y, group, quantized=quantized_allreduce)
        return x + y

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
            x = x + _out(o, lp)
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
            x = x + _out(o, lp)
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
            x = x + _out(o, lp)
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
            x = x + _out(o, lp)
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


# -- the eager model ----------------------------------------------------------
class _Parts:
    """What every eager submodule needs at construction: the parameters'
    generator (seeded with ``seed``), the routing generator (random
    routing's draws, seeded from it apart from the parameters' stream),
    the dtype, the device and the kernels knob."""

    def __init__(self, c, dtype, device, seed, kernels):
        dev = resolve_device(device)
        if dtype is None:
            dtype = getattr(torch, str(c.dtype).replace("paddle.", ""))
        self.c, self.kernels, self.dtype, self.device = c, kernels, dtype, dev
        self.generator = torch.Generator(device=dev).manual_seed(int(seed))
        self.routing_generator = torch.Generator(device=dev).manual_seed(
            int(seed) + 1)
        self.mk = dict(dtype=dtype, device=dev, generator=self.generator)

    def linear(self, n_in, n_out):
        from ..nn.layers import Linear
        return Linear(n_in, n_out, bias=False, **self.mk)

    def parallel(self, kind, n_in, n_out):
        """A ``ColumnParallelLinear`` (``kind`` "col", output not gathered)
        or a ``RowParallelLinear`` ("row", input already split) without
        bias, its full weight drawn from a seed of this model's
        generator."""
        from ..distributed.fleet.meta_parallel import (ColumnParallelLinear,
                                                       RowParallelLinear)
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,),
                                 generator=self.generator,
                                 device=self.device))
        kw = dict(has_bias=False, dtype=self.dtype, device=self.device,
                  seed=seed)
        if kind == "col":
            return ColumnParallelLinear(n_in, n_out, gather_output=False,
                                        **kw)
        return RowParallelLinear(n_in, n_out, input_is_parallel=True, **kw)

    def norm(self):
        from ..nn.layers import RMSNorm
        return RMSNorm(self.c.hidden_size, self.c.rms_norm_eps,
                       dtype=self.dtype, device=self.device,
                       kernels=self.kernels)


class LlamaAttention(torch.nn.Module):
    """JAX ``LlamaAttention`` (``models/llama.py:86``): q / k / v / o
    projections without bias (column- / row-parallel over the ``mp`` group
    at ``tensor_parallel_degree`` > 1), RoPE, causal GQA attention through
    ``nn.functional.scaled_dot_product_attention`` (rows 3 / 5 / 6 on CUDA
    tensors when ``kernels`` and ``use_flash_attention``)."""

    def __init__(self, config: LlamaConfig, parts: _Parts):
        super().__init__()
        c = config
        self.num_heads = c.num_attention_heads
        self.num_kv = c.num_key_value_heads
        self.head_dim = c.hidden_size // c.num_attention_heads
        self.kernels = parts.kernels and c.use_flash_attention
        q_dim, kv_dim = self.num_heads * self.head_dim, \
            self.num_kv * self.head_dim
        if c.tensor_parallel_degree > 1:
            self.q_proj = parts.parallel("col", c.hidden_size, q_dim)
            self.k_proj = parts.parallel("col", c.hidden_size, kv_dim)
            self.v_proj = parts.parallel("col", c.hidden_size, kv_dim)
            self.o_proj = parts.parallel("row", q_dim, c.hidden_size)
        else:
            self.q_proj = parts.linear(c.hidden_size, q_dim)
            self.k_proj = parts.linear(c.hidden_size, kv_dim)
            self.v_proj = parts.linear(c.hidden_size, kv_dim)
            self.o_proj = parts.linear(q_dim, c.hidden_size)

    def forward(self, x, sin=None, cos=None):
        from ..nn.functional.attention import scaled_dot_product_attention
        b, s, _ = x.shape
        q = self.q_proj(x).reshape(b, s, -1, self.head_dim)
        k = self.k_proj(x).reshape(b, s, -1, self.head_dim)
        v = self.v_proj(x).reshape(b, s, -1, self.head_dim)
        if sin is not None:
            sin, cos = sin.to(q.dtype), cos.to(q.dtype)
            q = _apply_rope(q, sin, cos)
            k = _apply_rope(k, sin, cos)
        out = scaled_dot_product_attention(q, k, v, is_causal=True,
                                           training=self.training,
                                           kernels=self.kernels)
        return self.o_proj(out.reshape(b, s, -1))


class LlamaMLP(torch.nn.Module):
    """JAX ``LlamaMLP``: down(swiglu(gate(x), up(x))), column- / row-parallel
    at ``tensor_parallel_degree`` > 1."""

    def __init__(self, config: LlamaConfig, parts: _Parts):
        super().__init__()
        H, I = config.hidden_size, config.intermediate_size
        if config.tensor_parallel_degree > 1:
            self.gate_proj = parts.parallel("col", H, I)
            self.up_proj = parts.parallel("col", H, I)
            self.down_proj = parts.parallel("row", I, H)
        else:
            self.gate_proj = parts.linear(H, I)
            self.up_proj = parts.linear(H, I)
            self.down_proj = parts.linear(I, H)

    def forward(self, x):
        from ..nn.functional.activation import swiglu
        return self.down_proj(swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaMoEBlock(torch.nn.Module):
    """JAX ``LlamaMoEBlock`` (Mixtral / LLaMA-MoE): a ``MoELayer`` of
    ``num_experts`` SwiGLU experts behind a GShard top-``moe_topk`` gate at
    ``moe_capacity_factor``; in training the gate routes its second choice
    at random (GShard's), drawing from the model's routing generator.  Each
    expert is a :class:`LlamaMLP` (JAX's ``_Expert``: the same three
    projections)."""

    def __init__(self, config: LlamaConfig, parts: _Parts):
        super().__init__()
        if config.tensor_parallel_degree > 1:
            raise NotImplementedError(
                "LlamaMoEBlock: tensor-parallel experts are not implemented "
                "— use expert parallelism (incubate moe ep_axis / moe_ffn "
                "over an 'ep' mesh axis) instead of mp for the MoE variant")
        from ..incubate.distributed.models.moe import MoELayer
        self.moe = MoELayer(
            d_model=config.hidden_size,
            experts=[LlamaMLP(config, parts)
                     for _ in range(config.num_experts)],
            gate={"type": "gshard", "top_k": config.moe_topk},
            capacity_factor=config.moe_capacity_factor, **parts.mk)
        self.moe.generator = parts.routing_generator

    def forward(self, x):
        return self.moe(x)

    def aux_loss(self):
        return self.moe.gate.get_loss()


class LlamaDecoderLayer(torch.nn.Module):
    def __init__(self, config: LlamaConfig, parts: _Parts):
        super().__init__()
        self.input_layernorm = parts.norm()
        self.self_attn = LlamaAttention(config, parts)
        self.post_attention_layernorm = parts.norm()
        self.mlp = LlamaMoEBlock(config, parts) if config.num_experts > 1 \
            else LlamaMLP(config, parts)

    def forward(self, x, sin=None, cos=None):
        x = x + self.self_attn(self.input_layernorm(x), sin, cos)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(torch.nn.Module):
    """The embedding (vocab-parallel at ``tensor_parallel_degree`` > 1), the
    decoder layers and the final norm; the RoPE tables are f32 buffers
    outside the state dict, cast to the activations' dtype where they are
    applied."""

    def __init__(self, config: LlamaConfig, dtype=None, device=None,
                 seed: int = 0, kernels: bool = True, parts=None):
        super().__init__()
        parts = parts or _Parts(config, dtype, device, seed, kernels)
        self.config = config
        if config.tensor_parallel_degree > 1:
            from ..distributed.fleet.meta_parallel import \
                VocabParallelEmbedding
            self.embed_tokens = VocabParallelEmbedding(
                config.vocab_size, config.hidden_size, dtype=parts.dtype,
                device=parts.device, seed=int(seed))
        else:
            from ..nn.layers import Embedding
            self.embed_tokens = Embedding(config.vocab_size,
                                          config.hidden_size, **parts.mk)
        self.layers = torch.nn.ModuleList(
            LlamaDecoderLayer(config, parts)
            for _ in range(config.num_hidden_layers))
        self.norm = parts.norm()
        head_dim = config.hidden_size // config.num_attention_heads
        sin, cos = _rope_tables(config.max_position_embeddings, head_dim,
                                config.rope_theta, device=parts.device)
        self.register_buffer("_sin", sin, persistent=False)
        self.register_buffer("_cos", cos, persistent=False)

    def forward(self, input_ids):
        x = self.embed_tokens(input_ids)
        s = x.shape[1]
        sin, cos = self._sin[:s], self._cos[:s]
        for layer in self.layers:
            x = layer(x, sin, cos)
        return self.norm(x)


class LlamaForCausalLM(torch.nn.Module):
    """JAX ``LlamaForCausalLM`` (``models/llama.py:236``): :class:`LlamaModel`
    (``.llama``, also ``.model``) and the LM head.  ``named_parameters()``
    are the JAX model's (``llama.layers.0.self_attn.q_proj.weight``,
    ``llama.layers.0.mlp.moe.experts.0.gate_proj.weight``,
    ``llama.layers.0.mlp.moe.gate.gate_weight``, ``lm_head.weight``),
    Linear weights ``[in, out]``, so weights cross by name
    (:func:`~paddle_tpu_torch.models.convert.llama_params_from_numpy`).
    Parameters are drawn from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (``None``: the CUDA device, raising without one) in
    ``dtype`` (``None``: the config's).  ``kernels`` sends attention and
    RMSNorm to the flash-attention and RMSNorm kernels on CUDA tensors.
    With ``tie_word_embeddings`` there is no ``lm_head``: the logits are h
    @ the embedding's transpose (JAX assigns the ``[V, H]`` embedding as
    the ``[H, V]`` head's weight, which computes only where V = H)."""

    def __init__(self, config: LlamaConfig, dtype=None, device=None,
                 seed: int = 0, kernels: bool = True):
        super().__init__()
        parts = _Parts(config, dtype, device, seed, kernels)
        self.config = config
        self.llama = LlamaModel(config, seed=seed, parts=parts)
        self.lm_head = None if config.tie_word_embeddings else \
            parts.linear(config.hidden_size, config.vocab_size)

    @property
    def model(self):
        return self.llama

    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 top_k=0, top_p=1.0, eos_token_id=None, seed=0):
        if self.config.num_experts > 1:
            raise NotImplementedError(
                "generate() does not support the MoE variant — the "
                "functional decode path computes the dense FFN")
        raise NotImplementedError(
            "LlamaForCausalLM.generate: the dense KV-cache generate path "
            "(build_llama_decode, llama_generate, llama_generate_fused) is "
            "ROADMAP A item 3, 5h")

    def forward(self, input_ids, labels=None):
        from ..nn.functional.loss import cross_entropy
        h = self.llama(input_ids)
        logits = h @ self.llama.embed_tokens.weight.t() \
            if self.lm_head is None else self.lm_head(h)
        if labels is None:
            return logits
        V = self.config.vocab_size
        loss = cross_entropy(logits.reshape(-1, V), labels.reshape(-1))
        if self.config.num_experts > 1:
            # each layer's balance loss (Mixtral's aux loss)
            for layer in self.llama.layers:
                aux = layer.mlp.aux_loss()
                if aux is not None:
                    loss = loss + self.config.moe_aux_loss_weight * aux
        return loss, logits


def functional_params_from_layer(model: LlamaForCausalLM):
    """The eager model's weights stacked into the ``(embed, block, head)``
    dicts of :func:`build_functional_llama` (detached; the dense variant
    with full weights on this rank only, as in JAX)."""
    if model.config.num_experts > 1:
        raise NotImplementedError(
            "functional_params_from_layer: MoE experts do not map onto the "
            "dense wgate/wup/wdown leaves")
    if model.config.tensor_parallel_degree > 1:
        raise NotImplementedError(
            "functional_params_from_layer needs full weights on this rank "
            "(tensor_parallel_degree == 1)")
    m = model.llama

    def stack(get):
        return torch.stack([get(layer).detach() for layer in m.layers])

    bp = {"ln1": stack(lambda l: l.input_layernorm.weight),
          "wq": stack(lambda l: l.self_attn.q_proj.weight),
          "wk": stack(lambda l: l.self_attn.k_proj.weight),
          "wv": stack(lambda l: l.self_attn.v_proj.weight),
          "wo": stack(lambda l: l.self_attn.o_proj.weight),
          "ln2": stack(lambda l: l.post_attention_layernorm.weight),
          "wgate": stack(lambda l: l.mlp.gate_proj.weight),
          "wup": stack(lambda l: l.mlp.up_proj.weight),
          "wdown": stack(lambda l: l.mlp.down_proj.weight)}
    lm = m.embed_tokens.weight.t() if model.lm_head is None \
        else model.lm_head.weight
    return ({"tok": m.embed_tokens.weight.detach()}, bp,
            {"ln_f": m.norm.weight.detach(), "lm": lm.detach()})
