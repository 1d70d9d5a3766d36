"""Vocab-chunked linear cross-entropy and the dense MoE (port of
``paddle_tpu.incubate.nn.functional.fused_linear_cross_entropy_impl``,
``fused_linear_cross_entropy`` and ``fused_moe``)."""
from __future__ import annotations

import torch

__all__ = ["fused_linear_cross_entropy_impl", "fused_linear_cross_entropy",
           "fused_moe"]


def _logits_f32(x, w):
    """x [T, H] @ w [H, C] with f32 accumulation and an f32 result (JAX's
    ``preferred_element_type=f32``): a bf16 product on the card keeps the
    cuBLAS f32 accumulator instead of rounding it to bf16; on the CPU the
    operands are widened, which gives the same exact products."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


class _ChunkedCE(torch.autograd.Function):
    """Per-token NLL of softmax(x @ weight [+ bias]) over ``n`` vocab
    chunks; the optional bias [V] is added in f32 to each chunk's f32
    logits, and its gradient is the column sum of the chunk's f32 dlogits.
    The forward keeps only the online logsumexp state (running max, sum,
    the label's logit) — never the [T, V] logits — and saves the final
    logsumexp; the backward recomputes each chunk's logits, as JAX's
    rematerialised scan body does, so peak memory is one [T, V / n] chunk."""

    @staticmethod
    def forward(ctx, x, weight, labels, n_chunks, bias):
        T = x.shape[0]
        V = weight.shape[1]
        C = V // n_chunks
        lab = labels.reshape(-1).long()
        m = torch.full((T,), float("-inf"), dtype=torch.float32,
                       device=x.device)
        s = torch.zeros((T,), dtype=torch.float32, device=x.device)
        ll = torch.zeros((T,), dtype=torch.float32, device=x.device)
        for i in range(n_chunks):
            logits = _logits_f32(x, weight[:, i * C:(i + 1) * C])
            if bias is not None:
                logits = logits + bias[i * C:(i + 1) * C].float()
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) \
                + torch.exp(logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            rel = lab - i * C
            inside = (rel >= 0) & (rel < C)
            picked = torch.gather(logits, 1, rel.clamp(0, C - 1)[:, None])[:, 0]
            ll = torch.where(inside, picked, ll)
        lse = m + torch.log(s)
        ctx.save_for_backward(x, weight, lab, lse, bias)
        ctx.n_chunks = n_chunks
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        x, weight, lab, lse, bias = ctx.saved_tensors
        n_chunks = ctx.n_chunks
        C = weight.shape[1] // n_chunks
        g = g.float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.empty_like(weight)
        db = None if bias is None else torch.empty_like(bias)
        for i in range(n_chunks):
            w_c = weight[:, i * C:(i + 1) * C]
            logits = _logits_f32(x, w_c)
            if bias is not None:
                logits += bias[i * C:(i + 1) * C].float()
            # d nll / d logits = softmax - onehot(label), times g per token
            dlogits = torch.exp(logits - lse[:, None])
            rel = lab - i * C
            inside = (rel >= 0) & (rel < C)
            dlogits.scatter_add_(1, rel.clamp(0, C - 1)[:, None],
                                 -inside.float()[:, None])
            dlogits *= g[:, None]
            if bias is not None:
                db[i * C:(i + 1) * C] = dlogits.sum(dim=0).to(bias.dtype)
            d = dlogits.to(x.dtype)
            dx += d @ w_c.T
            dw[:, i * C:(i + 1) * C] = (x.T @ d).to(weight.dtype)
        return dx.to(x.dtype), dw, None, None, db


def fused_linear_cross_entropy_impl(x, weight, labels, n_chunks=8,
                                    bias=None):
    """Per-token NLL [T] (f32) of softmax(x @ weight [+ bias]) without the
    [T, V] logits: x [T, H], weight [H, V], labels int [T], bias [V] or
    None.  When V does not divide into ``n_chunks`` the largest divisor of V
    below it is used, as in JAX."""
    V = weight.shape[1]
    if V % n_chunks:
        n_chunks = next(d for d in range(n_chunks, 0, -1) if V % d == 0)
    return _ChunkedCE.apply(x, weight, labels, n_chunks, bias)


def fused_linear_cross_entropy(x, weight, labels, n_chunks=8, bias=None,
                               ignore_index=None):
    """Mean NLL of a linear head and softmax cross-entropy, vocab-chunked
    (JAX ``functional.py:84``): x [..., H] flattens over its leading dims
    and labels match them.  With ``ignore_index`` the mean runs over the
    other tokens only."""
    lab = labels.reshape(-1)
    nll = fused_linear_cross_entropy_impl(
        x.reshape(-1, x.shape[-1]), weight, lab, n_chunks=n_chunks,
        bias=bias)
    if ignore_index is None:
        return nll.mean()
    valid = (lab != ignore_index).float()
    return (nll * valid).sum() / valid.sum().clamp(min=1.0)


def fused_moe(x, gate_weight, expert_weights1, expert_bias1, expert_weights2,
              expert_bias2, quant_method="None", moe_topk=2,
              norm_topk_prob=True):
    """JAX ``fused_moe`` (``incubate/nn/functional.py:252``; reference
    incubate/nn/functional/fused_moe.py): every token through every expert,
    the outputs weighted by the top-k gate probabilities (renormalised
    when ``norm_topk_prob``) and summed.  ``expert_weights1`` [E, d, h]:
    SwiGLU on its two halves when h is twice ``expert_weights2``'s [E,
    h', d] h', else GELU (tanh form, ``jax.nn.gelu``'s).  The routed,
    capacity-bounded form is ``incubate.distributed.models.moe``."""
    import torch.nn.functional as F
    logits = x @ gate_weight
    E = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, moe_topk, dim=-1)
    if norm_topk_prob:
        topv = topv / topv.sum(-1, keepdim=True)
    h = torch.einsum("...d,edh->...eh", x, expert_weights1) + expert_bias1
    if expert_weights2.shape[-2] * 2 == h.shape[-1]:
        half = h.shape[-1] // 2
        h = F.silu(h[..., :half]) * h[..., half:]
    else:
        h = F.gelu(h, approximate="tanh")
    out_e = torch.einsum("...eh,ehd->...ed", h, expert_weights2) \
        + expert_bias2
    mask = (F.one_hot(topi, E).to(x.dtype) * topv[..., None]).sum(-2)
    return torch.einsum("...ed,...e->...d", out_e, mask)
