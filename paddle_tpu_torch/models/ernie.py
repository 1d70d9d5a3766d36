"""ERNIE-3.0 encoder, its masked-LM head and its sequence-classification
head (port of ``paddle_tpu.models.ernie``: ``ErnieConfig``, ``ErnieModel``,
``ErnieForMaskedLM``, ``ErnieForSequenceClassification``).

A post-LN transformer encoder with learned positions and token types.  The
modules are ``torch.nn.Module``s whose ``named_parameters()`` names are the
JAX model's (``ernie.encoder.0.attention.q.weight`` ...), with Linear
weights in the JAX ``[in, out]`` layout, so weights cross by name
(:func:`~paddle_tpu_torch.models.convert.ernie_params_from_numpy`).
Parameters are drawn from a ``torch.Generator`` seeded with ``seed`` on
``device`` (``None``: the CUDA device, raising without one), or from the
one an outer head shares with it.

Three knobs mirror the JAX flags, with their defaults: ``kernels``
(``use_pallas_kernels``) sends unmasked attention to the flash-attention
kernels; ``norm_kernels`` (``use_pallas_norm_kernels``, off) also sends
every LayerNorm to the LayerNorm kernels.  The third, the fused AdamW
update, is the optimizer's (``optimizer.AdamW(fused=...)``).

Dropout is where JAX has it, at the config's rates (0.1 in ERNIE-3.0-base):
hidden dropout after the embeddings' LayerNorm, on the attention output and
on the MLP output, and attention-probability dropout inside the
flash-attention kernels (or on the plain path's probabilities).  The
model owns two generators, both seeded from ``seed`` and handed to every
dropout and attention layer as it is built: ``dropout_generator`` on the
model's device draws the hidden masks (and the plain attention path's),
``attention_seed_generator`` on the host draws a seed per attention call
for the in-kernel mask, so a step never waits for the card.  The heads
share them with their ``.ernie``.  ``.eval()`` turns every dropout off, as
in JAX.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .. import resolve_device
from ..incubate.nn.functional import fused_linear_cross_entropy
from ..nn import functional
from ..nn.functional.activation import gelu
from ..nn.functional.attention import scaled_dot_product_attention
from ..nn.layers import Dropout, Embedding, LayerNorm, Linear

__all__ = ["ErnieConfig", "ErnieModel", "ErnieForMaskedLM",
           "ErnieForSequenceClassification", "ernie_config_base",
           "ernie_config_tiny"]


@dataclass
class ErnieConfig:
    vocab_size: int = 40000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 2048
    type_vocab_size: int = 4
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0


def ernie_config_base():
    return ErnieConfig()


def ernie_config_tiny(vocab=1000, hidden=64, layers=2, heads=4, seq=64):
    return ErnieConfig(vocab_size=vocab, hidden_size=hidden,
                       num_hidden_layers=layers, num_attention_heads=heads,
                       intermediate_size=hidden * 4,
                       max_position_embeddings=seq, hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)


class _Parts:
    """What every submodule needs at construction: the parameters'
    generator (seeded with ``seed``) and the two dropout generators (seeded
    from it, apart from the parameters' stream), one set per model, shared
    by a head and its ``ErnieModel``."""

    def __init__(self, c, dtype, device, seed, kernels, norm_kernels):
        dev = resolve_device(device)
        self.c, self.kernels = c, kernels
        self.mk = dict(dtype=dtype, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(
                           int(seed)))
        self.ln = dict(dtype=dtype, device=dev, kernels=kernels,
                       norm_kernels=norm_kernels)
        self.dropout_generator = torch.Generator(device=dev).manual_seed(
            int(seed) + 1)
        self.attention_seed_generator = torch.Generator().manual_seed(
            int(seed) + 2)

    def linear(self, n_in, n_out):
        return Linear(n_in, n_out, **self.mk)

    def norm(self):
        return LayerNorm(self.c.hidden_size, self.c.layer_norm_eps,
                         **self.ln)

    def dropout(self, p):
        return Dropout(p, generator=self.dropout_generator)


class ErnieEmbeddings(nn.Module):
    def __init__(self, parts: _Parts):
        super().__init__()
        c = parts.c
        self.word_embeddings = Embedding(c.vocab_size, c.hidden_size,
                                         **parts.mk)
        self.position_embeddings = Embedding(c.max_position_embeddings,
                                             c.hidden_size, **parts.mk)
        self.token_type_embeddings = Embedding(c.type_vocab_size,
                                               c.hidden_size, **parts.mk)
        self.layer_norm = parts.norm()
        self.dropout = parts.dropout(c.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        B, S = input_ids.shape
        dev = input_ids.device
        if position_ids is None:
            position_ids = torch.arange(S, device=dev).expand(B, S)
        if token_type_ids is None:
            token_type_ids = torch.zeros((B, S), dtype=torch.long,
                                         device=dev)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class ErnieSelfAttention(nn.Module):
    def __init__(self, parts: _Parts):
        super().__init__()
        c = parts.c
        self.num_heads = c.num_attention_heads
        self.head_dim = c.hidden_size // c.num_attention_heads
        self.q = parts.linear(c.hidden_size, c.hidden_size)
        self.k = parts.linear(c.hidden_size, c.hidden_size)
        self.v = parts.linear(c.hidden_size, c.hidden_size)
        self.out = parts.linear(c.hidden_size, c.hidden_size)
        self.dropout_p = c.attention_probs_dropout_prob
        self.kernels = parts.kernels
        self.generator = parts.dropout_generator
        self.seed_generator = parts.attention_seed_generator

    def forward(self, x, attn_mask=None):
        b, s, _ = x.shape
        shape = (b, s, self.num_heads, self.head_dim)
        o = scaled_dot_product_attention(
            self.q(x).reshape(shape), self.k(x).reshape(shape),
            self.v(x).reshape(shape), attn_mask=attn_mask,
            dropout_p=self.dropout_p, is_causal=False,
            training=self.training, kernels=self.kernels,
            generator=self.generator, seed_generator=self.seed_generator)
        return self.out(o.reshape(b, s, -1))


class ErnieLayer(nn.Module):
    """Post-LN encoder block (BERT/ERNIE convention)."""

    def __init__(self, parts: _Parts):
        super().__init__()
        c = parts.c
        # the activation by name from the port's functional, as JAX's
        # ``getattr(F, c.hidden_act)``
        self.act = getattr(functional, c.hidden_act, None)
        if self.act is None:
            raise NotImplementedError(
                f"hidden_act {c.hidden_act!r}: the port's nn.functional has "
                "no such function yet (ROADMAP A item 7)")
        self.attention = ErnieSelfAttention(parts)
        self.norm1 = parts.norm()
        self.fc1 = parts.linear(c.hidden_size, c.intermediate_size)
        self.fc2 = parts.linear(c.intermediate_size, c.hidden_size)
        self.norm2 = parts.norm()
        self.dropout = parts.dropout(c.hidden_dropout_prob)

    def forward(self, x, attn_mask=None):
        x = self.norm1(x + self.dropout(self.attention(x, attn_mask)))
        return self.norm2(x + self.dropout(self.fc2(self.act(self.fc1(x)))))


class ErnieModel(nn.Module):
    """Embeddings, the encoder layers and the pooler; returns the sequence
    output [B, S, H] and the pooled first token [B, H].  Parameters and the
    dropout generators (``dropout_generator``, ``attention_seed_generator``)
    come from ``seed``; a head passes its own ``parts`` instead (built from
    the same arguments), so that its layers draw from the same streams."""

    def __init__(self, config: ErnieConfig, dtype=torch.float32, device=None,
                 seed: int = 0, kernels: bool = True,
                 norm_kernels: bool = False, parts: _Parts | None = None):
        super().__init__()
        if parts is None:
            parts = _Parts(config, dtype, device, seed, kernels,
                           norm_kernels)
        self.config = config
        self.embeddings = ErnieEmbeddings(parts)
        self.encoder = nn.ModuleList(ErnieLayer(parts)
                                     for _ in range(config.num_hidden_layers))
        self.pooler = parts.linear(config.hidden_size, config.hidden_size)
        self.dropout_generator = parts.dropout_generator
        self.attention_seed_generator = parts.attention_seed_generator

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        if attention_mask is not None and attention_mask.dim() == 2:
            # [B, S] padding mask -> additive [B, 1, 1, S]
            m = (1.0 - attention_mask.float()) * -1e4
            attention_mask = m.reshape(m.shape[0], 1, 1, m.shape[1])
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        for layer in self.encoder:
            x = layer(x, attention_mask)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled


class ErnieForMaskedLM(nn.Module):
    """The MLM head over :class:`ErnieModel`: transform, GELU, LayerNorm,
    then the decoder (weight [H, V] and bias [V])."""

    def __init__(self, config: ErnieConfig, dtype=torch.float32, device=None,
                 seed: int = 0, kernels: bool = True,
                 norm_kernels: bool = False):
        super().__init__()
        parts = _Parts(config, dtype, device, seed, kernels, norm_kernels)
        self.ernie = ErnieModel(config, parts=parts)
        self.config = config
        c = config
        self.transform = parts.linear(c.hidden_size, c.hidden_size)
        self.layer_norm = parts.norm()
        self.decoder = parts.linear(c.hidden_size, c.vocab_size)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None, ignore_index=-100, return_logits=False):
        """With labels, returns (loss, None): the loss runs through the
        vocab-chunked head (8 chunks, the decoder's bias, ``ignore_index``)
        and the [B, S, V] logits never exist; with ``return_logits`` the
        dense head and cross-entropy run and the logits come back as the
        second element.  Without labels, returns the logits."""
        seq, _ = self.ernie(input_ids, token_type_ids,
                            attention_mask=attention_mask)
        h = self.layer_norm(gelu(self.transform(seq)))
        if labels is None:
            return self.decoder(h)
        if return_logits:
            logits = self.decoder(h)
            logp = torch.log_softmax(
                logits.reshape(-1, self.config.vocab_size).float(), dim=-1)
            lab = labels.reshape(-1).long()
            valid = lab != ignore_index
            nll = -logp.gather(1, torch.where(valid, lab, 0)[:, None])[:, 0]
            loss = torch.where(valid, nll, 0.0).sum() \
                / valid.float().sum().clamp(min=1.0)
            return loss, logits
        loss = fused_linear_cross_entropy(
            h, self.decoder.weight, labels, n_chunks=8,
            bias=self.decoder.bias, ignore_index=ignore_index)
        return loss, None


class ErnieForSequenceClassification(nn.Module):
    """JAX ``ErnieForSequenceClassification`` (``models/ernie.py:186``): the
    pooled first token, hidden dropout and a Linear to ``num_classes``;
    returns the logits [B, num_classes] (the loss is the caller's, as in
    JAX: cross-entropy against the labels in fine-tuning)."""

    def __init__(self, config: ErnieConfig, num_classes=2,
                 dtype=torch.float32, device=None, seed: int = 0,
                 kernels: bool = True, norm_kernels: bool = False):
        super().__init__()
        parts = _Parts(config, dtype, device, seed, kernels, norm_kernels)
        self.ernie = ErnieModel(config, parts=parts)
        self.dropout = parts.dropout(config.hidden_dropout_prob)
        self.classifier = parts.linear(config.hidden_size, num_classes)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.ernie(input_ids, token_type_ids,
                               attention_mask=attention_mask)
        return self.classifier(self.dropout(pooled))
