"""ERNIE 3.0, a bidirectional encoder, for inference and fine-tuning (port
of the reference's ``models/ernie.py``).

Token, position and segment embeddings, a post-norm
``nn.TransformerEncoder`` with GELU, and a tanh pooler; heads for sequence
classification and masked LM.  The parameter names are the reference's,
so a JAX model's weights cross through
:func:`paddle_tpu_torch.convert.load_numpy_state_dict`.  ``ErnieConfig()``
holds the published ERNIE 3.0 base widths (12 layers, hidden 768, 12
heads, FFN 3072, vocab 40000).

Without a padding mask the encoder's attention is the flash kernel (B3;
B3b/B3c under autograd); a ``[b, s]`` 1/0 ``attention_mask`` becomes the
reference's additive mask (``(1 - m) * f32 min`` over the keys) and takes
the composite attention, as in the reference.  The models are built on
``device`` (the card unless the caller asks for the CPU) with weights
drawn from a ``torch.Generator`` seeded with ``seed``, and cast with
``Layer.to(dtype=...)``.  In eval mode dropout is the identity; in
training ``hidden_dropout_prob`` drops the embeddings, the attention
probabilities (which then take the composite attention, as the
reference's flash gate refuses dropout), each layer's two residual
branches and its FFN activation, and the pooled output: 50 masks a
step at 12 layers (1 + 4 a layer + 1), drawn from torch's generators
(Philox on the card) without a host sync.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..device import resolve_device
from .. import nn
from ..nn import functional as F
from ..nn.layer.layers import placement

__all__ = ["ErnieConfig", "ErnieModel", "ErnieForSequenceClassification",
           "ErnieForMaskedLM", "ernie_tiny", "ernie3_base"]


@dataclass
class ErnieConfig:
    vocab_size: int = 40000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 2048
    type_vocab_size: int = 4
    hidden_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02


def ernie_tiny(**kw) -> ErnieConfig:
    base = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128,
                max_position_embeddings=128, type_vocab_size=2)
    base.update(kw)
    return ErnieConfig(**base)


def ernie3_base(**kw) -> ErnieConfig:
    return ErnieConfig(**kw)


def _placed(device, seed: int, generator: Optional[torch.Generator]):
    """The placement a model builds its layers in: ``generator`` and its
    device, else ``device`` (the default device if None) and a generator
    there seeded with ``seed``."""
    if generator is not None:
        return placement(generator.device, generator)
    dev = resolve_device(device)
    return placement(dev, torch.Generator(device=dev).manual_seed(seed))


class ErnieEmbeddings(nn.Layer):
    def __init__(self, config: ErnieConfig):
        super().__init__()
        init = nn.initializer.Normal(0.0, config.initializer_range)
        self.word_embeddings = nn.Embedding(config.vocab_size, config.hidden_size,
                                            weight_attr=init)
        self.position_embeddings = nn.Embedding(config.max_position_embeddings,
                                                config.hidden_size, weight_attr=init)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size,
                                                  config.hidden_size, weight_attr=init)
        self.layer_norm = nn.LayerNorm(config.hidden_size, config.layer_norm_eps)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        s = input_ids.shape[1]
        if s > self.position_embeddings._num_embeddings:
            raise ValueError(
                f"sequence length {s} exceeds max_position_embeddings "
                f"{self.position_embeddings._num_embeddings}")
        pos = torch.arange(s, device=input_ids.device)
        emb = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            emb = emb + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(emb))


class ErnieModel(nn.Layer):
    """Embeddings, encoder and pooler: ``(sequence output, pooled)``."""

    def __init__(self, config: ErnieConfig, *, device=None, seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        with _placed(device, seed, generator):
            self.embeddings = ErnieEmbeddings(config)
            enc_layer = nn.TransformerEncoderLayer(
                config.hidden_size, config.num_attention_heads, config.intermediate_size,
                dropout=config.hidden_dropout_prob, activation="gelu",
                layer_norm_eps=config.layer_norm_eps)
            self.encoder = nn.TransformerEncoder(enc_layer, config.num_hidden_layers)
            self.pooler = nn.Linear(config.hidden_size, config.hidden_size)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        dev = self.embeddings.word_embeddings.weight.device
        input_ids = torch.as_tensor(input_ids, device=dev)
        if token_type_ids is not None:
            token_type_ids = torch.as_tensor(token_type_ids, device=dev)
        x = self.embeddings(input_ids, token_type_ids)
        if attention_mask is not None:
            # [b, s] 1/0 -> additive [b, 1, 1, s], f32, as the reference builds it
            m = torch.as_tensor(attention_mask, device=dev).float()
            attention_mask = (1.0 - m)[:, None, None, :] * torch.finfo(torch.float32).min
        seq_out = self.encoder(x, attention_mask)
        pooled = F.tanh(self.pooler(seq_out[:, 0]))
        return seq_out, pooled


class ErnieForSequenceClassification(nn.Layer):
    """Class logits from the pooled output; with ``labels``, ``(mean cross
    entropy, logits)``."""

    def __init__(self, config: ErnieConfig, num_classes: int = 2, *, device=None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        with placement(dev, gen):
            self.ernie = ErnieModel(config, generator=gen)
            self.dropout = nn.Dropout(config.hidden_dropout_prob)
            self.classifier = nn.Linear(config.hidden_size, num_classes)
        self.num_classes = num_classes

    def forward(self, input_ids, token_type_ids=None, attention_mask=None, labels=None):
        _, pooled = self.ernie(input_ids, token_type_ids, attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return F.cross_entropy(logits, torch.as_tensor(labels, device=logits.device)), \
                logits
        return logits


class ErnieForMaskedLM(nn.Layer):
    """Vocabulary logits through a transform, a LayerNorm and the tied word
    embeddings; with ``labels`` (-100 ignored), ``(mean cross entropy,
    logits)``."""

    def __init__(self, config: ErnieConfig, *, device=None, seed: int = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        with placement(dev, gen):
            self.ernie = ErnieModel(config, generator=gen)
            self.transform = nn.Linear(config.hidden_size, config.hidden_size)
            self.layer_norm = nn.LayerNorm(config.hidden_size, config.layer_norm_eps)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None, labels=None):
        seq_out, _ = self.ernie(input_ids, token_type_ids, attention_mask)
        h = self.layer_norm(F.gelu(self.transform(seq_out)))
        logits = F.linear(h, self.ernie.embeddings.word_embeddings.weight.T)
        if labels is not None:
            labels = torch.as_tensor(labels, device=logits.device)
            loss = F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                                   labels.reshape(-1), ignore_index=-100)
            return loss, logits
        return logits
