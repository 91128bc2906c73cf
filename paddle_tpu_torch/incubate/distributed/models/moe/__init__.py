"""Mixture-of-Experts layers, gates and routing (port of the reference's
``incubate/distributed/models/moe``).

Routing is GShard's top-k with a capacity, as the reference computes it:
- the capacity is ``max(8, ceil(cf·k·n/E))`` rounded up to a multiple of
  8 (:func:`_capacity`); it decides which assignments drop;
- every token's first choice claims a slot before any second choice, and
  within a round the slots go in token order (the row-major order of the
  caller's ``[b, s]``); an assignment whose slot is at or past the
  capacity is dropped and contributes zero;
- the top-k is a stable descending sort of the f32 probabilities, so equal
  probabilities go to the lower expert first, as ``jax.lax.top_k`` does;
- the weights are the top-k probabilities over their sum (clipped at
  1e-9); the aux loss is ``E · Σ_e mean(probs)_e · frac(top-1 = e)`` over
  every token of the call, pads included.

Routing couples every token of one call: the capacity and the priority
order depend on the whole input, so a caller that feeds other token
blocks (skipped pads, dead rows) gets other results.

The reference moves tokens with dense one-hot ``[N, E, C]`` masks and two
einsums.  Each output element of its dispatch sums one nonzero term, so
the dispatch is a gather, and each token of its combine sums at most k
weighted rows, so the combine is a weighted gather.  The port computes
the same values by index (:class:`Routing`: a slot ``e·C + pos`` for each
kept assignment) with ``index_select`` and ``scatter_``, which moves
``N·d`` elements where the dense form multiplies ``N·E·C·d``.  Autograd
gives the reference's gradients: none through the slots, and through the
combine weights into the router.  Rounding follows the reference's:
``ExpertParallelMLP`` rounds the weights to the experts' dtype and sums
the k products in f32 (in bf16 the products are exact, so the sum is the
reference's bit for bit); ``MoELayer`` keeps f32 weights.  In f32 the
reference's CPU dot sums the k products with or without a fused
multiply-add, by position, so there the two agree within an ulp.

The expert products are ``torch.matmul`` per expert, as the reference
leaves them to XLA; the expert SwiGLU is plain elementwise torch (the
reference's reaches no Pallas kernel).  ``expert_axes`` under a live
single-controller mesh (:func:`~paddle_tpu_torch.ops.sharded.active_mesh`)
splits the experts over the axes' members, each on its device, joined on
the caller's device in expert order: bit-equal to one block, as each
expert's products are the same calls.
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as TF

from .....framework import random as R
from .....nn import functional as F
from .....nn import initializer as I
from .....nn.layer.container import LayerList
from .....nn.layer.layers import Layer, placement
from .....ops.sharded import _member, active_mesh

__all__ = ["MoELayer", "ExpertParallelMLP", "NaiveGate", "GShardGate", "SwitchGate"]


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
class Routing(NamedTuple):
    """Where each (token, choice) goes, choices round-major: ``expert``,
    ``pos`` (its claim order at that expert) and ``keep`` [k, N];
    ``slot`` [k, N] is ``expert·C + pos`` where kept, ``E·C`` where
    dropped; ``weight`` [k, N] f32 the normalised top-k probabilities
    (dropped ones included); ``l_aux`` the load-balance loss."""
    expert: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    weight: torch.Tensor
    l_aux: torch.Tensor
    capacity: int


def _aux_loss(probs: torch.Tensor, top1: torch.Tensor) -> torch.Tensor:
    """``E · Σ_e mean(probs)_e · frac(top-1 = e)`` over every token (the
    one-hot by comparison: ``F.one_hot`` checks the range on the host, a
    device sync)."""
    e = probs.shape[-1]
    frac = (top1[:, None] == torch.arange(e, device=top1.device)).float().mean(dim=0)
    return (probs.mean(dim=0) * frac).sum() * e


def _topk(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``probs`` [N, E] with ties to the lower index (a stable
    descending sort): values (differentiable) and indices."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
    return probs.gather(1, idx), idx


def _route(logits: torch.Tensor, k: int, capacity: int,
           normalize_weights: bool = True) -> Routing:
    """The reference's ``_topk_routing`` by index, from router logits
    [N, E] (softmax and top-k in f32)."""
    n, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    topv, topi = _topk(probs, k)
    if normalize_weights:
        topv = topv / topv.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    l_aux = _aux_loss(probs, topi[:, 0])
    expert = topi.t()                                          # [k, N]
    flat = expert.reshape(-1)                                  # priority order
    # claims before this one at its expert, dropped ones included: a scan
    # along the contiguous dim of [E, k·N] (along dim 0 of [k·N, E] the
    # card's scan runs E threads down k·N rows, 1.45 ms at 4096 tokens)
    claims = (torch.arange(e, device=flat.device)[:, None] == flat).int().cumsum(
        dim=1, dtype=torch.int32)
    pos = claims.gather(0, flat[None, :]).view(k, n) - 1
    keep = pos < capacity
    slot = torch.where(keep, expert * capacity + pos, e * capacity)
    return Routing(expert, pos, keep, slot, topv.t(), l_aux, capacity)


def _capacity(num_tokens: int, num_experts: int, k: int, capacity_factor: float) -> int:
    cap = int(math.ceil(capacity_factor * k * num_tokens / num_experts))
    return max(8, -(-cap // 8) * 8)  # the reference's multiple of 8 (it decides drops)


def _dispatch(tokens: torch.Tensor, r: Routing, num_experts: int) -> torch.Tensor:
    """tokens [N, d] → [E, C, d]: each kept assignment's token in its slot,
    empty slots zero (a gather; its backward sums each token's k rows)."""
    n, d = tokens.shape
    ec = num_experts * r.capacity
    src = torch.full((ec + 1,), n, dtype=torch.long, device=tokens.device)
    # kept slots are distinct; every dropped assignment lands on the spare
    src.scatter_(0, r.slot.reshape(-1),
                 torch.arange(n, device=tokens.device).repeat(r.slot.shape[0]))
    padded = torch.cat([tokens, tokens.new_zeros(1, d)])
    return padded.index_select(0, src[:ec]).view(num_experts, r.capacity, d)


def _combine(ye: torch.Tensor, r: Routing, round_weights: bool) -> torch.Tensor:
    """[E, C, d] → [N, d]: each token's kept rows times their weights,
    summed in f32 in choice order and rounded to ``ye``'s dtype; with
    ``round_weights`` the weights first round to ``ye``'s dtype."""
    e, c, d = ye.shape
    rows = ye.reshape(e * c, d)
    w = r.weight * r.keep
    if round_weights:
        w = w.to(ye.dtype)
    slot = torch.where(r.keep, r.slot, 0)
    out = None
    for j in range(slot.shape[0]):
        term = w[j].float()[:, None] * rows.index_select(0, slot[j]).float()
        out = term if out is None else out + term
    return out.to(ye.dtype)


def _router_logits(tokens: torch.Tensor, gate_weight: torch.Tensor) -> torch.Tensor:
    """``tokens @ gate_weight`` in f32 (never TF32), whatever their dtypes."""
    prior = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(tokens.float(), gate_weight.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prior


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------
class NaiveGate(Layer):
    """Plain learned top-k router (reference ``gate/naive_gate.py``):
    linear scores, top-k softmax weights, no capacity pressure beyond the
    layer's.  Built on ``device`` (else the enclosing placement's, else
    the default device)."""

    top_k = 2

    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 2, *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self._place(device, generator)
        # the global expert count, as the reference's single controller sees it
        self.num_expert_global = num_expert * world_size
        self.d_model = d_model
        self.top_k = topk
        self.add_parameter("gate_weight", self.create_parameter(
            [d_model, self.num_expert_global], default_initializer=I.XavierUniform()))
        self.loss: Optional[torch.Tensor] = None

    def gate_logits(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.gate_weight)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        probs = torch.softmax(self.gate_logits(x).float(), dim=-1)
        self.loss = None
        return _topk(probs, self.top_k)


class GShardGate(NaiveGate):
    """Top-2 gate with the GShard load-balancing loss (reference
    ``gate/gshard_gate.py:31``; the layer enforces the capacity)."""

    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 2, capacity: Tuple[float, float] = (1.2, 2.4),
                 random_routing: bool = True, group=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(d_model, num_expert, world_size, topk=topk, device=device,
                         generator=generator)
        self.capacity_factor = capacity

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        probs = torch.softmax(self.gate_logits(x).float(), dim=-1)
        val, idx = _topk(probs, self.top_k)
        self.loss = _aux_loss(probs, idx[:, 0])
        return val, idx

    def get_loss(self, clear: bool = True) -> Optional[torch.Tensor]:
        loss = self.loss
        if clear:
            self.loss = None
        return loss


class SwitchGate(NaiveGate):
    """Top-1 Switch-Transformer gate (reference ``gate/switch_gate.py``).
    In training, the f32 logits take multiplicative noise uniform in
    [1 − ``switch_eps``, 1 + ``switch_eps``), drawn through the port's
    random seam (``framework.random._uniform``)."""

    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 1, switch_eps: float = 0.1, capacity: Tuple = (1.2, 2.4),
                 group=None, *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__(d_model, num_expert, world_size, topk=1, device=device,
                         generator=generator)
        self.switch_eps = switch_eps

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = self.gate_logits(x).float()
        eps = self.switch_eps
        if self.training and eps > 0:
            logits = logits * R._uniform(logits.shape, 1.0 - eps, 1.0 + eps, logits.device)
        probs = torch.softmax(logits, dim=-1)
        val, idx = _topk(probs, 1)
        self.loss = _aux_loss(probs, idx[:, 0])
        return val, idx

    get_loss = GShardGate.get_loss


def _make_gate(gate, d_model: int, num_expert: int) -> NaiveGate:
    if isinstance(gate, NaiveGate):
        return gate
    cfg = dict(gate) if isinstance(gate, dict) else {}
    kind = cfg.get("type", "gshard")
    topk = cfg.get("top_k", 2)
    if kind == "naive" or kind is None:
        return NaiveGate(d_model, num_expert, topk=topk)
    if kind == "gshard":
        return GShardGate(d_model, num_expert, topk=topk)
    if kind == "switch":
        return SwitchGate(d_model, num_expert)
    raise ValueError(f"unknown gate type {kind!r} (naive|gshard|switch)")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
class MoELayer(Layer):
    """API-parity MoE layer (reference ``moe_layer.py:263``).

    ``experts`` is a ``LayerList`` (or a list) of arbitrary expert
    networks mapping [tokens, d_model] → [tokens, d_model], run one by one
    on their ``[C, d]`` slot blocks.  Routing follows the gate's top-k on
    its logits in the tokens' dtype; the combine keeps f32 weights.  A
    gate given by dict is built on the experts' device."""

    def __init__(self, d_model: int, experts=None, gate=None, moe_group=None,
                 mp_group=None, recompute_interval: int = 0, recompute_ctx=None,
                 capacity_factor: float = 2.0):
        super().__init__()
        if experts is None or len(experts) == 0:
            raise ValueError("MoELayer requires a non-empty experts LayerList")
        self.d_model = d_model
        self.experts = experts if isinstance(experts, Layer) else LayerList(list(experts))
        self.num_expert = len(self.experts)
        home = next((p.device for p in self.experts.parameters()), None)
        with placement(home):
            self.gate = _make_gate(gate, d_model, self.num_expert)
        self.top_k = self.gate.top_k
        self.capacity_factor = capacity_factor
        self.recompute_interval = recompute_interval
        self.l_aux: Optional[torch.Tensor] = None

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        shape = inp.shape
        tokens = inp.reshape(-1, shape[-1])
        cap = _capacity(tokens.shape[0], self.num_expert, self.top_k, self.capacity_factor)
        r = _route(self.gate.gate_logits(tokens), self.top_k, cap)
        self.l_aux = self.gate.loss = r.l_aux
        xe = _dispatch(tokens, r, self.num_expert)
        ye = torch.stack([self.experts[e](xe[e]) for e in range(self.num_expert)])
        return _combine(ye, r, round_weights=False).reshape(shape)


def _expert_ffn(xe: torch.Tensor, weights, activation: str) -> torch.Tensor:
    """The experts' FFN on their slot blocks xe [e, C, d], one expert at a
    time (the same calls whichever block holds it)."""
    outs = []
    for i in range(xe.shape[0]):
        x = xe[i]
        if activation == "swiglu":
            w1, wg, w2 = (w[i] for w in weights)
            h = TF.silu(torch.matmul(x, w1)) * torch.matmul(x, wg)
        else:
            w1, w2 = (w[i] for w in weights)
            h = _ACT_FNS[activation](torch.matmul(x, w1))
        outs.append(torch.matmul(h, w2))
    return torch.stack(outs)


class ExpertParallelMLP(Layer):
    """Stacked-expert MoE FFN: ``gate_weight [d, E]``, ``w1``/``w_gate``
    ``[E, d, h]``, ``w2 [E, h, d]`` (``w_gate`` with ``activation=
    "swiglu"`` only), drawn XavierUniform in ``param_dtype`` on ``device``
    (else the enclosing placement's, else the default device).  The router
    runs in f32; ``l_aux`` holds the last call's aux loss.

    ``expert_axes`` (names of mesh axes): under a live single-controller
    mesh with those axes, each of their members computes its block of
    experts on its device (module docstring); E must divide over them
    (``ValueError``).  Without such a mesh, one block, as the reference's
    sharding constraint is the identity without a mesh."""

    def __init__(self, d_model: int, d_hidden: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 2.0,
                 activation: str = "swiglu", expert_axes: Union[str, Sequence[str], None] = None,
                 param_dtype="float32", *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dtype=param_dtype)
        self._place(device, generator)
        if activation != "swiglu" and activation not in _ACT_FNS:
            raise ValueError(f"unknown activation {activation!r} "
                             f"(swiglu|{'|'.join(_ACT_FNS)})")
        self.d_model, self.d_hidden, self.num_experts = d_model, d_hidden, num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.activation = activation
        self.expert_axes = (expert_axes,) if isinstance(expert_axes, str) else \
            tuple(expert_axes) if expert_axes else None

        def mk(shape):
            return self.create_parameter(shape, default_initializer=I.XavierUniform())

        self.add_parameter("gate_weight", mk([d_model, num_experts]))
        self.add_parameter("w1", mk([num_experts, d_model, d_hidden]))
        if activation == "swiglu":
            self.add_parameter("w_gate", mk([num_experts, d_model, d_hidden]))
        self.add_parameter("w2", mk([num_experts, d_hidden, d_model]))
        self.l_aux: Optional[torch.Tensor] = None

    def _expert_weights(self):
        return (self.w1, self.w_gate, self.w2) if self.activation == "swiglu" \
            else (self.w1, self.w2)

    def _expert_mesh(self):
        """The live mesh the experts split over, or None (one block)."""
        mesh = active_mesh() if self.expert_axes else None
        if mesh is None or any(a not in mesh.shape for a in self.expert_axes):
            return None
        n = math.prod(mesh.shape[a] for a in self.expert_axes)
        if n == 1:
            return None
        if self.num_experts % n:
            raise ValueError(f"{self.num_experts} experts do not divide over "
                             f"{self.expert_axes} ({n} members)")
        return mesh

    def _experts(self, xe: torch.Tensor) -> torch.Tensor:
        weights = self._expert_weights()
        mesh = self._expert_mesh()
        if mesh is None:
            return _expert_ffn(xe, weights, self.activation)
        axes = self.expert_axes
        members = list(itertools.product(*(range(mesh.shape[a]) for a in axes)))
        w = self.num_experts // len(members)
        outs = []
        for i, coords in enumerate(members):
            dev = _member(mesh, dict(zip(axes, coords)))
            blk = slice(i * w, (i + 1) * w)
            ye = _expert_ffn(xe[blk].to(dev), [p[blk].to(dev) for p in weights],
                             self.activation)
            outs.append(ye.to(xe.device))
        return torch.cat(outs)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        shape = inp.shape
        tokens = inp.reshape(-1, shape[-1])
        cap = _capacity(tokens.shape[0], self.num_experts, self.top_k, self.capacity_factor)
        r = _route(_router_logits(tokens, self.gate_weight), self.top_k, cap)
        self.l_aux = r.l_aux
        ye = self._experts(_dispatch(tokens, r, self.num_experts))
        return _combine(ye, r, round_weights=True).reshape(shape)


_ACT_FNS = {"gelu": lambda x: TF.gelu(x, approximate="tanh"), "relu": TF.relu,
            "silu": TF.silu}
