"""The 1F1B and interleaved (virtual-stage) pipeline engine (port of the
reference's ``distributed/pipeline_1f1b.py``; paddle's host 1F1B,
``fleet/meta_parallel/pipeline_parallel.py:440``, and interleaved VPP,
``:906``).

- The schedule is built on the host (:func:`make_1f1b_schedule`, numpy
  only, kept as the reference has it so its tables are the reference's
  array for array): each stage's event order (warm-up forwards, steady
  1F1B pairs, cool-down backwards; chunks grouped for ``num_chunks`` > 1),
  then a lockstep tick assignment into int32 tables ``[T, num_stages]``.
  Each tick a stage may run one forward and one backward micro-step.
- :class:`OneFOneBLayers` runs those tables eagerly: each tick, each stage
  runs at most its backward lane (first) and its forward lane, on its
  ``pipe`` member's device; activations and cotangents hop to the next and
  previous stage at the end of the tick, into the circular-buffer slots the
  tables name.  The loss is fused into the last segment.  The backward is
  driven from the tables, a segment at a time (``torch.autograd.grad`` on
  the segment), not by one ``loss.backward()``.  Idle (bubble) ticks run
  nothing: ``P·M·v`` segment forwards against GPipe's ``P·v·(M+P-1)``.
- Two activation policies (``recompute=``): ``True`` stashes only a
  segment's input and reruns its forward under ``enable_grad`` at its
  backward tick; ``False`` keeps the segment's autograd graph (its saved
  residuals) until its backward tick; ``"auto"`` (default) keeps graphs
  while the estimate ``Da`` x (a segment's saved activations + its input)
  fits ``stash_budget_bytes`` (default: 25% of the card's memory, 1 GiB on
  the CPU), measured with ``torch.autograd.graph.saved_tensors_hooks`` on a
  probe micro-batch (tensors that share a weight stack's storage are left
  out: they are not stashed, as the reference rebuilds param-valued
  residuals from the stacks).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .engine import GPipeLayers

__all__ = ["make_1f1b_schedule", "schedule_efficiency", "OneFOneBLayers"]


# ---------------------------------------------------------------------------
# host-side schedule construction
# ---------------------------------------------------------------------------

def _stage_events(stage: int, num_stages: int, num_microbatches: int,
                  num_chunks: int) -> List[Tuple[str, int, int]]:
    """Per-stage ordered (kind, chunk, microbatch) events, reference order:
    non-interleaved warmup = P-1-s forwards (`pipeline_parallel.py:467`);
    interleaved warmup = (P-1-s)*2 + (v-1)*P chunked micro-steps (`:906`),
    micro-batches grouped P at a time per chunk, backward chunks reversed."""
    p, m, v = num_stages, num_microbatches, num_chunks
    total = m * v

    def fwd_order():
        if v == 1:
            return [(0, i) for i in range(m)]
        seq = []
        for k in range(total):
            group, within = divmod(k, p * v)
            chunk, pos = divmod(within, p)
            seq.append((chunk, group * p + pos))
        return seq

    fwds = fwd_order()
    bwds = [(v - 1 - c, i) for (c, i) in fwds]
    if v == 1:
        warmup = min(p - 1 - stage, total)
    else:
        warmup = min((p - 1 - stage) * 2 + (v - 1) * p, total)
    events: List[Tuple[str, int, int]] = []
    fi = bi = 0
    for _ in range(warmup):
        events.append(("f",) + fwds[fi]); fi += 1
    while fi < total:
        events.append(("f",) + fwds[fi]); fi += 1
        events.append(("b",) + bwds[bi]); bi += 1
    while bi < total:
        events.append(("b",) + bwds[bi]); bi += 1
    return events


def _fit_depth(intervals: List[Tuple[int, int, int, int]], cap: int = 4096) -> int:
    """Min circular-buffer depth D such that slot = key % D has no two live
    intervals colliding. ``intervals`` = (stage, key, write_tick, read_tick];
    each stage owns its own buffer, so collisions are per-stage."""
    if not intervals:
        return 1
    for depth in range(1, cap + 1):
        slots: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        ok = True
        for stage, key, w, r in intervals:
            slots.setdefault((stage, key % depth), []).append((w, r))
        for spans in slots.values():
            spans.sort()
            for (w1, r1), (w2, r2) in zip(spans, spans[1:]):
                if w2 < r1:  # next write lands while previous value still live
                    ok = False
                    break
            if not ok:
                break
        if ok:
            return depth
    raise RuntimeError("no circular-buffer depth found")


def make_1f1b_schedule(num_stages: int, num_microbatches: int,
                       num_chunks: int = 1) -> Dict:
    """Build the lockstep tick tables for the compiled 1F1B engine.

    Returns dict with int32 numpy tables of shape [T, num_stages] (−1 = none):
    F_C/F_I (forward chunk/microbatch), F_SRC (fbuf read slot; −1 = from the
    global input), F_STASH (abuf write slot), B_C/B_I, B_A (abuf read slot),
    B_G (gbuf read slot; −1 = last segment, cotangent comes from the fused
    loss), RF/RB (end-of-tick receive slots for the fwd/bwd ring hops), plus
    buffer depths Df/Da/Dg, tick count T and bookkeeping for tests."""
    p, m, v = num_stages, num_microbatches, num_chunks
    if v > 1 and m % p != 0:
        raise ValueError(f"interleaved schedule needs num_microbatches ({m}) "
                         f"to be a multiple of the pipe degree ({p})")
    events = [_stage_events(s, p, m, v) for s in range(p)]

    # per-lane queues: f events and b events each keep THEIR order, but the
    # f/b interleaving flexes per tick — the reference's strict f,b,f,b
    # alternation head-of-line-blocks the lockstep tick assignment (a stage
    # whose next-in-order b is not yet ready would idle its f lane even when
    # the next f IS ready, halving steady-state occupancy at v=1).  An
    # in-flight cap (the stage's 1F1B warmup depth + 1) keeps the activation
    # memory bound at O(P) exactly like the strict order does.
    fq = [[(c, i) for k, c, i in ev if k == "f"] for ev in events]
    bq = [[(c, i) for k, c, i in ev if k == "b"] for ev in events]
    # lockstep steady-state in-flight: the f-chain reaches stage s at tick
    # s and the matching b returns at tick 2(p-1)-s, so a gap-free FB tick
    # train needs 2(p-1-s)+1 slots at v=1 (double the async 1F1B bound —
    # both lanes fire in ONE tick here).  For interleaved v>1 the classic
    # warmup depth + 1 already achieves the analytic occupancy.
    if v == 1:
        cap = [2 * (p - 1 - s) + 1 for s in range(p)]
    else:
        cap = [sum(1 for k, _, _ in ev[:next((j for j, e in enumerate(ev)
                                              if e[0] == "b"), len(ev))]) + 1
               for ev in events]  # warmup micro-steps + 1
    fp = [0] * p
    bp = [0] * p

    tick_f: Dict[Tuple[int, int, int], int] = {}  # (chunk, mb, stage) -> tick
    tick_b: Dict[Tuple[int, int, int], int] = {}
    done: List[List[Tuple[str, int, int, int]]] = [[] for _ in range(p)]
    t = 0
    while any(fp[s] < len(fq[s]) or bp[s] < len(bq[s]) for s in range(p)):
        if t > 8 * (m * v + p) + 16:
            raise RuntimeError("1F1B schedule failed to converge")
        taken_any = False
        this_tick: List[Tuple[int, str, int, int]] = []

        def ready(stage, kind, c, i):
            if kind == "f":
                if stage > 0:
                    pred = (c, i, stage - 1)
                elif c > 0:
                    pred = (c - 1, i, p - 1)
                else:
                    return True
                return pred in tick_f and tick_f[pred] < t
            if stage < p - 1:
                succ = (c, i, stage + 1)
            elif c < v - 1:
                succ = (c + 1, i, 0)
            else:  # last global segment: own forward must have happened
                return (c, i, stage) in tick_f and tick_f[(c, i, stage)] < t
            return succ in tick_b and tick_b[succ] < t

        for s in range(p):
            if bp[s] < len(bq[s]) and ready(s, "b", *bq[s][bp[s]]):
                c, i = bq[s][bp[s]]
                this_tick.append((s, "b", c, i))
                bp[s] += 1
                taken_any = True
            if (fp[s] < len(fq[s]) and fp[s] - bp[s] < cap[s]
                    and ready(s, "f", *fq[s][fp[s]])):
                c, i = fq[s][fp[s]]
                this_tick.append((s, "f", c, i))
                fp[s] += 1
                taken_any = True
        for s, kind, c, i in this_tick:
            (tick_f if kind == "f" else tick_b)[(c, i, s)] = t
            done[s].append((kind, c, i, t))
        if not taken_any:
            raise RuntimeError("1F1B schedule deadlock")
        t += 1
    T = t

    # buffer depths from true liveness --------------------------------------
    f_iv, a_iv, g_iv = [], [], []
    for (c, i, s), tf in tick_f.items():
        key = c * m + i
        # fbuf: activation written at end of predecessor's fwd tick
        if s > 0:
            f_iv.append((s, key, tick_f[(c, i, s - 1)], tf))
        elif c > 0:
            f_iv.append((s, key, tick_f[(c - 1, i, p - 1)], tf))
        # abuf: own input stashed at fwd tick, consumed at bwd tick
        a_iv.append((s, key, tf, tick_b[(c, i, s)]))
    for (c, i, s), tb in tick_b.items():
        key = c * m + i
        if s < p - 1:
            g_iv.append((s, key, tick_b[(c, i, s + 1)], tb))
        elif c < v - 1:
            g_iv.append((s, key, tick_b[(c + 1, i, 0)], tb))
        # last segment: no gbuf — loss vjp supplies the cotangent
    Df, Da, Dg = _fit_depth(f_iv), _fit_depth(a_iv), _fit_depth(g_iv)

    tbl = {k: np.full((T, p), -1, np.int32)
           for k in ("F_C", "F_I", "F_SRC", "F_STASH",
                     "B_C", "B_I", "B_A", "B_G", "RF", "RB")}
    for (c, i, s), tf in tick_f.items():
        key = c * m + i
        tbl["F_C"][tf, s] = c
        tbl["F_I"][tf, s] = i
        tbl["F_SRC"][tf, s] = -1 if (s == 0 and c == 0) else key % Df
        tbl["F_STASH"][tf, s] = key % Da
        # receive side of the fwd ring hop (sender s at tick tf → stage s+1)
        dst_s = (s + 1) % p
        if s < p - 1:
            tbl["RF"][tf, dst_s] = key % Df
        elif c < v - 1:  # stage P-1 chunk c feeds chunk c+1 on stage 0
            tbl["RF"][tf, dst_s] = ((c + 1) * m + i) % Df
        # last global segment sends nothing (loss is fused)
    for (c, i, s), tb in tick_b.items():
        key = c * m + i
        tbl["B_C"][tb, s] = c
        tbl["B_I"][tb, s] = i
        tbl["B_A"][tb, s] = key % Da
        is_last_seg = (s == p - 1 and c == v - 1)
        tbl["B_G"][tb, s] = -1 if is_last_seg else key % Dg
        dst_s = (s - 1) % p
        if s > 0:
            tbl["RB"][tb, dst_s] = key % Dg
        elif c > 0:
            tbl["RB"][tb, dst_s] = ((c - 1) * m + i) % Dg
        # chunk 0 on stage 0: input grad, discarded
    busy = sum(len(d) for d in done)
    return {"tables": tbl, "T": T, "Df": Df, "Da": Da, "Dg": Dg,
            "num_stages": p, "num_microbatches": m, "num_chunks": v,
            "events": events, "tick_f": tick_f, "tick_b": tick_b,
            "busy_micro_steps": busy}


def schedule_efficiency(sched: Dict, bwd_cost: float = 2.0,
                        fwd_cost: float = 1.0) -> float:
    """Lockstep efficiency of the ACTUAL tick tables: each tick lasts as long
    as the busiest stage (devices sync at the end-of-tick ppermute), so
    wall = Σ_t max_s(stage s's work at tick t) and ideal = one stage's total
    useful work (every stage does the same M·v forwards + M·v backwards).
    ``bwd_cost`` is the backward micro-step cost in forward units: 2.0 for
    the stash policy (pure transpose), 3.0 for recompute (+1 forward).

    This is the engine's own schedule measured in work units — it replaces
    the analytic M/(M+P-1) (which ignores warmup/cooldown asymmetry and the
    f-vs-b cost split)."""
    tbl = sched["tables"]
    m, v = sched["num_microbatches"], sched["num_chunks"]
    per_stage = (np.where(tbl["F_C"] >= 0, fwd_cost, 0.0)
                 + np.where(tbl["B_C"] >= 0, bwd_cost, 0.0))  # [T, P]
    wall = float(per_stage.max(axis=1).sum())
    ideal = m * v * (fwd_cost + bwd_cost)
    return ideal / wall


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class OneFOneBLayers(GPipeLayers):
    """Pipeline module running the 1F1B (``num_virtual_stages`` 1) or
    interleaved schedule through :meth:`loss_and_grads` /
    :meth:`train_batch` (module docstring).  With v > 1 stage s owns the
    global segments ``{c*P + s : c < v}``; the layers are stacked
    stage-major (``_row_order``), so a stage's segments are contiguous rows.
    ``forward`` runs the layers in their global order (GPipe's schedule at
    v 1), for evaluation.  ``segments_run`` counts segment forwards of the
    schedule, ``segments_recomputed`` the recompute policy's reruns."""

    def __init__(self, layers: Sequence[nn.Module], mesh, num_microbatches: int,
                 loss_fn: Callable, num_virtual_stages: int = 1, pipe_axis: str = "pipe",
                 recompute="auto", stash_budget_bytes: Optional[int] = None):
        p = max(1, mesh.shape[pipe_axis])
        v = int(num_virtual_stages)
        if v < 1:
            raise ValueError("num_virtual_stages must be >= 1")
        if recompute not in (True, False, "auto"):
            raise ValueError(f"recompute={recompute!r}: must be True, False or 'auto'")
        if len(layers) % (p * v) != 0:
            raise ValueError(f"{len(layers)} layers not divisible by pipe degree {p} x "
                             f"virtual stages {v}")
        ell = len(layers) // (p * v)
        order = [g * ell + j for s in range(p) for c in range(v)
                 for g in (c * p + s,) for j in range(ell)]
        self._row_order = np.asarray(order, np.int64)
        self._inv_order = np.argsort(self._row_order)
        super().__init__([layers[i] for i in order], mesh, num_microbatches, pipe_axis)
        self._v, self._ell = v, ell
        self._loss_fn = loss_fn
        self._recompute = recompute
        self._stash_budget = stash_budget_bytes
        self.stash_by_key: Dict = {}      # input shape -> True: the stash policy
        self._sched_cache: Optional[Dict] = None
        self.segments_recomputed = 0
        self._telemetry_programs: Dict = {}   # input shape -> its TracedProgram

    def _register_telemetry(self, key, x) -> None:
        """The analytic collective profile of one 1F1B step: every tick
        sends a forward and a backward activation hop (a permute), and the
        loss is summed once; registered per input shape, its execution
        counter bumped each ``loss_and_grads``."""
        p = self._mesh.shape[self._pipe_axis]
        if p <= 1:
            return
        try:
            from .. import telemetry

            T = self._sched()["T"]
            mb = x.shape[0] // self.num_microbatches
            act_bytes = int(np.prod((mb,) + tuple(x.shape[1:]))) * x.element_size()
            self._telemetry_programs[key] = telemetry.register_traced_program(
                f"OneFOneB_p{p}m{self.num_microbatches}v{self._v}_"
                f"{'x'.join(map(str, x.shape))}",
                [{"kind": "ppermute", "nbytes": act_bytes, "group_size": p,
                  "count": 2 * T, "axes": [self._pipe_axis]},
                 {"kind": "psum", "nbytes": 4, "group_size": p, "count": 1,
                  "axes": [self._pipe_axis]}])
        except Exception:
            pass

    def _sched(self) -> Dict:
        if self._sched_cache is None:
            self._sched_cache = make_1f1b_schedule(self._mesh.shape[self._pipe_axis],
                                                   self.num_microbatches, self._v)
        return self._sched_cache

    # -- evaluation forward: the global layer order ---------------------------
    def forward(self, x, *extra):
        if self._v == 1:
            return super().forward(x)
        layers = self._layer_params(self._stacked())
        for row in self._inv_order:
            x = self._run(layers[row], x, *extra)
        return x

    # -- the activation policy -------------------------------------------------
    def _budget_bytes(self) -> int:
        if self._stash_budget is not None:
            return int(self._stash_budget)
        dev = self._mesh.axis_devices(self._pipe_axis)[0]
        if dev.type == "cuda":
            return int(torch.cuda.get_device_properties(dev).total_memory * 0.25)
        return 1 << 30

    def _residual_bytes(self, x: torch.Tensor) -> int:
        """Bytes a segment's autograd graph saves on one micro-batch, the
        weight stacks' storage left out: one probe forward of stage 0's
        first segment under ``saved_tensors_hooks``."""
        stacks = self._stacked()
        weights = {s.untyped_storage().data_ptr() for s in stacks}
        seen: Dict[int, int] = {}

        def pack(t):
            ptr = t.untyped_storage().data_ptr()
            if ptr not in weights:
                seen[ptr] = t.untyped_storage().nbytes()
            return t

        h = x.chunk(self.num_microbatches)[0].detach()
        if h.is_floating_point():
            h.requires_grad_()
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            self._segment_fwd(0, 0, h, self._leaves(0, 0, stacks))
        return sum(seen.values())

    def _decide_stash(self, x: torch.Tensor) -> bool:
        if self._recompute != "auto":
            return not self._recompute
        mb = x.chunk(self.num_microbatches)[0]
        need = self._sched()["Da"] * (self._residual_bytes(x) + mb.numel() * mb.element_size())
        return need <= self._budget_bytes()

    # -- one segment -------------------------------------------------------------
    def _rows(self, stage: int, chunk: int) -> slice:
        lo = (stage * self._v + chunk) * self._ell
        return slice(lo, lo + self._ell)

    def _chunk(self, stage: int, chunk: int, stacks) -> List[torch.Tensor]:
        """Stage ``stage``'s chunk ``chunk`` of every stack, detached, on
        the stage's member device."""
        dev = self._mesh.axis_devices(self._pipe_axis)[stage]
        rows = self._rows(stage, chunk)
        return [s.detach()[rows].to(dev) for s in stacks]

    def _leaves(self, stage: int, chunk: int, stacks) -> List[torch.Tensor]:
        """:meth:`_chunk` as leaves that take their own gradient."""
        return [t.requires_grad_() for t in self._chunk(stage, chunk, stacks)]

    def _segment_fwd(self, stage: int, chunk: int, h: torch.Tensor, leaves):
        for params in self._layer_params(leaves):
            h = self._run(params, h)
        return h

    def _is_last(self, stage: int, chunk: int) -> bool:
        return stage == self._mesh.shape[self._pipe_axis] - 1 and chunk == self._v - 1

    # -- the schedule --------------------------------------------------------------
    def loss_and_grads(self, x, y):
        """Run the schedule: (the mean micro-batch loss, f32, and the
        gradients laid out as the stacked parameters: stage-major rows)."""
        m = self.num_microbatches
        if x.shape[0] % m != 0:
            raise ValueError(f"batch {x.shape[0]} not divisible by num_microbatches {m}")
        key = (tuple(x.shape), str(x.dtype), tuple(y.shape), str(y.dtype))
        if key not in self.stash_by_key:
            self.stash_by_key[key] = self._decide_stash(x)
            self._register_telemetry(key, x)
        out = self._run_schedule(x, y, self.stash_by_key[key])
        prog = self._telemetry_programs.get(key)
        if prog is not None:
            prog.record_execution()
        return out

    def _run_schedule(self, x, y, stash: bool):
        P, m = self._mesh.shape[self._pipe_axis], self.num_microbatches
        sched = self._sched()
        tbl, T = sched["tables"], sched["T"]
        devs = self._mesh.axis_devices(self._pipe_axis)
        xs, ys = x.chunk(m), y.chunk(m)
        stacks = self._stacked()
        gacc = [torch.zeros_like(s, requires_grad=False) for s in stacks]
        fbuf: List[Dict] = [{} for _ in range(P)]
        gbuf: List[Dict] = [{} for _ in range(P)]
        abuf: List[Dict] = [{} for _ in range(P)]
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        for t in range(T):
            hops_f, hops_b = [], []
            for s in range(P):
                row = {k: int(v[t, s]) for k, v in tbl.items()}
                if row["B_C"] >= 0:     # the backward lane reads before the forward lane writes
                    c = row["B_C"]
                    dy = gbuf[s].pop(row["B_G"]) if row["B_G"] >= 0 else None
                    dh, dchunk = self._backward(s, c, row["B_I"], abuf[s].pop(row["B_A"]),
                                                dy, ys, stacks, stash)
                    for acc, d in zip(gacc, dchunk):
                        acc[self._rows(s, c)] += d.to(acc.device)
                    if dh is not None:
                        dst = (s - 1) % P
                        hops_b.append((dst, int(tbl["RB"][t, dst]), dh))
                if row["F_C"] >= 0:
                    c, i = row["F_C"], row["F_I"]
                    h = fbuf[s].pop(row["F_SRC"]) if row["F_SRC"] >= 0 else xs[i]
                    entry, out, l = self._forward(s, c, i, h.to(devs[s]), ys, stacks, stash)
                    abuf[s][row["F_STASH"]] = entry
                    if l is not None:
                        loss = loss + l.detach().to(loss.device)
                    else:
                        dst = (s + 1) % P
                        hops_f.append((dst, int(tbl["RF"][t, dst]), out))
            for dst, slot, a in hops_f:      # the ring hops, at the end of the tick
                fbuf[dst][slot] = a.to(devs[dst])
            for dst, slot, a in hops_b:
                gbuf[dst][slot] = a.to(devs[dst])
        return loss, gacc

    def _forward(self, s, c, i, h, ys, stacks, stash):
        """The forward lane: (what the backward lane needs, the activation
        to send, the loss share l/M of the last segment or None)."""
        m = self.num_microbatches
        self.segments_run += 1
        if not stash:
            with torch.no_grad():
                out = self._segment_fwd(s, c, h, self._chunk(s, c, stacks))
                l = self._loss(out, ys[i]) / m if self._is_last(s, c) else None
            return h.detach(), out, l
        first = s == 0 and c == 0
        h = h.detach() if first else h.detach().requires_grad_()
        leaves = self._leaves(s, c, stacks)
        with torch.enable_grad():
            out = self._segment_fwd(s, c, h, leaves)
            if self._is_last(s, c):
                l = self._loss(out, ys[i]) / m
                return (l, h, leaves, first), None, l
        return (out, h, leaves, first), out.detach(), None

    def _backward(self, s, c, i, entry, dy, ys, stacks, stash):
        """The backward lane: (the input's cotangent, None at the first
        segment; the chunk's gradients)."""
        if stash:
            out, h, leaves, first = entry
        else:
            first = s == 0 and c == 0
            h = entry if first else entry.detach().requires_grad_()
            leaves = self._leaves(s, c, stacks)
            self.segments_recomputed += 1
            with torch.enable_grad():
                out = self._segment_fwd(s, c, h, leaves)
                if dy is None:
                    out = self._loss(out, ys[i]) / self.num_microbatches
        inputs = leaves if first else [h] + leaves
        grads = torch.autograd.grad(out, inputs, grad_outputs=dy)
        return (None, list(grads)) if first else (grads[0], list(grads[1:]))

    def _loss(self, out, y) -> torch.Tensor:
        return self._loss_fn(out, y.to(out.device)).float()

    def train_batch(self, data, optimizer, lr_scheduler=None) -> torch.Tensor:
        """One pipeline batch (reference ``pipeline_parallel.py:657``): the
        schedule's gradients added onto the stacked parameters, then the
        optimizer step."""
        x, y = data
        loss, grads = self.loss_and_grads(x, y)
        for param, grad in zip(self._stacked(), grads):
            param.grad = grad if param.grad is None else param.grad + grad
        optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss
