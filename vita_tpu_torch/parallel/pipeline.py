"""Pipeline parallelism over the mesh's 'pipe' axis
(vita_tpu.parallel.pipeline).

The layer stack is split by layer: stage s (the rank's coordinate on
'pipe') holds the contiguous layers [s*L/S, (s+1)*L/S) as the leading
block of every stacked [L, ...] leaf (``stage_reshape``; a spec led by
'pipe' cuts the same block). Activations move between stages point to
point (``parallel.mesh.shift_up``): a chain for the GPipe schedules and a
cycle for the decode ring. Every schedule runs in lockstep steps, each
rank computing where its step holds work and then taking part in the
step's shift with exactly the sends and receives its peers expect, so
no step waits on a rank that is still computing another step's work.
Bubble steps compute and write nothing.

- ``pipeline_layer_stack``: GPipe with M microbatches over S stages in
  M+S-1 steps, the training and cacheless path. ``torch.distributed``
  point-to-point carries no autograd, so it is one
  ``torch.autograd.Function`` whose backward runs the reverse schedule
  itself: for each microbatch a stage receives dL/dy from stage s+1,
  takes ``torch.autograd.grad`` through its own layers and sends dL/dx to
  stage s-1. Without ``remat`` the forward keeps each microbatch's graph;
  with it the backward recomputes the microbatch's stage forward first.
  The final activations are broadcast from the last stage, so every rank
  computes the loss; the last stage alone feeds dL/d(output) back (the
  others' copies would count it S times), and the gradient of the
  stage-0 input is broadcast back to every rank, so leaves replicated
  over 'pipe' upstream of the stack (the embedding, and through it the
  towers and projectors) hold the whole gradient on every rank.
- ``pipeline_prefill_kv``: the same forward schedule over W waves that
  also keeps each stage's own layers' KV rows [L/S, W, B, T, Hkv, hd].
- ``pipeline_decode_greedy``: W == S waves ride the cyclic ring; the last
  stage finishes each token (head, argmax) and the wrap carries the new
  token's embedding to stage 0; the tokens then go from the last stage
  to every rank.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from vita_tpu_torch.parallel.mesh import (
    PIPE,
    all_reduce_sum,
    axis,
    broadcast_from,
    shift_down,
    shift_up,
)

__all__ = ["PIPE", "stage_reshape", "pipeline_layer_stack", "pipeline_prefill_kv",
           "pipeline_decode_greedy"]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [] if tree is None else [tree]


def _unflatten(tree, leaves):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def stage_reshape(stacked: Any, n_stages: int) -> Any:
    """[L, ...] leaf tree -> [S, L/S, ...] (views)."""
    def r(x):
        if x.shape[0] % n_stages:
            raise ValueError(
                f"layer count {x.shape[0]} not divisible by pipe_stages={n_stages}")
        return x.reshape((n_stages, x.shape[0] // n_stages) + tuple(x.shape[1:]))

    return _tree_map(r, stacked)


def _check_mesh(mesh, n_stages: int, what: str = "pipe_stages") -> None:
    if mesh is None or PIPE not in mesh.mesh_dim_names:
        names = None if mesh is None else tuple(mesh.mesh_dim_names)
        raise ValueError(f"mesh has no '{PIPE}' axis: {names}")
    if axis(mesh, PIPE).size != n_stages:
        raise ValueError(f"pipe axis size {axis(mesh, PIPE).size} != {what} {n_stages}")


def _layers_of(params) -> int:
    return _leaves(params)[0].shape[0]


# ---------------------------------------------------------------------------
# GPipe over the layer stack (training, cacheless forward)
# ---------------------------------------------------------------------------
class _Plan:
    """What the GPipe Function needs besides its tensor inputs."""

    def __init__(self, mesh, layer_body, params_tree, consts, n_micro, remat):
        self.mesh, self.body, self.tree = mesh, layer_body, params_tree
        self.consts, self.m, self.remat = consts, n_micro, remat
        a = axis(mesh, PIPE)
        self.s, self.n = a.rank, a.size

    def consts_of(self, j: int):
        """Microbatch j's rows of every per-sample constant."""
        return _tree_map(lambda c: c.chunk(self.m, 0)[j], self.consts)

    def run_stage(self, params, x, j: int):
        """This stage's layers on microbatch j: (y, aux summed over them)."""
        cmb = self.consts_of(j)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(_layers_of(params)):
            x, a = self.body(_tree_map(lambda p: p[i], params), x, cmb)
            aux = aux + a
        return x, aux


def _valid(j: int, m: int) -> bool:
    return 0 <= j < m


def _gpipe_forward(plan: _Plan, x: torch.Tensor, leaves, keep: bool):
    """The forward schedule: (x_out [B, ...] on every rank, aux total
    over stages and microbatches, per-microbatch records). With ``keep``
    each record holds the microbatch's graph through this stage: (x_in
    leaf, y, aux, parameter aliases); else (x_in, None, None, None)."""
    s, n, m = plan.s, plan.n, plan.m
    x_mb = x.chunk(m, 0)
    if keep:
        aliases = [l.detach().requires_grad_(l.requires_grad) for l in leaves]
    else:
        aliases = list(leaves)
    params = _unflatten(plan.tree, aliases)
    records: Dict[int, tuple] = {}
    outs: List[Optional[torch.Tensor]] = [None] * m
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    held = None  # the activation received for this step
    for t in range(m + n - 1):
        j = t - s  # the microbatch this stage holds at step t
        y = None
        if _valid(j, m):
            x_in = (x_mb[j] if s == 0 else held).detach()
            if keep:
                x_in.requires_grad_(True)
                with torch.enable_grad():
                    y, aux = plan.run_stage(params, x_in, j)
                records[j] = (x_in, y, aux, aliases)
            else:
                y, aux = plan.run_stage(params, x_in, j)
                records[j] = (x_in, None, None, None)
            aux_sum = aux_sum + aux.detach()
            if s == n - 1:
                outs[j] = y.detach()
        # step t's shift: microbatch j goes on to stage s+1, which holds it
        # at step t+1; this stage receives microbatch j+1 from stage s-1
        held = shift_up([x_mb[0] if y is None else y.detach()], plan.mesh, PIPE,
                        send=_valid(j, m), recv=_valid(j + 1, m))
        held = None if held is None else held[0]
    x_out = torch.cat(outs, 0) if s == n - 1 else torch.empty_like(x)
    x_out = broadcast_from([x_out], plan.mesh, PIPE, n - 1)[0]
    aux_total = all_reduce_sum(aux_sum, plan.mesh, PIPE)
    return x_out, aux_total, records


class _GPipe(torch.autograd.Function):

    @staticmethod
    def forward(ctx, plan, x, *leaves):
        x_out, aux_total, records = _gpipe_forward(plan, x, leaves, keep=not plan.remat)
        ctx.plan, ctx.records = plan, records
        ctx.save_for_backward(*leaves)
        return x_out, aux_total / plan.m

    @staticmethod
    def backward(ctx, d_out, d_aux):
        plan, records = ctx.plan, ctx.records
        leaves = ctx.saved_tensors
        s, n, m = plan.s, plan.n, plan.m
        want = [l.requires_grad for l in leaves]
        grads = [torch.zeros(l.shape, dtype=torch.float32, device=l.device) if w else None
                 for l, w in zip(leaves, want)]
        d_out_mb = d_out.chunk(m, 0)
        # each stage's aux terms enter aux_total / M once, on every rank
        # alike: a rank's own terms take the cotangent, summed nowhere
        d_aux = d_aux / m
        dx_mb: List[Optional[torch.Tensor]] = [None] * m
        template = None
        held = None
        # the reverse chain: stage S-1 holds microbatch j at step j, stage s
        # at step j + (S-1-s)
        for t in range(m + n - 1):
            j = t - (n - 1 - s)
            dx = None
            if _valid(j, m):
                x_in, y, aux, aliases = records.pop(j)
                if y is None:  # remat: recompute this stage on microbatch j
                    aliases = [l.detach().requires_grad_(w) for l, w in zip(leaves, want)]
                    x_in = x_in.detach().requires_grad_(True)
                    with torch.enable_grad():
                        y, aux = plan.run_stage(_unflatten(plan.tree, aliases), x_in, j)
                # every rank computed the loss from the same x_out: the last
                # stage alone feeds its cotangent back
                dy = d_out_mb[j] if s == n - 1 else held
                inputs = [x_in] + [a for a, w in zip(aliases, want) if w]
                outs, cots = [y], [dy.to(y.dtype)]
                if aux.requires_grad:
                    outs.append(aux)
                    cots.append(d_aux)
                got = torch.autograd.grad(outs, inputs, cots, allow_unused=True)
                dx = got[0] if got[0] is not None else torch.zeros_like(x_in)
                it = iter(got[1:])
                for i, w in enumerate(want):
                    if w:
                        g = next(it)
                        if g is not None:
                            grads[i] += g.float()
                if s == 0:
                    dx_mb[j] = dx
                template = dx
            if template is None:
                template = d_out_mb[0]
            # dL/dx of microbatch j goes down to stage s-1, which holds it at
            # step t+1; this stage receives dL/dy of microbatch j+1 from s+1
            got = shift_down([dx if dx is not None else template], plan.mesh, PIPE, cycle=False,
                             send=_valid(j, m), recv=_valid(j + 1, m))
            held = None if got is None else got[0]
        # the stage-0 input's gradient reaches every rank
        dx_all = torch.cat(dx_mb, 0) if s == 0 else torch.empty_like(d_out)
        dx_all = broadcast_from([dx_all], plan.mesh, PIPE, 0)[0]
        out = [None if g is None else g.to(l.dtype) for g, l in zip(grads, leaves)]
        return (None, dx_all, *out)


def pipeline_layer_stack(
    mesh,
    layer_body: Callable[[Any, torch.Tensor, Any], Tuple[torch.Tensor, torch.Tensor]],
    stage_params: Any,  # this stage's [L/S, ...] leaf tree
    x: torch.Tensor,  # [B, S_seq, D], the same on every rank of 'pipe'
    consts: Any,  # tree of [B, ...] per-sample tensors (None leaves allowed)
    n_stages: int,
    n_microbatches: int,
    remat: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``layer_body`` over the whole layer stack as an S-stage GPipe.

    ``layer_body(lp, x_mb, consts_mb) -> (x_mb, aux scalar)`` applies ONE
    layer (``lp`` that layer's leaves) to one microbatch (``consts_mb``
    its rows of ``consts``). Returns (x_out [B, S_seq, D] on every rank,
    aux summed over layers and averaged over microbatches).

    The MoE load-balance aux is nonlinear in its batch statistics, so the
    average over microbatches is not the whole batch's aux (the standard
    GPipe property); the outputs and their gradients are exact.
    Differentiable in ``x`` and the stage's leaves; every rank of 'pipe'
    calls it in the same order."""
    _check_mesh(mesh, n_stages)
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} not divisible by microbatches {n_microbatches}")
    leaves = _leaves(stage_params)
    plan = _Plan(mesh, layer_body, stage_params, consts, n_microbatches, remat)
    if torch.is_grad_enabled() and (x.requires_grad or any(l.requires_grad for l in leaves)):
        return _GPipe.apply(plan, x, *leaves)
    x_out, aux_total, _ = _gpipe_forward(plan, x, leaves, keep=False)
    return x_out, aux_total / n_microbatches


# ---------------------------------------------------------------------------
# GPipe prefill that keeps each stage's KV rows
# ---------------------------------------------------------------------------
def pipeline_prefill_kv(
    mesh,
    layer_body: Callable,  # (lp, x [B,T,D], consts_w, kv_zeros) -> (x, k, v)
    stage_params: Any,  # this stage's [L/S, ...] leaf tree
    x: torch.Tensor,  # [W, B, T, D] wave-major prompt embeddings, on every rank
    consts: Any,  # tree of [W, B, ...] per-wave tensors
    kv_template: torch.Tensor,  # [B, T_max, Hkv, hd] zeros (write target)
    n_stages: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GPipe prefill over W waves (microbatches) that also keeps the KV
    rows of this stage's layers in the wave-major layout
    ``pipeline_decode_greedy`` reads: [L/S, W, B, T_max, Hkv, hd], each
    wave's rows written as it passes through the stage.

    ``layer_body(lp, x, consts_w, kv_zeros)`` applies ONE layer to one
    wave and returns (x_out, k, v): ``kv_zeros`` (a fresh copy of the
    template) with the prompt's rows written. Returns (x_out [W, B, T, D]
    on every rank, cache_k, cache_v of this stage)."""
    _check_mesh(mesh, n_stages, "n_stages")
    a = axis(mesh, PIPE)
    s, n = a.rank, a.size
    n_local = _layers_of(stage_params)
    w_waves = x.shape[0]
    shape = (n_local, w_waves) + tuple(kv_template.shape)
    ck = torch.zeros(shape, dtype=kv_template.dtype, device=x.device)
    cv = torch.zeros_like(ck)
    outs: List[Optional[torch.Tensor]] = [None] * w_waves
    held = None
    for t in range(w_waves + n - 1):
        j = t - s  # the wave this stage holds at step t
        y = None
        if _valid(j, w_waves):
            cw = _tree_map(lambda c: c[j], consts)
            y = x[j] if s == 0 else held
            for i in range(n_local):
                y, k, v = layer_body(_tree_map(lambda p: p[i], stage_params), y, cw,
                                     kv_template.clone())
                ck[i, j], cv[i, j] = k, v
            if s == n - 1:
                outs[j] = y
        held = shift_up([x[0] if y is None else y], mesh, PIPE, send=_valid(j, w_waves),
                        recv=_valid(j + 1, w_waves))
        held = None if held is None else held[0]
    x_out = torch.stack(outs) if s == n - 1 else torch.empty_like(x)
    return broadcast_from([x_out], mesh, PIPE, n - 1)[0], ck, cv


# ---------------------------------------------------------------------------
# the decode ring
# ---------------------------------------------------------------------------
def ring_item(stage: int, t: int, n_stages: int, n_items: int):
    """(item, wave, token index) stage ``stage`` holds at substep ``t`` of
    the decode ring, or None for a bubble: wave w's token i is item
    j = i*S + w, held by stage s at substep t = j + s."""
    j = t - stage
    if not 0 <= j < n_items:
        return None
    return j, j % n_stages, j // n_stages


def ring_needs_input(stage: int, t: int, n_stages: int, n_items: int) -> bool:
    """Whether ``stage`` receives its input over the ring at substep t:
    it holds an item, and that item is not a wave's first token on stage
    0 (which comes from the feed)."""
    it = ring_item(stage, t, n_stages, n_items)
    return it is not None and not (stage == 0 and it[2] == 0)


def ring_shift(tensors, mesh, t: int, n_items: int):
    """Substep t's shift of the decode ring: this stage sends ``tensors``
    to stage s+1 (the last to stage 0) when that stage takes its input
    over the ring at substep t+1, and receives its own input of substep
    t+1. Returns the received tensors or None."""
    a = axis(mesh, PIPE)
    s, n = a.rank, a.size
    nxt, prv = (s + 1) % n, (s - 1) % n
    send = ring_needs_input(nxt, t + 1, n, n_items)
    recv = ring_needs_input(s, t + 1, n, n_items)
    if n == 1:
        return list(tensors) if send else None
    return shift_up(tensors, mesh, PIPE, cycle=True, send=send, recv=recv)


def pipeline_decode_greedy(
    mesh,
    stage_fn: Callable,  # (lp_local, ck_w, cv_w, x, positions, kv_valid, cache_pos) -> y
    finish_fn: Callable,  # (head_params, y [B,1,D]) -> (tok [B] i32, emb [B,1,D])
    stage_params: Any,  # this stage's [L/S, ...] leaf tree
    head_params: Any,  # final norm / lm_head / embed, whole on the last stage
    cache_k: torch.Tensor,  # [L/S, W, B, T_max, Hkv, hd] this stage's rows, in place
    cache_v: torch.Tensor,
    x0: torch.Tensor,  # [W, B, 1, D] first-token embeddings per wave
    pos0: torch.Tensor,  # [W, B] int32 rows already cached
    n_tokens: int,
) -> torch.Tensor:
    """Ring-schedule pipeline-parallel greedy decode: W == S waves in
    flight. At every substep each stage applies its L/S layers to the
    wave it holds (``stage_fn`` writes the token's kv rows into that
    wave's cache in place and returns the stage's output); the last stage
    finishes the token (``finish_fn``: head and argmax) and the wrap
    carries the new token's embedding to stage 0 for that wave's next
    token. Wave w's token i is processed by stage s at substep
    t = w + i*S + s, so one token completes each substep after the first
    S-1. Returns tokens [W, n_tokens, B] int32 on every rank (sent from
    the last stage); the caches advance in place, so calls chain."""
    if mesh is None or PIPE not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no '{PIPE}' axis")
    a = axis(mesh, PIPE)
    s, n = a.rank, a.size
    w_waves, b = pos0.shape
    if w_waves != n:
        raise ValueError(f"wave count {w_waves} must equal pipe stages {n}")
    t_max = cache_k.shape[3]
    n_items = n * n_tokens
    toks = torch.zeros(w_waves, n_tokens, b, dtype=torch.int32, device=x0.device)
    rows = torch.arange(t_max, device=x0.device)[None, :]
    held = None
    for t in range(n_items + n - 1):
        it = ring_item(s, t, n, n_items)
        out = x0[0]
        if it is not None:
            _, wave, itok = it
            x = x0[wave] if (s == 0 and itok == 0) else held
            pos_w = pos0[wave] + itok
            y = stage_fn(stage_params, cache_k[:, wave], cache_v[:, wave], x,
                         pos_w[:, None], rows <= pos_w[:, None], pos_w)
            out = y
            if s == n - 1:
                tok, emb = finish_fn(head_params, y)
                toks[wave, itok] = tok
                out = emb.to(y.dtype)
        held = ring_shift([out], mesh, t, n_items)
        held = None if held is None else held[0]
    return broadcast_from([toks], mesh, PIPE, n - 1)[0]
