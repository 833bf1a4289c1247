"""Pipeline-parallel programs of the serving Engine
(vita_tpu.parallel.pp_serving).

Under a mesh with a 'pipe' axis of S the Engine's paged KV pool and its
layer params are split by layer: each rank holds its stage's L/S layers
and their pool [L/S, Hkv/model, P, page, hd] and prefill scratch
[L/S, 1, bucket, Hkv/model, hd], so no stage holds another's KV. Its two
device programs become:

- ``pp_prefill_chunk``: one chunk of a prompt through the stage chain:
  stage s runs its layers (writing its own scratch rows) and hands the
  activation to stage s+1 (``parallel.mesh.shift_up``); the other stages
  wait. The first token is then sampled from the final hidden row: with
  the head replicated over 'pipe' on the last stage and sent to every
  rank; with the vocabulary split over ('pipe', 'model') the row goes to
  every rank, each computes its block of the logits, the blocks are
  gathered and every rank samples the same token from the same generator
  state.
- ``pp_decode_chunk``: the S-wave ring. The slots form a [S, Bw] grid;
  wave w's token i is processed by stage s at substep t = w + i*S + s,
  so every stage is busy in steady state and one token completes each
  substep. A stage runs its layers against its pool for the wave it
  holds (the gather modes through their per-pair kernels, once per wave
  of Bw rows; dense through ``moe_ffn``; int8 pools with their scales),
  the last stage finishes the token (or, under the vocabulary split,
  every stage computes its block of the logits and the rank owning the
  token's embedding row supplies it) and the ring's wrap carries the new
  token's embedding to stage 0. The tokens then go from the last stage to
  every rank. Emission keeps the fed-token convention of
  ``sampling.decode_chunk``.

'model' and 'expert' axes inside a stage run through
``parallel.sharded_ops`` as on a mesh without 'pipe'. Every rank runs the
same host loop, so the collectives line up.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from vita_tpu_torch.models import mixtral
from vita_tpu_torch.ops.norms import rms_norm
from vita_tpu_torch.parallel.mesh import MODEL, PIPE, axis, broadcast_from, shift_up
from vita_tpu_torch.parallel.pipeline import ring_item, ring_shift
from vita_tpu_torch.sampling import sample_tokens


def _finish(llm_params, h, generator, knobs, mode, mesh, vocab_split: bool, owner: bool):
    """The tokens sampled from the final hidden rows ``h`` [B, D] held on
    the last stage (None elsewhere), and their embeddings [B, D], both on
    every rank that takes part: the last stage's ranks only with the head
    replicated over 'pipe' (``owner`` True there), every rank under the
    vocabulary split."""
    if vocab_split:
        a = axis(mesh, PIPE)
        last = a.size - 1
        b, d = knobs[0].shape[0], llm_params["ln_final"].shape[0]
        if h is None:
            h = torch.empty(b, d, dtype=llm_params["ln_final"].dtype,
                            device=llm_params["ln_final"].device)
        h = broadcast_from([h], mesh, PIPE, last)[0]
        axes = (PIPE, MODEL)
        logits = mixtral.lm_logits(llm_params, h, mesh, axes)
        tok = sample_tokens(logits, generator, *knobs, mode=mode)
        return tok, mixtral.embed_tokens(llm_params, tok, mesh, axes)
    if not owner:
        return None, None
    logits = mixtral.lm_logits(llm_params, h, mesh)
    tok = sample_tokens(logits, generator, *knobs, mode=mode)
    return tok, mixtral.embed_tokens(llm_params, tok, mesh)


@torch.no_grad()
def pp_prefill_chunk(llm_params, llm_cfg: mixtral.MixtralConfig, job, generator, mesh,
                     vocab_split: bool) -> torch.Tensor:
    """One prefill chunk of ``job`` (serve.engine._PrefillJob: the prompt's
    embeddings on every rank, this stage's scratch, the request's sampling
    knobs on the device) through the stage
    chain; its rows land in each stage's own scratch in place. Returns the
    token after row ``true_len - 1`` [1] int32 on every rank (meaningful
    on the last chunk)."""
    a = axis(mesh, PIPE)
    s, n = a.rank, a.size
    off, chunk = job.offset, job.chunk
    dev = job.embeds.device
    x = job.embeds[:, off:off + chunk]
    cache = {"k": job.sk, "v": job.sv,
             "pos": torch.full((1,), off, dtype=torch.int32, device=dev)}
    positions = off + torch.arange(chunk, device=dev)[None]
    valid = torch.arange(job.bucket, device=dev)[None] < off + chunk
    y = x
    for t in range(n):
        if s == t:
            y, _ = mixtral.run_layers(llm_params["layers"], llm_cfg, y, positions, valid, cache,
                                      mesh=mesh)
        if t < n - 1:  # stage t hands the chunk on to stage t+1
            got = shift_up([y], mesh, PIPE, send=s == t, recv=s == t + 1)
            if got is not None:
                y = got[0]
    row = min(max(job.true_len - 1 - off, 0), chunk - 1)
    h = rms_norm(y[:, row], llm_params["ln_final"], llm_cfg.rms_eps) if s == n - 1 else None
    tok, _ = _finish(llm_params, h, generator, job.knobs, job.mode, mesh, vocab_split,
                     s == n - 1)
    if vocab_split:
        return tok
    if tok is None:
        tok = torch.zeros(1, dtype=torch.int32, device=dev)
    return broadcast_from([tok], mesh, PIPE, n - 1)[0]


@torch.no_grad()
def pp_decode_chunk(
    llm_params,  # this stage's decode params (layers [L/S, ...]; the head)
    cache: Dict[str, Any],  # this stage's pool {k_pages, v_pages[, k_scale, v_scale]}
    table: torch.Tensor,  # [W, Bw, max_pages] int32
    tok: torch.Tensor,  # [W, Bw] int32: last sampled, kv not yet written
    pos: torch.Tensor,  # [W, Bw] int32
    active: torch.Tensor,  # [W, Bw] bool
    temperature: torch.Tensor,  # [W, Bw]
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    generator: torch.Generator,
    *,
    llm_cfg: mixtral.MixtralConfig,
    chunk_len: int,
    sampling_mode: str,
    mesh,
    vocab_split: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Advance every wave ``chunk_len`` tokens through the S-stage ring,
    writing each stage's pool in place. Returns (tokens fed [W, Bw,
    chunk_len], next token [W, Bw], pos + chunk_len) on every rank."""
    a = axis(mesh, PIPE)
    s, n = a.rank, a.size
    w_waves, bw = tok.shape
    if w_waves != n:
        raise ValueError(f"wave count {w_waves} != pipe stages {n}")
    dev = tok.device
    last = n - 1
    n_items = n * chunk_len
    axes = mixtral.vocab_axes(llm_params, llm_cfg, mesh)
    # every wave's first input, looked up once (a collective under the split)
    x0 = mixtral.embed_tokens(llm_params, tok.reshape(-1), mesh, axes)
    x0 = x0.reshape(w_waves, bw, 1, -1).to(llm_cfg.dtype)
    samples = torch.zeros(w_waves, chunk_len, bw, dtype=torch.int32, device=dev)
    held = None
    for t in range(n_items + n - 1):
        it = ring_item(s, t, n, n_items)
        out = x0[0]
        y = None
        if it is not None:
            _, wave, itok = it
            x = x0[wave] if (s == 0 and itok == 0) else held
            pos_w = pos[wave] + itok
            c = dict(cache)
            c.update(table=table[wave], pos=pos_w, active=active[wave])
            y, _ = mixtral.run_layers(llm_params["layers"], llm_cfg, x, pos_w[:, None], cache=c,
                                      mesh=mesh, pairs=True)
            out = y
        # the last stage finishes wave (t-(S-1)) mod S, token (t-(S-1)) // S
        fin = ring_item(last, t, n, n_items)
        if fin is not None:
            _, w_f, i_f = fin
            h = rms_norm(y, llm_params["ln_final"], llm_cfg.rms_eps)[:, 0] if s == last else None
            knobs = (temperature[w_f], top_k[w_f], top_p[w_f])
            tok_new, emb = _finish(llm_params, h, generator, knobs, sampling_mode, mesh,
                                   vocab_split, s == last)
            if tok_new is not None:
                samples[w_f, i_f] = tok_new
            if s == last:
                # the ring's wrap carries the new token's embedding to stage 0
                out = emb[:, None].to(y.dtype)
        held = ring_shift([out], mesh, t, n_items)
        held = None if held is None else held[0]
    if not vocab_split:
        samples = broadcast_from([samples], mesh, PIPE, last)[0]
    samples = samples.permute(0, 2, 1)  # [W, Bw, chunk_len]
    # the fed-token convention (sampling.decode_chunk): emit the token fed
    # at each step; the last step's sample is the next chunk's input
    toks_fed = torch.cat([tok[:, :, None], samples[:, :, :-1]], dim=2)
    return toks_fed, samples[:, :, -1].contiguous(), pos + chunk_len
