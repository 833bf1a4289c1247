"""Token sampling and multi-token decode chunks (vita_tpu.sampling).

``decode_chunk`` advances every slot ``chunk_len`` tokens over the paged KV
pool or the linear cache (a Python loop over steps; the JAX package scans
on device), with sampling on the device, so the host reads back one small
[B, chunk_len] int32 array per chunk. Random draws come from a ``torch.Generator``; they
are not the JAX package's bits, so only greedy decoding is comparable
token for token. Under a serving ``mesh`` every rank runs the same steps
on the same full logits with a generator of the same seed, so every rank
draws the same tokens.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from vita_tpu_torch.models import mixtral

NEG_INF = float(torch.finfo(torch.float32).min)


def choose_sampling_mode(temperatures, top_ks, top_ps) -> str:
    """Cheapest tier covering the given requests: 'greedy' needs only an
    argmax, 'categorical' adds Gumbel sampling, 'filtered' pays a
    full-vocab sort for top-k/top-p."""
    ts = np.atleast_1d(np.asarray(temperatures))
    ks = np.atleast_1d(np.asarray(top_ks))
    ps = np.atleast_1d(np.asarray(top_ps))
    if np.any((ks > 0) | (ps < 1.0)):
        return "filtered"
    if np.any(ts > 0.0):
        return "categorical"
    return "greedy"


def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits) by the Gumbel-max trick."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    return (logits + gumbel).argmax(-1)


def sample_tokens(
    logits: torch.Tensor,  # [B, V]
    generator: torch.Generator,
    temperature: torch.Tensor,  # [B] float; <= 0 -> greedy
    top_k: torch.Tensor,  # [B] int; <= 0 -> disabled
    top_p: torch.Tensor,  # [B] float; >= 1 -> disabled
    mode: str = "filtered",
) -> torch.Tensor:
    """One token per row, int32. Greedy rows are the exact argmax; sampled
    rows apply top-k then top-p to the temperature-scaled distribution.
    ``mode`` (choose_sampling_mode) must cover the knobs."""
    v = logits.shape[-1]
    greedy = logits.argmax(-1).to(torch.int32)
    if mode == "greedy":
        return greedy
    x = logits.float() / temperature.float().clamp_min(1e-6)[:, None]
    if mode == "categorical":
        sampled = _categorical(x, generator).to(torch.int32)
        return torch.where(temperature <= 0.0, greedy, sampled)
    x_sorted, order = torch.sort(x, dim=-1, descending=True)
    ranks = torch.arange(v, device=x.device)[None, :]
    k = torch.where(top_k > 0, top_k.clamp(1, v), v)[:, None]
    keep = ranks < k
    masked = torch.where(keep, x_sorted, NEG_INF)
    probs = torch.softmax(masked, dim=-1)
    csum_excl = torch.cumsum(probs, dim=-1) - probs
    keep = keep & (csum_excl < top_p.float().clamp(1e-6, 1.0)[:, None])
    idx = _categorical(torch.where(keep, x_sorted, NEG_INF), generator)
    sampled = order.gather(-1, idx[:, None])[:, 0].to(torch.int32)
    return torch.where(temperature <= 0.0, greedy, sampled)


@torch.no_grad()
def decode_chunk(
    llm_params: Dict[str, Any],
    cache: Dict[str, Any],  # paged pool or linear {'k','v','pos'} cache
    tok: torch.Tensor,  # [B] int32 — last sampled, kv not yet written
    pos: torch.Tensor,  # [B] int32 — cache row each slot writes next
    active: torch.Tensor,  # [B] bool
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    generator: torch.Generator,
    *,
    llm_cfg: mixtral.MixtralConfig,
    chunk_len: int,
    sampling_mode: str = "filtered",
    mesh=None,  # a serving mesh over which llm_params are this rank's shards
) -> Tuple[Dict[str, Any], torch.Tensor, torch.Tensor]:
    """Run ``chunk_len`` decode steps over the paged pool or the linear
    cache, updating it in place.

    Emits the *fed* token at each step (the last step's sample is returned
    as the new ``tok``). Inactive slots neither write kv nor attend: on the
    linear cache they write at row ``max_len``, which is dropped. An int8
    pool's scale tensors ride in the cache and are updated in place with
    the pages.
    Returns (cache with the advanced ``pos``, tokens [B, chunk_len],
    next_tok [B])."""
    paged = "k_pages" in cache
    if not paged:
        max_len = cache["k"].shape[2]
        rows = torch.arange(max_len, device=pos.device)[None, :]
    fed = []
    for _ in range(chunk_len):
        c = dict(cache)
        valid = None
        if paged:
            c.update({"pos": pos, "active": active})
        else:
            c["pos"] = torch.where(active, pos, max_len)
            valid = (rows <= pos[:, None]) & active[:, None]
        logits, _, _ = mixtral.forward(
            llm_params, llm_cfg, input_ids=tok[:, None],
            positions=pos[:, None], attn_valid=valid, cache=c, mesh=mesh,
        )
        nxt = sample_tokens(logits[:, -1], generator, temperature, top_k, top_p,
                            mode=sampling_mode)
        fed.append(tok)
        tok, pos = nxt, pos + 1
    new_cache = dict(cache)
    new_cache["pos"] = pos
    return new_cache, torch.stack(fed, dim=1), tok
