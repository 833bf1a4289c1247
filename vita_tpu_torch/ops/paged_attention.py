"""Paged KV cache: the page pool, its host-side allocator, page writes and
paged decode attention (vita_tpu.ops.paged_attention, bf16/f32 or int8
pools).

The pool keeps the JAX layout {'k_pages','v_pages'} [L, Hkv, P, page, d];
an int8 pool (``quantized=True``) adds float32 'k_scale'/'v_scale'
[L, Hkv, P, 1, page], one symmetric scale per (row, kv head). The writers
update the pool IN PLACE (the JAX package donates the buffers instead) and
return the same tensors; with scales they quantize the rows on the way in,
bit for bit as the JAX package does.

Writes that JAX's scatter would drop are masked explicitly, since torch
indexing raises or writes out of bounds instead: rows of inactive slots,
page ids at or past the pool size (the sentinel in unused table entries
and in padded install vectors) and rows past the end of a slot's table.

``paged_attention`` launches the hand-written kernels (csrc/paged_attn.cu,
head dim 128, group <= 8; the int8 variant when given scales) on CUDA
tensors and runs ``paged_attention_plain`` on CPU tensors.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from vita_tpu_torch import kernels


def init_page_pool(
    n_layers: int,
    n_kv_heads: int,
    n_pages: int,
    page_size: int,
    head_dim: int,
    dtype=torch.float32,
    device=None,
    quantized: bool = False,
) -> Dict[str, torch.Tensor]:
    """Device-side page pool: {'k_pages','v_pages'} [L, Hkv, P, page, d];
    ``quantized=True`` stores int8 pages plus float32 row scales
    'k_scale'/'v_scale' [L, Hkv, P, 1, page] (half the bytes per token of
    a bf16 pool)."""
    shape = (n_layers, n_kv_heads, n_pages, page_size, head_dim)
    if not quantized:
        return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
                "v_pages": torch.zeros(shape, dtype=dtype, device=device)}
    sshape = (n_layers, n_kv_heads, n_pages, 1, page_size)
    return {"k_pages": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_pages": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device)}


class PagePool:
    """Host-side free-list allocator over the device page pool."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages))

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate n pages, or None if the pool can't satisfy the request."""
        if n > len(self._free):
            return None
        got, self._free = self._free[:n], self._free[n:]
        return got

    def release(self, pages: Sequence[int]) -> None:
        self._free.extend(int(p) for p in pages)


def pages_needed(tokens: int, page_size: int) -> int:
    return -(-tokens // page_size)


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------
def paged_attention_plain(q, k_pages, v_pages, tables, lengths, layer: int,
                          scale: float, k_scale=None, v_scale=None) -> torch.Tensor:
    """Gather the slot's pages (ids clamped into the pool), dequantize int8
    pages by their row scales, and run masked softmax attention in float32;
    slots with length 0 give zeros."""
    b, hq, d = q.shape
    _, hkv, n_pool, page_size, _ = k_pages.shape
    group = hq // hkv
    t = tables.long().clamp(0, n_pool - 1)
    s_len = t.shape[1] * page_size
    k = k_pages[layer][:, t].reshape(hkv, b, s_len, d).float()
    v = v_pages[layer][:, t].reshape(hkv, b, s_len, d).float()
    if k_scale is not None:
        k = k * k_scale[layer][:, t].reshape(hkv, b, s_len, 1)
        v = v * v_scale[layer][:, t].reshape(hkv, b, s_len, 1)
    qg = q.reshape(b, hkv, group, d).float() * scale
    s = torch.einsum("bhgd,hbsd->bhgs", qg, k)
    mask = torch.arange(s_len, device=q.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m))
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhgs,hbsd->bhgd", p, v) / torch.where(l > 0, l, 1.0)
    return out.reshape(b, hq, d).to(q.dtype)


def paged_attention_cuda(q, k_pages, v_pages, tables, lengths, layer: int,
                         scale: float, k_scale=None, v_scale=None) -> torch.Tensor:
    """Launch csrc/paged_attn.cu (see its header for the design): the
    bf16/f32 kernel, or with row scales its int8 variant."""
    b, hq, d = q.shape
    n_layers, hkv, n_pool, page_size, _ = k_pages.shape
    quant = k_scale is not None
    kernels.require_cuda(q, k_pages, v_pages, tables, lengths,
                         *((k_scale, v_scale) if quant else ()))
    kernels.require(d == 128 and k_pages.shape[4] == 128,
                    f"paged kernel takes head dim 128, got {d}")
    kernels.require(v_pages.shape == k_pages.shape, "k/v pools differ in shape")
    kernels.require(hq // hkv <= 8, f"paged kernel takes a GQA group <= 8, got {hq // hkv}")
    kernels.require(tables.dtype == torch.int32 and lengths.dtype == torch.int32
                    and tables.shape[0] == b and lengths.shape == (b,),
                    "tables [B, max_pages] and lengths [B] must be int32")
    kernels.require(0 <= layer < n_layers, f"layer {layer} outside the pool's {n_layers}")
    o = torch.empty_like(q)
    args = (tables.data_ptr(), lengths.data_ptr(), b, int(layer), hq, hkv, n_pool,
            page_size, tables.shape[1], float(scale))
    if quant:
        sshape = (n_layers, hkv, n_pool, 1, page_size)
        kernels.require(k_pages.dtype == v_pages.dtype == torch.int8
                        and k_scale.dtype == v_scale.dtype == torch.float32
                        and tuple(k_scale.shape) == tuple(v_scale.shape) == sshape,
                        "int8 pools take float32 scales [L, Hkv, P, 1, page]")
        dt = kernels.dtype_code(q)
        if b == 0:
            return o
        err = kernels.lib().vita_paged_attn_q(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), o.data_ptr(), *args, dt, kernels.stream_of(q))
        kernels.check_launch(err, "paged_attention_q")
        kernels.launches["paged_attention_q"] += 1
        return o
    dt = kernels.dtype_code(q, k_pages, v_pages)
    if b == 0:
        return o
    err = kernels.lib().vita_paged_attn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), o.data_ptr(),
        *args, dt, kernels.stream_of(q),
    )
    kernels.check_launch(err, "paged_attention")
    kernels.launches["paged_attention"] += 1
    return o


def paged_attention(
    q: torch.Tensor,  # [B, Hq, d] — one decode token per slot
    k_pages: torch.Tensor,  # [L, Hkv, P, page, d]
    v_pages: torch.Tensor,
    tables: torch.Tensor,  # [B, max_pages] int32
    lengths: torch.Tensor,  # [B] int32 valid kv rows (incl. current token)
    layer: int,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,  # [L, Hkv, P, 1, page] f32 (int8 pool)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Paged decode attention. Returns [B, Hq, d] in q's dtype."""
    hq, hkv = q.shape[1], k_pages.shape[1]
    if hq % hkv:
        raise ValueError(f"q heads ({hq}) not a multiple of kv heads ({hkv})")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("an int8 pool needs both k_scale and v_scale")
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    tables = tables.to(torch.int32)
    lengths = lengths.to(torch.int32)
    if kernels.on_cuda(q):
        return paged_attention_cuda(q.contiguous(), k_pages, v_pages,
                                    tables.contiguous(), lengths.contiguous(),
                                    int(layer), scale, k_scale, v_scale)
    return paged_attention_plain(q, k_pages, v_pages, tables, lengths,
                                 int(layer), scale, k_scale, v_scale)


# ----------------------------------------------------------------------
# page writes
# ----------------------------------------------------------------------
def _quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the last axis: x [..., d] -> (q int8 [..., d],
    scale float32 [...]) with x ~ q * scale. The scale is the max times the
    float32 reciprocal of 127, as XLA computes "/ 127.0" under jit."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) * (1.0 / 127.0)).clamp_min(1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def write_kv_rows(
    k_pages: torch.Tensor,  # [L, Hkv, P, page, d]
    v_pages: torch.Tensor,
    layer: int,
    tables: torch.Tensor,  # [B, max_pages]
    pos: torch.Tensor,  # [B] row to write (0-based)
    k_new: torch.Tensor,  # [B, Hkv, d]
    v_new: torch.Tensor,
    active: Optional[torch.Tensor] = None,  # [B] bool; inactive rows dropped
    k_scale: Optional[torch.Tensor] = None,  # [L, Hkv, P, 1, page] f32 (int8 pool)
    v_scale: Optional[torch.Tensor] = None,
):
    """Write one kv row per slot into its page, in place. Dropped writes
    (inactive slot, page id >= pool size, row past the table width) leave
    the pool untouched. With scales (int8 pool) each (slot, head) row is
    quantized and its scale written beside it; returns the four tensors
    then, the two pools otherwise.

    No host sync: every slot writes at its clamped target, carrying the
    value a kept write to that same row stores there (its own new row, or
    a duplicate slot's, e.g. a batch-padding row that repeats a live slot)
    and otherwise the row's current content."""
    n_pool, page_size = k_pages.shape[2], k_pages.shape[3]
    max_pages = tables.shape[1]
    pos = pos.long()
    slot_page = pos // page_size
    page_id = tables.long().gather(1, slot_page.clamp(0, max_pages - 1)[:, None])[:, 0]
    row = pos % page_size
    keep = (slot_page < max_pages) & (page_id >= 0) & (page_id < n_pool)
    if active is not None:
        keep = keep & active.bool()
    pid = page_id.clamp(0, n_pool - 1)
    target = pid * page_size + row  # [B] row id inside the layer's pool
    hits = (target[:, None] == target[None, :]) & keep[None, :]  # [B, B]
    src = hits.float().argmax(1)  # first kept write to the same row
    has = hits.any(1)
    writes = [(k_pages, k_new), (v_pages, v_new)]
    if k_scale is not None:
        (kq, ks), (vq, vs) = _quantize_rows(k_new), _quantize_rows(v_new)
        writes = [(k_pages, kq), (v_pages, vq)]
        for scales, new in ((k_scale, ks), (v_scale, vs)):  # new [B, Hkv]
            ls = scales[layer][:, :, 0]  # [Hkv, P, page] view
            ls[:, pid, row] = torch.where(has[None, :], new.t()[:, src], ls[:, pid, row])
    for pages, new in writes:
        lp = pages[layer]  # [Hkv, P, page, d] view
        cur = lp[:, pid, row]  # [Hkv, B, d]
        val = torch.where(has[None, :, None], new.to(pages.dtype).transpose(0, 1)[:, src], cur)
        lp[:, pid, row] = val
    if k_scale is not None:
        return k_pages, v_pages, k_scale, v_scale
    return k_pages, v_pages


def install_prefill_pages(
    k_pages: torch.Tensor,  # [L, Hkv, P, page, d]
    v_pages: torch.Tensor,
    k_lin: torch.Tensor,  # [L, 1, S, Hkv, d] prefill scratch (S page-multiple)
    v_lin: torch.Tensor,
    page_ids: torch.Tensor,  # [S / page] destination pages
    k_scale: Optional[torch.Tensor] = None,  # [L, Hkv, P, 1, page] f32 (int8 pool)
    v_scale: Optional[torch.Tensor] = None,
):
    """Scatter a linear prefill scratch into the page pool, in place. Page
    ids >= the pool size (callers pad the id vector with them) are
    dropped. With scales (int8 pool) each (row, head) is quantized on the
    way in; returns the four tensors then, the two pools otherwise."""
    n_layers, _, s, hkv, d = k_lin.shape
    n_pool, page_size = k_pages.shape[2], k_pages.shape[3]
    n_pp = s // page_size
    page_ids = page_ids.to(k_pages.device).long()
    keep = (page_ids >= 0) & (page_ids < n_pool)
    ids = page_ids[keep]
    for pages, scales, lin in ((k_pages, k_scale, k_lin), (v_pages, v_scale, v_lin)):
        src = lin[:, 0].reshape(n_layers, n_pp, page_size, hkv, d).permute(0, 3, 1, 2, 4)
        src = src[:, :, keep]  # [L, Hkv, n_keep, page, d]
        if scales is not None:
            src, sc = _quantize_rows(src)
            scales[:, :, ids] = sc[:, :, :, None, :]
        pages[:, :, ids] = src.to(pages.dtype)
    if k_scale is not None:
        return k_pages, v_pages, k_scale, v_scale
    return k_pages, v_pages
