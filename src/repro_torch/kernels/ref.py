"""Plain PyTorch versions of the paged-attention kernels.

They follow the conventions of the JAX package's Pallas kernels
(``repro/kernels/paged_attention.py``), not those of its jnp oracles:

  * a row with ``length == 0`` returns zeros (``acc / max(l, 1e-30)``
    with ``l == 0``), where the jnp oracle returns a uniform average;
  * pages at or past ``length`` are never read: their table entries are
    replaced by page 0 before the gather, and their positions carry no
    weight;
  * for the quantized pages, the k scale multiplies the logits and the
    v scale multiplies the probabilities.

The CPU path of every wrapper in ``kernels.paged_attention`` runs these,
and ``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _gather_pages(pages, safe_table):
    """pages [P, page, ...] gathered by [B, pps] ids -> [B, pps, page,
    ...] in f32 (fp8 codes are gathered as bytes: CPU indexing kernels
    do not all take float8)."""
    if pages.dtype == torch.float8_e4m3fn:
        return pages.view(torch.uint8)[safe_table].view(pages.dtype).float()
    return pages[safe_table].float()


def _paged(q, k_pages, v_pages, page_table, lengths, k_scale, v_scale):
    b, h, d = q.shape
    _, page, hkv, _ = k_pages.shape
    pps = page_table.shape[1]
    g = h // hkv
    sm_scale = 1.0 / math.sqrt(d)
    lengths = lengths.long()
    col = torch.arange(pps, device=q.device)
    page_live = col[None, :] * page < lengths[:, None]             # [B, pps]
    safe = torch.where(page_live, page_table.long(),
                       torch.zeros_like(page_table, dtype=torch.long))
    k = _gather_pages(k_pages, safe)                  # [B, pps, page, Hkv, D]
    v = _gather_pages(v_pages, safe)
    qg = q.float().reshape(b, hkv, g, d)
    s = torch.einsum("bkgd,bptkd->bkgpt", qg, k)
    if k_scale is not None:
        ks = k_scale[safe].permute(0, 3, 1, 2)                # [B, Hkv, pps, page]
        s = s * ks[:, :, None]
    s = s * sm_scale
    pos = col[:, None] * page + torch.arange(page, device=q.device)[None, :]
    mask = pos[None] < lengths[:, None, None]                 # [B, pps, page]
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    sf = s.reshape(b, hkv, g, pps * page)
    mf = mask.reshape(b, 1, 1, pps * page)
    m = sf.amax(dim=-1, keepdim=True)
    p = torch.where(mf, torch.exp(sf - m), torch.zeros_like(sf))
    l = p.sum(dim=-1)                                         # [B, Hkv, G]
    if v_scale is not None:
        vs = v_scale[safe].permute(0, 3, 1, 2).reshape(b, hkv, 1, pps * page)
        p = p * vs
    acc = torch.einsum("bkgt,btkd->bkgd", p, v.reshape(b, pps * page, hkv, d))
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, page_table, lengths):
    """q: [B, H, D]; k_pages/v_pages: [P, page, Hkv, D]; page_table:
    [B, pps] int32 physical ids; lengths: [B] int32.  Returns [B, H, D]."""
    return _paged(q, k_pages, v_pages, page_table, lengths, None, None)


def paged_attention_q8_ref(q, k_pages, v_pages, k_scale, v_scale,
                           page_table, lengths):
    """The same over int8 or fp8-e4m3 codes with per-slot f32 scales
    ``k_scale``/``v_scale`` [P, page, Hkv]."""
    return _paged(q, k_pages, v_pages, page_table, lengths, k_scale, v_scale)
