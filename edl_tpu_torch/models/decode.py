"""Paged KV-cache primitives for incremental decode (counterpart of
``edl_tpu/models/decode.py``).

Generation splits into two phases:

- **prefill**: the prompt runs through the normal causal forward once,
  and every layer's K/V projections are written into a block-paged
  cache pool;
- **decode**: each later token is one position of compute — the query
  attends over the cached K/V gathered through the sequence's block
  table, and the new token's K/V is written at its position.

The pool is ``[layers, num_blocks, block_tokens, heads, head_dim]``; a
sequence owns an ordered list of blocks recorded in its **block table**
``[max_blocks]``.  Logical position ``p`` lives at
``(table[p // block_tokens], p % block_tokens)``.  Block 0 is the TRASH
block: padding rows of a decode batch (and unallocated table tails)
point at it, so their writes land somewhere harmless and their gathers
stay in range.  The free list lives host-side in
``serving.engine.KVBlockPool``.

Where the JAX functions return updated pools (the engine donates the
buffers), these write into the pool IN PLACE (``index_put_``) and
return the same tensors.  The paged attention — of a decode step and
of a chunked-prefill slice (``paged_chunk_attention``) — is plain
PyTorch, as in the JAX package (not a Pallas kernel there).
"""

from __future__ import annotations

from typing import Tuple

import torch

from edl_tpu_torch.ops.ring_attention import NEG_INF

#: physical block id every padding row / unallocated table slot points
#: at.  Real sequences never own block 0.
TRASH_BLOCK = 0


def write_prefill_kv(kpool_l, vpool_l, tables, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write a prompt's per-layer K/V ``[B, P, H, D]`` into the pool
    (in place) at the sequences' first ``P // block_tokens`` blocks.
    ``P`` must be a multiple of the pool's block_tokens (the engine pads
    prompts to block-aligned buckets).  Returns the pools."""
    nb, bt, h, d = kpool_l.shape
    b, p = k.shape[0], k.shape[1]
    nblk = p // bt
    blocks = tables[:, :nblk].long()  # [B, nblk]
    kpool_l[blocks] = k.reshape(b, nblk, bt, h, d).to(kpool_l.dtype)
    vpool_l[blocks] = v.reshape(b, nblk, bt, h, d).to(vpool_l.dtype)
    return kpool_l, vpool_l


def write_chunk_kv(kpool_l, vpool_l, tables, offsets, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one prompt chunk's per-layer K/V ``[B, C, H, D]`` (in
    place) at each row's block-aligned cache offset ``offsets[i]`` (the
    positions earlier chunks filled).  ``C`` must be a multiple of
    block_tokens: the chunk scheduler splits prompts at block
    boundaries, and the final chunk pads to its bucket.  Returns the
    pools."""
    nb, bt, h, d = kpool_l.shape
    b, c = k.shape[0], k.shape[1]
    nblk = c // bt
    idx = (offsets.long() // bt)[:, None] + torch.arange(nblk, device=k.device)[None, :]
    blocks = tables.long().gather(1, idx)  # [B, nblk]
    kpool_l[blocks] = k.reshape(b, nblk, bt, h, d).to(kpool_l.dtype)
    vpool_l[blocks] = v.reshape(b, nblk, bt, h, d).to(vpool_l.dtype)
    return kpool_l, vpool_l


def paged_chunk_attention(q, kpool_l, vpool_l, tables, offsets) -> torch.Tensor:
    """Chunked-prefill attention over the paged cache.

    ``q``: ``[B, C, H, D]``, a prompt chunk at global positions
    ``offsets[i] + c`` whose own K/V is already in the pool, so it
    attends to itself and every earlier filled position.  Gathers each
    row's window through its block table (the engine passes only the
    blocks of the smallest prompt bucket covering the chunk, so the
    work grows with the filled prefix, not the context), masks keys
    past each query's global position, and returns ``[B, C, H, D]`` in
    float32 (softmax in float32)."""
    nb, bt, h, d = kpool_l.shape
    b, mb = tables.shape
    c = q.shape[1]
    m = mb * bt
    idx = tables.long()
    k_g = kpool_l[idx].reshape(b, m, h, d)
    v_g = vpool_l[idx].reshape(b, m, h, d)
    scale = 1.0 / (d ** 0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_g.float()) * scale
    qpos = offsets.long()[:, None] + torch.arange(c, device=q.device)[None, :]  # [B, C]
    keep = torch.arange(m, device=q.device)[None, None, :] <= qpos[:, :, None]  # [B, C, m]
    scores = scores.masked_fill(~keep[:, None], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v_g.float())


def write_decode_kv(kpool_l, vpool_l, tables, lengths, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one new token's K/V ``[B, H, D]`` (in place) at each row's
    current position ``lengths[i]`` through its block table.  Padding
    rows (table full of TRASH_BLOCK, length 0) write into the trash
    block.  Returns the pools."""
    bt = kpool_l.shape[1]
    lengths = lengths.long()
    blocks = tables.long().gather(1, (lengths // bt)[:, None])[:, 0]  # [B]
    offs = lengths % bt
    kpool_l[blocks, offs] = k.to(kpool_l.dtype)
    vpool_l[blocks, offs] = v.to(vpool_l.dtype)
    return kpool_l, vpool_l


def paged_decode_attention(q, kpool_l, vpool_l, tables, lengths) -> torch.Tensor:
    """One-token attention over the paged cache.

    ``q``: ``[B, H, D]`` (the new token's query, already written to the
    pool along with its K/V — it attends to itself).  Gathers each
    row's cache ``[max_blocks * block_tokens, H, D]`` through its block
    table, masks positions ``> lengths[i]`` (the new token sits AT
    ``lengths[i]``), and returns ``[B, H, D]`` in float32."""
    nb, bt, h, d = kpool_l.shape
    b, mb = tables.shape
    m = mb * bt
    idx = tables.long()
    k_g = kpool_l[idx].reshape(b, m, h, d)
    v_g = vpool_l[idx].reshape(b, m, h, d)
    scale = 1.0 / (d ** 0.5)
    scores = torch.einsum("bhd,bkhd->bhk", q.float(), k_g.float()) * scale
    keep = torch.arange(m, device=q.device)[None, :] <= lengths.long()[:, None]
    scores = scores.masked_fill(~keep[:, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", w, v_g.float())


class LayerKV:
    """Per-layer cache view threaded through a model's attention
    modules.  ``prefill`` selects the phase:

    - True — monolithic prompt forward: attention stays the module's
      own causal path, K/V are written from position 0;
    - ``"chunk"`` — one block-aligned prompt slice at the cache offsets
      ``offsets``: K/V are written there, and attention runs over the
      gathered window (``paged_chunk_attention``);
    - False — decode: one token per row at ``lengths``.

    Attention modules call two hooks: ``write(k, v)`` writes this
    layer's new K/V into the pool, and ``attend(q)`` is the paged
    attention of the chunk and decode phases (``[B, T, H, D]`` query ->
    ``[B, T, H, D]`` float32)."""

    def __init__(self, kpool_l, vpool_l, tables, lengths, prefill, offsets=None):
        self.kpool_l = kpool_l
        self.vpool_l = vpool_l
        self.tables = tables
        self.lengths = lengths
        self.mode = "chunk" if prefill == "chunk" else ("prefill" if prefill else "decode")
        self.prefill = self.mode == "prefill"
        self.offsets = offsets

    def write(self, k, v):
        """k, v: ``[B, P, H, D]`` (prefill), ``[B, C, H, D]`` (chunk) or
        ``[B, 1, H, D]`` (decode)."""
        if self.mode == "prefill":
            return write_prefill_kv(
                self.kpool_l, self.vpool_l, self.tables, k, v
            )
        if self.mode == "chunk":
            return write_chunk_kv(
                self.kpool_l, self.vpool_l, self.tables, self.offsets, k, v
            )
        return write_decode_kv(
            self.kpool_l, self.vpool_l, self.tables, self.lengths,
            k[:, 0], v[:, 0],
        )

    def attend(self, q):
        if self.mode == "chunk":
            return paged_chunk_attention(
                q, self.kpool_l, self.vpool_l, self.tables, self.offsets
            )
        out = paged_decode_attention(
            q[:, 0], self.kpool_l, self.vpool_l, self.tables, self.lengths
        )
        return out[:, None]


def greedy_from_features(features, embedding, positions=None) -> torch.Tensor:
    """Tied-vocab greedy ids from pre-projection features.

    ``features``: ``[B, T, D]``; ``embedding``: the ``[V, D]`` tied
    table already rounded through bf16 and held in float32
    (``TransformerLM.logit_weight(torch.bfloat16)``).  The logits are
    bf16 x bf16 products summed in float32, as the JAX version's
    ``preferred_element_type=float32`` einsum.  When ``positions``
    (``[B]``) is given, only that position's logits are computed (the
    prefill's next-token read); otherwise T == 1 (decode).  Returns
    ``[B]`` int64 ids."""
    if positions is not None:
        rows = torch.arange(features.shape[0], device=features.device)
        x = features[rows, positions.long()]
    else:
        x = features[:, 0]
    logits = x.to(torch.bfloat16).float() @ embedding.t()
    return torch.argmax(logits, dim=-1)


__all__ = [
    "LayerKV",
    "TRASH_BLOCK",
    "greedy_from_features",
    "paged_chunk_attention",
    "paged_decode_attention",
    "write_chunk_kv",
    "write_decode_kv",
    "write_prefill_kv",
]
