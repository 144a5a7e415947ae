"""Decoder-only transformer LM: GQA / MQA / qk-norm / RoPE / MLA / MoE.

A torch copy of ``repro.models.transformer``: one implementation covers
the five LM architectures (qwen3-moe-235b, deepseek-v2-lite with MLA,
granite-34b with MQA, qwen3-1.7b, glm4-9b).

  * Layer parameters are stacked on a leading [L] axis under the
    reference's paths (``layers.wq``, ``layers.moe.w_gate``, ``embed``,
    ``lm_head``, ``final_ln``), so ``models.convert.load_jax_params``
    carries the reference's parameters unchanged. They stay float32 and
    are cast to ``cfg.dtype`` at each product, as in the reference. The
    stack runs as a loop over the layers, each taking its views of the
    stacked tensors (one ``unbind`` per tensor, whose backward stacks
    the layers' gradients once); ``remat`` checkpoints each layer
    (``torch.utils.checkpoint``, non-reentrant) when gradients are on.
  * Attention is an online softmax over KV chunks, so a 32k-token
    prefill never holds the S×S score matrix. The reference scans every
    KV block for each query block; a block whose keys all lie after a
    query row changes nothing in that row (its scores are -inf, so its
    weights are 0 and the correction 1), since KV block 0, which every
    row sees, goes first. Here each KV step runs every query row that
    sees a key in it, tiled to bound the score tile, with the
    reference's per-row arithmetic: ``nk`` steps a layer, not
    ``nq × nk``.
  * MLA runs the reconstructing form for train and prefill and the
    absorbed form for decode, against the compressed cache
    ([S, kv_lora + rope_dim] a token).
  * The loss is a cross-entropy over sequence chunks, each checkpointed
    when gradients are on, so [B, S, V] logits never exist.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.common import (Params, apply_rope, cross_entropy,
                                       dense_init, hint, rms_norm,
                                       rope_angles)
from repro_torch.models.moe import MoEConfig, moe_ffn, moe_shapes

__all__ = ["MLAConfig", "TransformerConfig", "init_params", "param_structs",
           "blockwise_attention", "direct_attention", "decode_attention",
           "forward", "loss_fn", "cache_shapes", "init_cache",
           "decode_step"]

#: score-tile elements (batch x heads x query rows x KV chunk) one
#: attention step computes at once: 256 MiB of float32 scores (rows in
#: whole KV chunks, at least one)
ATTN_TILE_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    qk_norm: bool = False
    glu: bool = True           # False => 2-matmul GELU MLP (granite/bigcode)
    rope_theta: float = 1e6
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    q_chunk: int = 512
    kv_chunk: int = 1024
    loss_chunk: int = 512
    remat: bool = True
    dtype: Any = torch.bfloat16
    # --- the reference's distribution hints (set by its cell builders
    # from a mesh; the identity on one card) ---
    hint_batch_axes: tuple = ()
    hint_model_axis: Any = None
    hint_model_extent: int = 1
    seq_shard: bool = False
    sp_mode: str = "auto"    # "auto" | "none"
    attn_mode: str = "block"  # "block" | "direct"

    def _attn_params(self) -> int:
        d = self.d_model
        if self.mla is not None:
            m = self.mla
            return (d * (m.kv_lora_rank + m.qk_rope_dim)
                    + m.kv_lora_rank * self.n_heads
                    * (m.qk_nope_dim + m.v_head_dim)
                    + d * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                    + self.n_heads * m.v_head_dim * d)
        return (d * self.d_head * (self.n_heads + 2 * self.n_kv_heads)
                + self.n_heads * self.d_head * d)

    def _shared_ffn_params(self) -> int:
        if not self.moe.n_shared:
            return 0
        fs = self.moe.d_shared_ff or self.moe.d_expert_ff * self.moe.n_shared
        return 3 * self.d_model * fs

    @property
    def n_params(self) -> int:
        """Total parameter count (the reference's formula)."""
        d, l = self.d_model, self.n_layers
        if self.moe is not None:
            ffn = (self.moe.n_experts * 3 * d * self.moe.d_expert_ff
                   + d * self.moe.n_experts + self._shared_ffn_params())
        else:
            ffn = (3 if self.glu else 2) * d * self.d_ff
        return l * (self._attn_params() + ffn) + 2 * self.vocab * d

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.moe is None:
            return self.n_params
        d, l = self.d_model, self.n_layers
        ffn = (self.moe.top_k * 3 * d * self.moe.d_expert_ff
               + d * self.moe.n_experts + self._shared_ffn_params())
        return l * (self._attn_params() + ffn) + 2 * self.vocab * d


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _param_tree(cfg: TransformerConfig, dense, ones) -> dict:
    """The parameter tree, each weight ``dense(shape, scale)`` and each
    norm ``ones(shape)``, made in the reference's order (the draws of
    ``init_params`` follow it)."""
    l, d = cfg.n_layers, cfg.d_model

    def stack(*shape):
        return dense((l,) + shape, 1.0 / shape[0] ** 0.5)

    layer: Dict[str, Any] = {"ln1": ones((l, d)), "ln2": ones((l, d))}
    if cfg.mla is None:
        h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        layer.update(wq=stack(d, h * dh), wk=stack(d, kv * dh),
                     wv=stack(d, kv * dh), wo=stack(h * dh, d))
        if cfg.qk_norm:
            layer["q_norm"] = ones((l, dh))
            layer["k_norm"] = ones((l, dh))
    else:
        m, h = cfg.mla, cfg.n_heads
        layer.update(
            w_dkv=stack(d, m.kv_lora_rank + m.qk_rope_dim),
            kv_ln=ones((l, m.kv_lora_rank)),
            w_uk=stack(m.kv_lora_rank, h * m.qk_nope_dim),
            w_uv=stack(m.kv_lora_rank, h * m.v_head_dim),
            wq=stack(d, h * (m.qk_nope_dim + m.qk_rope_dim)),
            wo=stack(h * m.v_head_dim, d))
    if cfg.moe is None:
        if cfg.glu:
            layer["w_gate"] = stack(d, cfg.d_ff)
        layer.update(w_up=stack(d, cfg.d_ff), w_down=stack(cfg.d_ff, d))
    else:
        layer["moe"] = {name: stack(*shape) for name, shape in
                        moe_shapes(cfg.moe, d).items()}
    return {"embed": dense((cfg.vocab, d), 0.02),
            "lm_head": dense((d, cfg.vocab), 1.0 / d ** 0.5),
            "final_ln": ones((d,)), "layers": layer}


def init_params(generator: torch.Generator, cfg: TransformerConfig,
                device=None) -> Params:
    """The model's parameters (float32) as a module whose state-dict keys
    are the reference's paths, drawn from ``generator`` on its device
    and moved to ``device`` (``None``: CUDA). The reference's law (a
    truncated normal at each weight's per-layer fan-in, norms at 1,
    ``embed`` at 0.02), not its bits."""
    dev = resolve_device(device)
    return Params(_param_tree(
        cfg, lambda shape, scale: dense_init(generator, shape, scale=scale,
                                             device=dev),
        lambda shape: torch.ones(shape, dtype=torch.float32, device=dev)))


def param_structs(cfg: TransformerConfig) -> dict:
    """``init_params``' tree as float32 meta tensors (nested dicts): the
    shapes and dtypes with nothing drawn or allocated, the counterpart of
    the reference's ``jax.eval_shape`` of its init."""
    def meta(shape, scale=None):
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return _param_tree(cfg, meta, meta)


def _unstack(tree, n: int) -> List[dict]:
    """The ``n`` layers' dicts of views of ``tree``'s [L, ...] tensors
    (a ``Params`` module or a dict, nested)."""
    out: List[dict] = [{} for _ in range(n)]
    for name, value in tree.items():
        parts = (_unstack(value, n) if isinstance(value, (dict, Params))
                 else value.unbind(0))
        for i, part in enumerate(parts):
            out[i][name] = part
    return out


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _check_blocks(s: int, **chunks: int) -> None:
    for name, c in chunks.items():
        if s % c:
            raise ValueError(f"sequence length {s} is not a multiple of "
                             f"{name} {c}: the reference's blocks would not "
                             f"tile it, and the port does not pad")


def _causal_online_softmax(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, kc: int) -> torch.Tensor:
    """Causal attention of q [B, S, H, dh] over k [B, S, KV, dh], v [B, S,
    KV, dv] (GQA by head groups), an online softmax over KV chunks of
    ``kc`` with the reference's per-row arithmetic. Query rows run in
    tiles of whole KV chunks; at KV step j only the tiles holding a row
    at or past position j*kc run (a row before it sees no key there)."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    dv = v.shape[3]
    nk = s // kc
    scale = dh ** -0.5
    qg = q.reshape(b, s, kvh, g, dh)
    rows = kc * max(1, ATTN_TILE_ELEMS // (b * h * kc * kc))
    tiles = [(r0, min(r0 + rows, s)) for r0 in range(0, s, rows)]
    state = []
    for r0, r1 in tiles:
        n = r1 - r0
        state.append((
            torch.full((b, kvh, g, n), float("-inf"), dtype=torch.float32,
                       device=q.device),
            torch.zeros((b, kvh, g, n), dtype=torch.float32, device=q.device),
            torch.zeros((b, kvh, g, n, dv), dtype=torch.float32,
                        device=q.device)))
    pos = torch.arange(s, device=q.device)
    for j in range(nk):
        kj = k[:, j * kc:(j + 1) * kc]
        vj = v[:, j * kc:(j + 1) * kc]
        k_pos = pos[j * kc:(j + 1) * kc]
        for t, (r0, r1) in enumerate(tiles):
            if r1 <= j * kc:
                continue  # every row of the tile lies before the chunk
            m, l, acc = state[t]
            srow = torch.einsum("bqkgd,bckd->bkgqc", qg[:, r0:r1], kj) * scale
            srow = srow.to(torch.float32)
            # rows at or past the chunk's end see all of it: only the rows
            # before it take the causal mask (the reference's where)
            rb = min(r1, (j + 1) * kc)
            if rb > r0:
                srow[..., :rb - r0, :].masked_fill_(
                    pos[r0:rb, None] < k_pos[None, :], float("-inf"))
            m_new = torch.maximum(m, torch.amax(srow, dim=-1))
            p = torch.exp(srow - m_new[..., None])
            corr = torch.exp(m - m_new)
            l_new = l * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bkgqc,bckd->bkgqd", p.to(q.dtype), vj)
            state[t] = (m_new, l_new,
                        acc * corr[..., None] + pv.to(torch.float32))
    out = torch.cat([acc / torch.clamp_min(l[..., None], 1e-30)
                     for _, l, acc in state], dim=3)
    # [B, KV, G, S, dv] -> [B, S, H, dv]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dv).to(q.dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_chunk: int, kv_chunk: int) -> torch.Tensor:
    """Causal online-softmax attention over KV chunks.

    q [B, S, H, dh]; k, v [B, S, KV, dh_(v)]. GQA via head grouping. The
    reference's query blocks of ``min(q_chunk, S)`` and KV blocks of
    ``min(kv_chunk, S)`` must tile S."""
    s = q.shape[1]
    qc, kc = min(q_chunk, s), min(kv_chunk, s)
    _check_blocks(s, q_chunk=qc, kv_chunk=kc)
    return _causal_online_softmax(q, k, v, kc)


def direct_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_chunk: int = 512) -> torch.Tensor:
    """The reference's context-parallel form: every query row at each KV
    chunk (the same per-row arithmetic as ``blockwise_attention``)."""
    s = q.shape[1]
    kc = min(kv_chunk, s)
    _check_blocks(s, kv_chunk=kc)
    return _causal_online_softmax(q, k, v, kc)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len: torch.Tensor
                     ) -> torch.Tensor:
    """Single-position attention against a [B, S_max, KV, dh] cache."""
    b, h, dh = q.shape
    kv = k_cache.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, dh)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache) * dh ** -0.5
    s_max = k_cache.shape[1]
    mask = torch.arange(s_max, device=q.device)[None] < cur_len[:, None]
    scores = torch.where(mask[:, None, None], scores.to(torch.float32),
                         float("-inf"))
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache)
    return out.reshape(b, h, v_cache.shape[3])


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------

def _attn_block(lp, x: torch.Tensor, cfg: TransformerConfig,
                positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence attention sublayer (train / prefill)."""
    b, s, d = x.shape
    ba = tuple(cfg.hint_batch_axes)
    ma = cfg.hint_model_axis if cfg.seq_shard else None
    xn = rms_norm(x, lp["ln1"])
    if cfg.mla is None:
        h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        q = (xn @ lp["wq"].to(x.dtype)).reshape(b, s, h, dh)
        k = (xn @ lp["wk"].to(x.dtype)).reshape(b, s, kv, dh)
        v = (xn @ lp["wv"].to(x.dtype)).reshape(b, s, kv, dh)
        q = hint(q, ba, ma, None, None)
        if cfg.qk_norm:
            q = rms_norm(q, lp["q_norm"])
            k = rms_norm(k, lp["k_norm"])
        cos, sin = rope_angles(positions, dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if cfg.attn_mode == "direct":
            o = direct_attention(q, k, v)
        else:
            o = blockwise_attention(q, k, v, cfg.q_chunk, cfg.kv_chunk)
        o = o.reshape(b, s, h * dh)
    else:
        m, h = cfg.mla, cfg.n_heads
        ckv = xn @ lp["w_dkv"].to(x.dtype)
        c_kv, k_rope = ckv[..., :m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
        c_kv = rms_norm(c_kv, lp["kv_ln"])
        k_nope = (c_kv @ lp["w_uk"].to(x.dtype)).reshape(
            b, s, h, m.qk_nope_dim)
        v = (c_kv @ lp["w_uv"].to(x.dtype)).reshape(b, s, h, m.v_head_dim)
        q = (xn @ lp["wq"].to(x.dtype)).reshape(
            b, s, h, m.qk_nope_dim + m.qk_rope_dim)
        q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
        cos, sin = rope_angles(positions, m.qk_rope_dim, cfg.rope_theta)
        q_rope = apply_rope(q_rope, cos, sin)
        k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)  # 1 shared head
        k_rope_b = k_rope.expand(b, s, h, m.qk_rope_dim)
        qf = torch.cat([q_nope, q_rope], dim=-1)
        kf = torch.cat([k_nope, k_rope_b], dim=-1)
        qf = hint(qf, ba, ma, None, None)
        if cfg.attn_mode == "direct":
            o = direct_attention(qf, kf, v)
        else:
            o = blockwise_attention(qf, kf, v, cfg.q_chunk, cfg.kv_chunk)
        o = o.reshape(b, s, h * m.v_head_dim)
    o = hint(o, ba, ma, None)
    return x + o @ lp["wo"].to(x.dtype)


def _dense_ffn(lp, xn: torch.Tensor, cfg: TransformerConfig
               ) -> torch.Tensor:
    u = xn @ lp["w_up"].to(xn.dtype)
    if cfg.glu:
        h = F.silu(xn @ lp["w_gate"].to(xn.dtype)) * u
    else:
        h = F.gelu(u, approximate="tanh")
    return h @ lp["w_down"].to(xn.dtype)


def _ffn_block(lp, x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    xn = rms_norm(x, lp["ln2"])
    if cfg.moe is None:
        y = _dense_ffn(lp, xn, cfg)
    else:
        y = moe_ffn(lp["moe"], xn, cfg.moe)
    return x + y


def _layer(lp, x: torch.Tensor, cfg: TransformerConfig,
           positions: torch.Tensor) -> torch.Tensor:
    return _ffn_block(lp, _attn_block(lp, x, cfg, positions), cfg)


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

def forward(params, tokens: torch.Tensor, cfg: TransformerConfig
            ) -> torch.Tensor:
    """tokens [B, S] -> final hidden states [B, S, d] (pre lm_head)."""
    b, s = tokens.shape
    x = params["embed"][tokens.long()].to(cfg.dtype)
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in _unstack(params["layers"], cfg.n_layers):
        if remat:
            x = checkpoint(_layer, lp, x, cfg, positions,
                           use_reentrant=False)
        else:
            x = _layer(lp, x, cfg, positions)
    return rms_norm(x, params["final_ln"])


def _chunk_loss(hi: torch.Tensor, ti: torch.Tensor, lm_head: torch.Tensor
                ) -> torch.Tensor:
    logits = torch.einsum("bcd,dv->bcv", hi, lm_head.to(hi.dtype))
    return cross_entropy(logits, ti)


def loss_fn(params, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """Chunked cross-entropy LM loss (never materializes [B, S, V]). Only
    the first ``(S // loss_chunk) * loss_chunk`` positions count, as in
    the reference."""
    h = forward(params, tokens, cfg)
    s = h.shape[1]
    c = min(cfg.loss_chunk, s)
    nc = s // c
    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(nc):
        hi, ti = h[:, i * c:(i + 1) * c], targets[:, i * c:(i + 1) * c]
        if remat:
            total = total + checkpoint(_chunk_loss, hi, ti,
                                       params["lm_head"],
                                       use_reentrant=False)
        else:
            total = total + _chunk_loss(hi, ti, params["lm_head"])
    return total / nc


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------

def cache_shapes(cfg: TransformerConfig, batch: int, max_len: int) -> dict:
    """The KV cache's shapes: ``k``/``v`` [L, B, S_max, KV, dh], or under
    MLA the compressed ``ckv`` [L, B, S_max, kv_lora] and ``krope`` [L,
    B, S_max, rope_dim]."""
    l = cfg.n_layers
    if cfg.mla is None:
        shape = (l, batch, max_len, cfg.n_kv_heads, cfg.d_head)
        return {"k": shape, "v": shape}
    m = cfg.mla
    return {"ckv": (l, batch, max_len, m.kv_lora_rank),
            "krope": (l, batch, max_len, m.qk_rope_dim)}


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=None, device=None) -> Dict[str, torch.Tensor]:
    """Zero KV cache of ``cache_shapes`` in ``dtype`` (default
    ``cfg.dtype``). ``device=None`` means CUDA; ``"meta"`` gives shapes
    only (nothing allocated)."""
    dtype = dtype or cfg.dtype
    dev = torch.device("meta") if device == "meta" else \
        resolve_device(device)
    return {name: torch.zeros(shape, dtype=dtype, device=dev)
            for name, shape in cache_shapes(cfg, batch, max_len).items()}


def _decode_attn(lp, xn, cache_slices, pos, cfg):
    """One layer's attention output [B, H*dv] for one token a row at
    position ``pos`` [B]; writes the token's entry into the layer's cache
    slices, then attends over positions 0..pos."""
    b = xn.shape[0]
    bi = torch.arange(b, device=xn.device)
    if cfg.mla is None:
        h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        q = (xn @ lp["wq"].to(xn.dtype)).reshape(b, h, dh)
        k = (xn @ lp["wk"].to(xn.dtype)).reshape(b, kv, dh)
        v = (xn @ lp["wv"].to(xn.dtype)).reshape(b, kv, dh)
        if cfg.qk_norm:
            q = rms_norm(q, lp["q_norm"])
            k = rms_norm(k, lp["k_norm"])
        cos, sin = rope_angles(pos, dh, cfg.rope_theta)  # [B, dh/2]
        q = apply_rope(q[:, None], cos[:, None], sin[:, None])[:, 0]
        k = apply_rope(k[:, None], cos[:, None], sin[:, None])[:, 0]
        k_cache, v_cache = cache_slices
        k_cache[bi, pos] = k.to(k_cache.dtype)
        v_cache[bi, pos] = v.to(v_cache.dtype)
        o = decode_attention(q, k_cache, v_cache, pos + 1)
        return o.reshape(b, h * dh)
    m, h = cfg.mla, cfg.n_heads
    ckv_full = xn @ lp["w_dkv"].to(xn.dtype)
    c_new = rms_norm(ckv_full[:, :m.kv_lora_rank], lp["kv_ln"])
    kr_new = ckv_full[:, m.kv_lora_rank:]
    cos, sin = rope_angles(pos, m.qk_rope_dim, cfg.rope_theta)
    kr_new = apply_rope(kr_new[:, None, None], cos[:, None],
                        sin[:, None])[:, 0, 0]
    ckv_cache, kr_cache = cache_slices
    ckv_cache[bi, pos] = c_new.to(ckv_cache.dtype)
    kr_cache[bi, pos] = kr_new.to(kr_cache.dtype)
    q = (xn @ lp["wq"].to(xn.dtype)).reshape(
        b, h, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = apply_rope(q_rope[:, None], cos[:, None], sin[:, None])[:, 0]
    # absorbed: q' = q_nope @ W_uk^T -> attend against c_kv directly
    w_uk = lp["w_uk"].to(xn.dtype).reshape(m.kv_lora_rank, h, m.qk_nope_dim)
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope, w_uk)
    scores = (torch.einsum("bhr,bsr->bhs", q_abs, ckv_cache)
              + torch.einsum("bhn,bsn->bhs", q_rope, kr_cache))
    scores = scores * (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    s_max = ckv_cache.shape[1]
    mask = torch.arange(s_max, device=xn.device)[None] < (pos + 1)[:, None]
    scores = torch.where(mask[:, None], scores.to(torch.float32),
                         float("-inf"))
    p = torch.softmax(scores, dim=-1).to(xn.dtype)
    o_c = torch.einsum("bhs,bsr->bhr", p, ckv_cache)  # latent output
    w_uv = lp["w_uv"].to(xn.dtype).reshape(m.kv_lora_rank, h, m.v_head_dim)
    return torch.einsum("bhr,rhv->bhv", o_c, w_uv).reshape(
        b, h * m.v_head_dim)


@torch.no_grad()
def decode_step(params, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, cur_len: torch.Tensor,
                cfg: TransformerConfig
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoding step.

    tokens [B] int; cur_len [B] current cache fill (tokens go to position
    cur_len). Returns (logits [B, V], cache). MLA decodes in the absorbed
    form against the compressed cache. The reference's cache update is
    functional (a new cache; its decode cell donates the old one); here
    each layer's new entry is written into ``cache`` in place, and the
    same dict is returned."""
    x = params["embed"][tokens.long()].to(cfg.dtype)  # [B, d]
    pos = cur_len.long()
    names = ("k", "v") if cfg.mla is None else ("ckv", "krope")
    for li, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        slices = tuple(cache[n][li] for n in names)
        xn = rms_norm(x, lp["ln1"])
        x = x + _decode_attn(lp, xn, slices, pos, cfg) @ lp["wo"].to(x.dtype)
        xn2 = rms_norm(x, lp["ln2"])
        if cfg.moe is None:
            y = _dense_ffn(lp, xn2, cfg)
        else:
            y = moe_ffn(lp["moe"], xn2[:, None, :], cfg.moe)[:, 0]
        x = x + y
    x = rms_norm(x, params["final_ln"])
    return x @ params["lm_head"].to(x.dtype), cache
