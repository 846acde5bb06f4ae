"""Config-driven model assembly for all ten registered architectures.

The counterpart of ``repro.models.transformer`` for every ``family``:
"dense" (granite-3-8b, gemma-7b, minitron-8b, h2o-danube-1.8b), "moe"
(granite-moe-1b-a400m, moonshot-v1-16b-a3b: a top-k MoE FFN,
``models.moe``, in place of the MLP), "hybrid" (recurrentgemma-2b:
``[rglru, rglru, attn]`` periods, local attention), "ssm" (rwkv6-7b:
``rwkv`` layers), "vlm" (llama-3.2-vision-11b: every
``cross_attn_every``-th layer an ``xattn`` layer whose K/V come from the
image embeddings ``img``) and "audio" (hubert-xlarge: encoder-only, the
frame embeddings ``frames`` in place of the token embedding,
bidirectional attention without rope).  Each layer dispatches on its
kind, ``cfg.layer_kinds()[i]``: ``attn``, ``xattn``, ``rglru`` or
``rwkv``.

Parameters are a plain dict, ``{"embed", "final_norm", "lm_head",
"layers": [per-layer dict]}``: the JAX package's ``lax.scan`` over stacked
periods becomes a Python loop over layers (``models.convert`` unstacks a
JAX parameter tree into this form).

Kernel selection follows the plan, as in the JAX package, but by device:
where the plan turns B5, B6 or B7 on, the model calls its
``models.autograd`` Function, whose forward is the kernel's wrapper
(``repro_torch.kernels``): the hand-written kernel for tensors on the
card, its plain version for tensors on the CPU.  Outside grad mode, or
where no input needs a gradient, the Function only runs that forward, so
prefill, decode and training take one path per plan flag.
(The JAX package calls its Pallas kernels only where the backend is a TPU,
and otherwise takes jnp paths of its own.)  B6 gets the fp32 weights
uncast, as the JAX package passes them to its kernel.

The recurrences of the prefill always go through their kernel wrappers,
B8 (RG-LRU) and B9 (WKV6): ``apply_block`` calls the sequence forms,
whose ``use_kernel`` flag is fixed to True in the port.  This is the
port's form of the selection that ``repro/core/policy.py:7`` states ("RG-LRU / WKV scan ops select their
dedicated kernels") and that the JAX model never makes: its
``apply_block`` (``repro/models/transformer.py:255``, ``:258``) passes no
``use_kernel``, so it runs the ``lax.scan`` references, and only behind
``use_kernel=True`` (``repro/models/recurrent.py:54``, ``:127``) are the
Pallas kernels reached.  The same function is computed, by a kernel.
Decode steps stay plain torch ops, as in the JAX package.

Modes:
  forward(..., mode="prefill") — full sequence; also returns each layer's
    cache entry: (k, v), the RG-LRU's hT or the WKV state sT.  An
    ``xattn`` layer's (k, v) are the image's, of ``vision_seq`` rows.
  forward(..., mode="train", remat_policy=None) — the same, for a loss to
    backpropagate through, in every family (``frames`` and ``img`` as in
    prefill).  A Function's backward is a differentiable plain form;
    where the plan turns a kernel off, the plain forms of prefill (naive
    attention, the plain MLP, the plain norm) are differentiated
    directly; the recurrences always run B8/B9 under their Functions.
    With a ``remat_policy`` (``CelloPlan.checkpoint_policy()``) every
    layer is one checkpointed region; the JAX package's region is one
    period (one layer for the dense, moe, ssm and audio families, an
    ``[rglru, rglru, attn]`` triple for the hybrid one, a run of
    ``cross_attn_every`` layers for the vlm), which recomputes the same
    ops from the same kept tensors.  The tensors are tagged where the JAX
    model tags them: ``q_out``, ``attn_out``, ``mlp_hidden`` (plain MLP
    and MoE experts), ``router_logits``, ``rnn_state``, ``mlp_out``,
    ``x_mid``.
  decode_step(...) — one token against the cache (ring-buffered when the
    arch uses a bounded attention window).  As in the JAX package, an
    ``xattn`` layer decodes as an ``attn`` layer does, on a ring cache of
    its own (the image is not attended in decode).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..core.policy import CelloPlan
from .attention import naive_attention
from .autograd import FlashAttentionFn, FusedMLPFn, RMSNormFn, plain_mlp
from .common import (COMPUTE_DTYPE, PARAM_DTYPE, apply_rope, bf16,
                     dense_init, is_gated, rms_norm, tag)
from .moe import apply_moe, init_moe_params
from .recurrent import (apply_rglru_seq, apply_rglru_step, apply_rwkv_seq,
                        apply_rwkv_step, init_rglru_params, init_rwkv_params)

Params = Dict[str, Any]
PORTED_FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm", "audio")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: no model of the {cfg.family!r} family; the port "
            f"runs {', '.join(PORTED_FAMILIES)}")


# ---------------------------------------------------------------------------
# period decomposition
# ---------------------------------------------------------------------------

def period_structure(cfg: ArchConfig) -> Tuple[List[str], int, List[str]]:
    """(period_kinds, n_periods, remainder_kinds)."""
    kinds = cfg.layer_kinds()
    if cfg.hybrid_period:
        plen = cfg.hybrid_period
    elif cfg.cross_attn_every:
        plen = cfg.cross_attn_every
    else:
        plen = 1
    n_periods = len(kinds) // plen
    return kinds[:plen], n_periods, kinds[n_periods * plen:]


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def init_block_params(gen: torch.Generator, cfg: ArchConfig, kind: str, *,
                      device, dtype=PARAM_DTYPE) -> Params:
    """One block of ``kind`` (``attn``, ``xattn``, ``rglru`` or ``rwkv``)
    and its MLP, or its MoE FFN for an MoE arch."""
    D, H, KVH, E = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    s = D ** -0.5
    p: Params = {
        "ln1": torch.zeros((D,), dtype=dtype, device=device),
        "ln2": torch.zeros((D,), dtype=dtype, device=device),
    }
    if kind in ("attn", "xattn"):
        p["attn"] = {
            "wq": dense_init(gen, (D, H * E), s, device, dtype),
            "wk": dense_init(gen, (D, KVH * E), s, device, dtype),
            "wv": dense_init(gen, (D, KVH * E), s, device, dtype),
            "wo": dense_init(gen, (H * E, D), (H * E) ** -0.5, device, dtype),
        }
    elif kind == "rglru":
        p["rglru"] = init_rglru_params(gen, D, dtype, device=device)
    elif kind == "rwkv":
        p["rwkv"] = init_rwkv_params(gen, D, H, dtype, device=device)
    else:
        raise ValueError(kind)
    F = cfg.d_ff
    if cfg.is_moe:
        p["moe"] = init_moe_params(gen, D, F, cfg.n_experts, cfg.activation,
                                   device=device, dtype=dtype)
        return p
    p["mlp"] = {"w_up": dense_init(gen, (D, F), s, device, dtype),
                "w_down": dense_init(gen, (F, D), F ** -0.5, device, dtype)}
    if is_gated(cfg.activation):
        p["mlp"]["w_gate"] = dense_init(gen, (D, F), s, device, dtype)
    return p


def init_params(cfg: ArchConfig, *, seed: int = 0, device="cuda",
                dtype=PARAM_DTYPE) -> Params:
    """Random weights from ``seed``, with the JAX package's shapes and
    scales (its numbers differ: a ``torch.Generator`` on ``device`` draws
    them).  ``device`` is ``"cuda"`` unless the caller asks for the CPU."""
    _check_family(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    D = cfg.d_model
    params: Params = {
        "embed": dense_init(gen, (cfg.padded_vocab, D), D ** -0.5, device,
                        dtype),
        "final_norm": torch.zeros((D,), dtype=dtype, device=device),
        "lm_head": dense_init(gen, (D, cfg.padded_vocab), D ** -0.5, device,
                          dtype),
    }
    params["layers"] = [init_block_params(gen, cfg, kind, device=device,
                                          dtype=dtype)
                        for kind in cfg.layer_kinds()]
    return params


# ---------------------------------------------------------------------------
# block application — full sequence
# ---------------------------------------------------------------------------

def _attend(p_attn, x, *, cfg: ArchConfig, plan: CelloPlan, causal: bool,
            img: Optional[torch.Tensor], rope: bool,
            positions: torch.Tensor
            ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention, or with ``img`` cross-attention: K/V from the
    ``vision_seq`` image rows, without rope or window."""
    B, S, D = x.shape
    H, KVH, E = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    xc = x.to(COMPUTE_DTYPE)
    q = (xc @ bf16(p_attn["wq"])).reshape(B, S, H, E)
    src = xc if img is None else img.to(COMPUTE_DTYPE)
    T = src.shape[1]
    k = (src @ bf16(p_attn["wk"])).reshape(B, T, KVH, E)
    v = (src @ bf16(p_attn["wv"])).reshape(B, T, KVH, E)
    if rope and img is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = tag(q, "q_out")
    window = cfg.window if img is None else None
    if plan.use_flash_attention:
        ctx = FlashAttentionFn.apply(q, k, v, causal, window, plan.kv_block)
    else:
        ctx = naive_attention(q, k, v, causal=causal, window=window)
    out = (ctx.reshape(B, S, H * E).to(COMPUTE_DTYPE)
           @ bf16(p_attn["wo"]))
    return tag(out, "attn_out").to(x.dtype), (k, v)


def _mlp(p, x, cfg: ArchConfig, plan: CelloPlan) -> torch.Tensor:
    B, S, D = x.shape
    flat = x.reshape(B * S, D)
    if cfg.is_moe:
        out = apply_moe(p["moe"], flat, top_k=cfg.top_k,
                        activation=cfg.activation,
                        capacity_factor=plan.moe_capacity_factor)
        return tag(out.reshape(B, S, D), "mlp_out")
    m = p["mlp"]
    weights = (m["w_gate"] if is_gated(cfg.activation) else None,
               m["w_up"], m["w_down"])
    xc = flat.to(COMPUTE_DTYPE)
    if plan.use_fused_mlp:
        out = FusedMLPFn.apply(xc.contiguous(), *weights, cfg.activation)
    else:
        out = plain_mlp(xc, *weights, cfg.activation,
                        hidden=lambda h: tag(h, "mlp_hidden"))
    return tag(out.reshape(B, S, D).to(x.dtype), "mlp_out")


def _norm(x, w, cfg: ArchConfig, plan: CelloPlan):
    """RMSNorm: B7 through its autograd Function where the plan fuses it,
    otherwise the plain ``rms_norm``."""
    if plan.use_fused_rmsnorm:
        return RMSNormFn.apply(x, w, cfg.norm_eps)
    return rms_norm(x, w, cfg.norm_eps)


def apply_block(p, x, kind: str, *, cfg: ArchConfig, plan: CelloPlan,
                positions: torch.Tensor,
                img: Optional[torch.Tensor] = None):
    """Full-sequence block of ``kind``.  Returns (x_out, cache entry):
    (k, v), hT or sT.  An ``xattn`` block attends to ``img``; an
    encoder-only arch's blocks attend both ways, without rope."""
    h = _norm(x, p["ln1"], cfg, plan)
    if kind in ("attn", "xattn"):
        y, entry = _attend(p["attn"], h, cfg=cfg, plan=plan,
                           causal=(not cfg.encoder_only) and kind == "attn",
                           img=img if kind == "xattn" else None,
                           rope=not cfg.encoder_only, positions=positions)
    elif kind == "rglru":
        y, entry = apply_rglru_seq(p["rglru"], h)
    elif kind == "rwkv":
        y, entry = apply_rwkv_seq(p["rwkv"], h, cfg.n_heads)
    else:
        raise ValueError(kind)
    x = tag(x + y, "x_mid")
    h2 = _norm(x, p["ln2"], cfg, plan)
    x = x + _mlp(p, h2, cfg, plan)
    return x, entry


# ---------------------------------------------------------------------------
# full forward
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg: ArchConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """The embedding rows of ``tokens`` in bf16, times sqrt(d_model) rounded
    to bf16 (the JAX package's bf16 × weak-typed scalar).  Rows are
    gathered before the cast: the same numbers, without casting the whole
    table."""
    emb = params["embed"][tokens].to(COMPUTE_DTYPE)
    return emb * torch.tensor(math.sqrt(cfg.d_model), dtype=COMPUTE_DTYPE)


def _logits(params, cfg: ArchConfig, plan: CelloPlan, x: torch.Tensor):
    x = _norm(x, params["final_norm"], cfg, plan)
    return (x.to(COMPUTE_DTYPE) @ bf16(params["lm_head"])
            ).to(torch.float32)


def forward(params, cfg: ArchConfig, plan: CelloPlan, tokens: torch.Tensor,
            *, frames: Optional[torch.Tensor] = None,
            img: Optional[torch.Tensor] = None, mode: str = "prefill",
            remat_policy=None):
    """Full-sequence forward.  tokens: (B, S) int (ignored when ``frames``
    is given); frames: (B, S, D) stubbed frame embeddings (audio), taken
    in place of the token embedding; img: (B, V, D) stubbed patch
    embeddings (vlm), which the ``xattn`` layers attend to.  Returns
    (logits (B, S, padded_vocab) fp32, [cache entry per layer]): (k, v)
    for an attention layer, hT (B, D) fp32 for an RG-LRU layer, sT (B, H,
    E, E) fp32 for an RWKV layer.

    ``mode="train"`` (every family) is the forward a loss backpropagates
    through; ``remat_policy`` (train only) checkpoints every layer under
    it (module docstring)."""
    _check_family(cfg)
    if mode not in ("prefill", "train"):
        raise ValueError(f"mode {mode!r}: forward runs 'prefill' or 'train'")
    if remat_policy is not None and mode != "train":
        raise ValueError("remat_policy applies to mode='train' only")
    if frames is not None:
        x = frames.to(COMPUTE_DTYPE)
    else:
        x = embed_tokens(params, cfg, tokens)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    caches = []
    for p_layer, kind in zip(params["layers"], cfg.layer_kinds()):
        block = functools.partial(apply_block, p_layer, cfg=cfg, plan=plan,
                                  positions=positions, img=img)
        if remat_policy is not None:
            x, entry = remat_policy.checkpoint(block, x, kind)
        else:
            x, entry = block(x, kind)
        caches.append(entry)
    return _logits(params, cfg, plan, x), caches


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Shapes for the decode cache of one arch at one shape cell."""
    cfg: ArchConfig
    seq_len: int

    def z_for(self, kind: str) -> int:
        if kind in ("attn", "xattn"):
            return (min(self.cfg.window, self.seq_len) if self.cfg.window
                    else self.seq_len)
        return 0


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, *,
               device="cuda") -> Dict[str, List[Dict[str, torch.Tensor]]]:
    """Zero cache, one entry per layer by its kind: ``{"k", "v",
    "pos_idx"}`` (attention, cross-attention included), ``{"h"}`` (B, D)
    fp32 (RG-LRU) or ``{"s"}`` (B, H, E, E) fp32 (RWKV)."""
    _check_family(cfg)
    spec = CacheSpec(cfg, seq_len)
    E = cfg.resolved_head_dim

    def entry(kind: str):
        if kind in ("attn", "xattn"):
            Z = spec.z_for(kind)
            return {
                "k": torch.zeros((batch, Z, cfg.n_kv_heads, E),
                                 dtype=COMPUTE_DTYPE, device=device),
                "v": torch.zeros((batch, Z, cfg.n_kv_heads, E),
                                 dtype=COMPUTE_DTYPE, device=device),
                "pos_idx": torch.full((Z,), -1, dtype=torch.int32,
                                      device=device),
            }
        if kind == "rglru":
            return {"h": torch.zeros((batch, cfg.d_model),
                                     dtype=torch.float32, device=device)}
        if kind == "rwkv":
            return {"s": torch.zeros((batch, cfg.n_heads, E, E),
                                     dtype=torch.float32, device=device)}
        raise ValueError(kind)

    return {"layers": [entry(kind) for kind in cfg.layer_kinds()]}


def _position(pos, device) -> torch.Tensor:
    """``pos`` as a 0-d int32 tensor on ``device``: a host int becomes a
    fill on the device (a tensor from a host value would copy from pageable
    memory, which synchronizes the stream), a tensor is used as it is."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32).reshape(())
    return torch.full((), int(pos), dtype=torch.int32, device=device)


def _decode_attend(a, cache, h, pos: torch.Tensor, *, cfg: ArchConfig,
                   plan: CelloPlan, donate: bool):
    """One query token against the (ring-buffered) cache at the 0-d device
    position ``pos``.  Returns (y, cache entry): a new entry, or with
    ``donate`` the caller's, written in place.  Nothing reads ``pos`` on
    the host, so the step can be captured in a CUDA graph."""
    B = h.shape[0]
    H, KVH, E = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    xc = h.to(COMPUTE_DTYPE)
    q = (xc @ bf16(a["wq"])).reshape(B, 1, H, E)
    k_new = (xc @ bf16(a["wk"])).reshape(B, 1, KVH, E)
    v_new = (xc @ bf16(a["wv"])).reshape(B, 1, KVH, E)
    q = apply_rope(q, pos[None], cfg.rope_theta)
    k_new = apply_rope(k_new, pos[None], cfg.rope_theta)
    Z = cache["k"].shape[1]
    slot = (pos % Z).long()[None]           # index_copy takes int64
    k_new = k_new.to(cache["k"].dtype)
    v_new = v_new.to(cache["v"].dtype)
    if donate:
        k_c = cache["k"].index_copy_(1, slot, k_new)
        v_c = cache["v"].index_copy_(1, slot, v_new)
        pos_idx = cache["pos_idx"].index_copy_(0, slot, pos[None])
    elif plan.cache_select_update:
        hit = (torch.arange(Z, device=h.device) == slot)
        k_c = torch.where(hit[None, :, None, None], k_new, cache["k"])
        v_c = torch.where(hit[None, :, None, None], v_new, cache["v"])
        pos_idx = torch.where(hit, pos, cache["pos_idx"])
    else:
        k_c = cache["k"].index_copy(1, slot, k_new)
        v_c = cache["v"].index_copy(1, slot, v_new)
        pos_idx = cache["pos_idx"].index_copy(0, slot, pos[None])
    # mask by true positions (ring-buffer safe); grouped GQA einsums
    valid = (pos_idx >= 0) & (pos_idx <= pos)
    if cfg.window:
        valid &= pos_idx > pos - cfg.window
    G = H // KVH
    qg = (q * torch.tensor(E ** -0.5, dtype=q.dtype)).reshape(B, KVH, G, E)
    s = torch.einsum("bkge,btke->bkgt", qg.float(), k_c.float())
    s = torch.where(valid[None, None, None, :], s,
                    torch.full_like(s, -1e30))
    pr = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bkgt,btke->bkge", pr.to(v_c.dtype).float(),
                       v_c.float())
    y = (ctx.reshape(B, 1, H * E).to(COMPUTE_DTYPE) @ bf16(a["wo"])
         ).to(h.dtype)
    if donate:
        return y, cache
    return y, {"k": k_c, "v": v_c, "pos_idx": pos_idx}


def _decode_block(p, cache, x, kind: str, pos: torch.Tensor, *,
                  cfg: ArchConfig, plan: CelloPlan, donate: bool):
    h = _norm(x, p["ln1"], cfg, plan)
    if kind in ("attn", "xattn"):
        y, new_cache = _decode_attend(p["attn"], cache, h, pos, cfg=cfg,
                                      plan=plan, donate=donate)
    elif kind == "rglru":
        y, h_new = apply_rglru_step(p["rglru"], h, cache["h"],
                                    donate=donate)
        new_cache = cache if donate else {"h": h_new}
    elif kind == "rwkv":
        y, s_new = apply_rwkv_step(p["rwkv"], h, cache["s"], cfg.n_heads,
                                   donate=donate)
        new_cache = cache if donate else {"s": s_new}
    else:
        raise ValueError(kind)
    x = x + y
    h2 = _norm(x, p["ln2"], cfg, plan)
    x = x + _mlp(p, h2, cfg, plan)
    return x, new_cache


def decode_step(params, cache, cfg: ArchConfig, plan: CelloPlan,
                tokens: torch.Tensor, pos, *, donate: bool = False):
    """One decode step.  tokens: (B, 1) int; pos: the current position, a
    host int or a 0-d integer tensor.  Returns (logits (B, 1,
    padded_vocab) fp32, cache).

    By default the input cache is left as it was and a new one is
    returned.  ``donate=True`` is the counterpart of the JAX package's
    ``donate_argnums=(1,)``: the step writes the new k/v/``pos_idx``, ``h``
    and ``s`` into the caller's cache in place and returns that same
    cache, bitwise equal to the new one of the default form.  Neither form
    reads a device value on the host, so with a device ``pos`` the step
    can be captured in a CUDA graph (``launch.serve.jit_decode_step``)."""
    _check_family(cfg)
    x = embed_tokens(params, cfg, tokens)
    pos_t = _position(pos, x.device)
    new_layers = []
    for p_layer, c_layer, kind in zip(params["layers"], cache["layers"],
                                      cfg.layer_kinds()):
        x, nc = _decode_block(p_layer, c_layer, x, kind, pos_t, cfg=cfg,
                              plan=plan, donate=donate)
        new_layers.append(nc)
    logits = _logits(params, cfg, plan, x)
    return logits, (cache if donate else {"layers": new_layers})
