"""Config-driven model assembly, dense family.

The counterpart of ``repro.models.transformer`` for ``family == "dense"``
archs (granite-3-8b, gemma-7b, minitron-8b, h2o-danube-1.8b): the other
families (moe, hybrid, ssm, vlm, audio) raise ``NotImplementedError``;
they are queued in ROADMAP.md.

Parameters are a plain dict, ``{"embed", "final_norm", "lm_head",
"layers": [per-layer dict]}``: the JAX package's ``lax.scan`` over stacked
periods becomes a Python loop over layers (``models.convert`` unstacks a
JAX parameter tree into this form).

Kernel selection follows the plan, as in the JAX package, but by device:
where the plan turns a kernel on, the model calls its wrapper
(``repro_torch.kernels``), which launches the hand-written kernel for
tensors on the card and runs its plain version for tensors on the CPU.
(The JAX package calls its Pallas kernels only where the backend is a TPU,
and otherwise takes jnp paths of its own.)  B6 gets the fp32 weights
uncast, as the JAX package passes them to its kernel.

Modes:
  forward(..., mode="prefill") — full sequence; also returns each layer's
    (k, v).
  decode_step(...) — one token against the cache (ring-buffered when the
    arch uses a bounded attention window).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch

from ..configs.base import ArchConfig
from ..core.policy import CelloPlan
from .attention import flash_attention_bshe, naive_attention
from .common import (COMPUTE_DTYPE, PARAM_DTYPE, activation_fn, apply_rope,
                     is_gated, rms_norm)

Params = Dict[str, Any]


def _dense_only(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported to "
            "repro_torch yet (ROADMAP.md); only 'dense' archs run")


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

def _dense(gen: torch.Generator, shape, scale: float, device,
           dtype=PARAM_DTYPE) -> torch.Tensor:
    out = torch.randn(shape, generator=gen, device=device,
                      dtype=torch.float32)
    return out.mul_(scale).to(dtype)


def init_block_params(gen: torch.Generator, cfg: ArchConfig, *, device,
                      dtype=PARAM_DTYPE) -> Params:
    """One attention block (every layer of a dense arch)."""
    D, H, KVH, E = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    s = D ** -0.5
    p: Params = {
        "ln1": torch.zeros((D,), dtype=dtype, device=device),
        "ln2": torch.zeros((D,), dtype=dtype, device=device),
        "attn": {
            "wq": _dense(gen, (D, H * E), s, device, dtype),
            "wk": _dense(gen, (D, KVH * E), s, device, dtype),
            "wv": _dense(gen, (D, KVH * E), s, device, dtype),
            "wo": _dense(gen, (H * E, D), (H * E) ** -0.5, device, dtype),
        },
    }
    F = cfg.d_ff
    p["mlp"] = {"w_up": _dense(gen, (D, F), s, device, dtype),
                "w_down": _dense(gen, (F, D), F ** -0.5, device, dtype)}
    if is_gated(cfg.activation):
        p["mlp"]["w_gate"] = _dense(gen, (D, F), s, device, dtype)
    return p


def init_params(cfg: ArchConfig, *, seed: int = 0, device="cuda",
                dtype=PARAM_DTYPE) -> Params:
    """Random weights from ``seed``, with the JAX package's shapes and
    scales (its numbers differ: a ``torch.Generator`` on ``device`` draws
    them).  ``device`` is ``"cuda"`` unless the caller asks for the CPU."""
    _dense_only(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    D = cfg.d_model
    params: Params = {
        "embed": _dense(gen, (cfg.padded_vocab, D), D ** -0.5, device,
                        dtype),
        "final_norm": torch.zeros((D,), dtype=dtype, device=device),
        "lm_head": _dense(gen, (D, cfg.padded_vocab), D ** -0.5, device,
                          dtype),
    }
    params["layers"] = [init_block_params(gen, cfg, device=device,
                                          dtype=dtype)
                        for _ in range(cfg.n_layers)]
    return params


# ---------------------------------------------------------------------------
# block application — full sequence
# ---------------------------------------------------------------------------

def _bf16(w: torch.Tensor) -> torch.Tensor:
    return w.to(COMPUTE_DTYPE)


def _attend(p_attn, x, *, cfg: ArchConfig, plan: CelloPlan, causal: bool,
            positions: torch.Tensor
            ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    B, S, D = x.shape
    H, KVH, E = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    xc = x.to(COMPUTE_DTYPE)
    q = (xc @ _bf16(p_attn["wq"])).reshape(B, S, H, E)
    k = (xc @ _bf16(p_attn["wk"])).reshape(B, S, KVH, E)
    v = (xc @ _bf16(p_attn["wv"])).reshape(B, S, KVH, E)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if plan.use_flash_attention:
        ctx = flash_attention_bshe(q, k, v, causal=causal, window=cfg.window)
    else:
        ctx = naive_attention(q, k, v, causal=causal, window=cfg.window)
    out = (ctx.reshape(B, S, H * E).to(COMPUTE_DTYPE)
           @ _bf16(p_attn["wo"]))
    return out.to(x.dtype), (k, v)


def _mlp(p, x, cfg: ArchConfig, plan: CelloPlan) -> torch.Tensor:
    B, S, D = x.shape
    flat = x.reshape(B * S, D)
    m = p["mlp"]
    gated = is_gated(cfg.activation)
    act_name = {"swiglu": "silu", "geglu": "gelu", "relu2": "relu2",
                "gelu": "gelu"}[cfg.activation]
    if plan.use_fused_mlp:
        from ..kernels.fused_mlp import fused_mlp
        out = fused_mlp(flat.to(COMPUTE_DTYPE).contiguous(), m.get("w_gate"),
                        m["w_up"], m["w_down"], activation=act_name)
    else:
        xc = flat.to(COMPUTE_DTYPE)
        act = activation_fn(cfg.activation)
        up = xc @ _bf16(m["w_up"])
        if gated:
            g = xc @ _bf16(m["w_gate"])
            h = act(g.to(torch.float32)).to(COMPUTE_DTYPE) * up
        else:
            h = act(up.to(torch.float32)).to(COMPUTE_DTYPE)
        out = h @ _bf16(m["w_down"])
    return out.reshape(B, S, D).to(x.dtype)


def apply_block(p, x, *, cfg: ArchConfig, plan: CelloPlan,
                positions: torch.Tensor):
    """Full-sequence attention block. Returns (x_out, (k, v))."""
    fused = plan.use_fused_rmsnorm
    h = rms_norm(x, p["ln1"], cfg.norm_eps, fused=fused)
    y, kv = _attend(p["attn"], h, cfg=cfg, plan=plan,
                    causal=not cfg.encoder_only, positions=positions)
    x = x + y
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps, fused=fused)
    x = x + _mlp(p, h2, cfg, plan)
    return x, kv


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
    x = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 fused=plan.use_fused_rmsnorm)
    return (x.to(COMPUTE_DTYPE) @ _bf16(params["lm_head"])
            ).to(torch.float32)


def forward(params, cfg: ArchConfig, plan: CelloPlan, tokens: torch.Tensor,
            *, mode: str = "prefill"):
    """Full-sequence forward.  tokens: (B, S) int.  Returns (logits
    (B, S, padded_vocab) fp32, [(k, v) per layer])."""
    _dense_only(cfg)
    if mode not in ("prefill", "train"):
        raise ValueError(f"mode {mode!r}: forward runs 'prefill' (a "
                         "training step is not ported yet)")
    x = embed_tokens(params, cfg, tokens)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    caches = []
    for p_layer in params["layers"]:
        x, kv = apply_block(p_layer, x, cfg=cfg, plan=plan,
                            positions=positions)
        caches.append(kv)
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
    """Zero cache, one ``{"k", "v", "pos_idx"}`` entry per layer."""
    _dense_only(cfg)
    spec = CacheSpec(cfg, seq_len)
    E = cfg.resolved_head_dim

    def entry():
        Z = spec.z_for("attn")
        return {
            "k": torch.zeros((batch, Z, cfg.n_kv_heads, E),
                             dtype=COMPUTE_DTYPE, device=device),
            "v": torch.zeros((batch, Z, cfg.n_kv_heads, E),
                             dtype=COMPUTE_DTYPE, device=device),
            "pos_idx": torch.full((Z,), -1, dtype=torch.int32,
                                  device=device),
        }

    return {"layers": [entry() for _ in range(cfg.n_layers)]}


def _decode_block(p, cache, x, pos: int, *, cfg: ArchConfig,
                  plan: CelloPlan):
    B = x.shape[0]
    H, KVH, E = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    fused = plan.use_fused_rmsnorm
    h = rms_norm(x, p["ln1"], cfg.norm_eps, fused=fused)
    xc = h.to(COMPUTE_DTYPE)
    a = p["attn"]
    q = (xc @ _bf16(a["wq"])).reshape(B, 1, H, E)
    k_new = (xc @ _bf16(a["wk"])).reshape(B, 1, KVH, E)
    v_new = (xc @ _bf16(a["wv"])).reshape(B, 1, KVH, E)
    # a fill on the device: a tensor from a host list would copy from
    # pageable memory, which synchronizes the stream at every layer
    pos_t = torch.full((1,), pos, device=x.device)
    q = apply_rope(q, pos_t, cfg.rope_theta)
    k_new = apply_rope(k_new, pos_t, cfg.rope_theta)
    Z = cache["k"].shape[1]
    slot = pos % Z
    if plan.cache_select_update:
        hit = (torch.arange(Z, device=x.device) == slot)
        k_c = torch.where(hit[None, :, None, None],
                          k_new.to(cache["k"].dtype), cache["k"])
        v_c = torch.where(hit[None, :, None, None],
                          v_new.to(cache["v"].dtype), cache["v"])
        pos_idx = torch.where(hit, torch.full_like(cache["pos_idx"], pos),
                              cache["pos_idx"])
    else:
        k_c, v_c = cache["k"].clone(), cache["v"].clone()
        pos_idx = cache["pos_idx"].clone()
        k_c[:, slot] = k_new[:, 0]
        v_c[:, slot] = v_new[:, 0]
        pos_idx[slot] = pos
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
    y = (ctx.reshape(B, 1, H * E).to(COMPUTE_DTYPE) @ _bf16(a["wo"])
         ).to(x.dtype)
    x = x + y
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps, fused=fused)
    x = x + _mlp(p, h2, cfg, plan)
    return x, {"k": k_c, "v": v_c, "pos_idx": pos_idx}


def decode_step(params, cache, cfg: ArchConfig, plan: CelloPlan,
                tokens: torch.Tensor, pos: int):
    """One decode step.  tokens: (B, 1) int; pos: the current position.
    Returns (logits (B, 1, padded_vocab) fp32, new cache); the input cache
    is left as it was."""
    _dense_only(cfg)
    x = embed_tokens(params, cfg, tokens)
    new_layers = []
    for p_layer, c_layer in zip(params["layers"], cache["layers"]):
        x, nc = _decode_block(p_layer, c_layer, x, int(pos), cfg=cfg,
                              plan=plan)
        new_layers.append(nc)
    return _logits(params, cfg, plan, x), {"layers": new_layers}
