"""Model assembly for the dense decoder and SSM (Mamba2) families.

Parameters are nested dicts of tensors with per-layer leaves stacked on
axis 0, the JAX package's tree; its ``lax.scan`` over layers is a loop
over that axis here. Entry points:

  * ``prefill_forward`` — one full-sequence pass that emits the decode
    caches (roped K/V in ring-buffer layout, or the SSM conv windows and
    states) and last-token logits: the serving path.
  * ``prefill``         — the token-by-token oracle through ``decode_step``.
  * ``decode_step``     — one token against the caches.

``impl`` selects the attention route (``models/attention.py``) and the
SSD scan's (``models/ssm.py``); None is the CUDA kernels on the card and
the plain route on the CPU. The MoE, hybrid, encoder-decoder and VLM
families, and fp8 KV caches, are not ported yet: they raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.core.types import resolve_device
from repro_torch.models import attention, layers, ssm
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def _check_ported(cfg: ModelConfig) -> None:
    if (cfg.arch_type not in ("dense", "ssm") or cfg.is_encdec
            or cfg.frontend_tokens):
        raise NotImplementedError(
            f"{cfg.name}: arch_type={cfg.arch_type!r} is not ported yet; "
            "the PyTorch port serves the dense and SSM families")
    if cfg.kv_dtype and cfg.kv_dtype != cfg.dtype:
        raise NotImplementedError(
            f"{cfg.name}: kv_dtype={cfg.kv_dtype!r} (a KV cache in another "
            "dtype than the model's) is not ported yet")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_model(cfg: ModelConfig, *, seed: int = 0, device=None,
               dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random parameters with the JAX package's distributions, drawn from
    a generator on ``device`` seeded with ``seed``. ``dtype`` is the
    storage dtype: f32 master weights as in the JAX package, or the
    config's compute dtype for serving, which gives the values JAX's cast
    at use gives."""
    _check_ported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(device=device, dtype=dtype)
    D, L = cfg.d_model, (cfg.num_layers,)
    params: Dict[str, Any] = {
        "embed": layers.embed_init(gen, cfg.vocab_size, D, **kw),
        "final_norm": layers.init_norm(cfg.norm, D, **kw),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(gen, D, cfg.vocab_size, **kw)
    if cfg.arch_type == "ssm":
        params["blocks"] = {
            "ln1": layers.init_norm(cfg.norm, D, lead=L, **kw),
            "mixer": ssm.init_mamba2(gen, cfg, lead=L, **kw),
        }
        return params
    params["blocks"] = {
        "ln1": layers.init_norm(cfg.norm, D, lead=L, **kw),
        "attn": attention.init_attention(gen, cfg, lead=L, **kw),
        "ln2": layers.init_norm(cfg.norm, D, lead=L, **kw),
        "mlp": layers.init_mlp(gen, cfg.mlp, D, cfg.d_ff, lead=L, **kw),
    }
    return params


def head_weight(params, cfg: ModelConfig) -> Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _embed(params, cfg: ModelConfig, tokens: Tensor) -> Tensor:
    return params["embed"][tokens.long()].to(cfg.torch_dtype)


def _logits(params, cfg: ModelConfig, x: Tensor) -> Tensor:
    """x (B, D) after the final norm -> f32 logits (B, V)."""
    return (x @ head_weight(params, cfg).to(x.dtype)).float()


# ---------------------------------------------------------------------------
# block application (sequence form)
# ---------------------------------------------------------------------------

def _apply_attn_block(p, cfg: ModelConfig, x, positions, impl,
                      mode="causal"):
    h = layers.apply_norm(cfg.norm, p["ln1"], x)
    x = x + attention.attention(p["attn"], cfg, h, positions, mode=mode,
                                impl=impl)
    h = layers.apply_norm(cfg.norm, p["ln2"], x)
    return x + layers.apply_mlp(cfg.mlp, p["mlp"], h)


def _apply_ssm_block(p, cfg: ModelConfig, x, impl):
    """The block and its decode state (the scan computes the state in
    every route, so it is returned whether or not the caller keeps it)."""
    h = layers.apply_norm(cfg.norm, p["ln1"], x)
    y, st = ssm.mamba2_forward(p["mixer"], cfg, h, return_state=True,
                               impl=impl)
    return x + y, st


def decoder_stack(params, cfg: ModelConfig, x: Tensor, positions: Tensor,
                  impl: Optional[str] = None):
    """The decoder blocks over a full sequence. Returns (x, aux); aux is
    the MoE load-balance loss, 0 for the dense and SSM families."""
    _check_ported(cfg)
    for i in range(cfg.num_layers):
        p = _layer(params["blocks"], i)
        if cfg.arch_type == "ssm":
            x, _ = _apply_ssm_block(p, cfg, x, impl)
        else:
            x = _apply_attn_block(p, cfg, x, positions, impl)
    return x, torch.zeros((), device=x.device)


def _apply_attn_block_kv(p, cfg: ModelConfig, x, positions, impl):
    h = layers.apply_norm(cfg.norm, p["ln1"], x)
    y, (k, v) = attention.attention(p["attn"], cfg, h, positions,
                                    impl=impl, return_kv=True)
    x = x + y
    h = layers.apply_norm(cfg.norm, p["ln2"], x)
    return x + layers.apply_mlp(cfg.mlp, p["mlp"], h), (k, v)


def _place_kv(ks: Tensor, W: int, S: int) -> Tensor:
    """(n, B, S, KV, hd) fresh K/V -> (n, B, W, KV, hd) ring-buffer layout
    with next position = S (slot of absolute position p is p mod W)."""
    n, B = ks.shape[0], ks.shape[1]
    if W >= S:
        pad = ks.new_zeros((n, B, W - S) + ks.shape[3:])
        return torch.cat([ks, pad], dim=2)
    slots = torch.arange(S - W, S, device=ks.device) % W
    cache = ks.new_zeros((n, B, W) + ks.shape[3:])
    cache[:, :, slots] = ks[:, :, S - W:]
    return cache


# ---------------------------------------------------------------------------
# serving: caches, prefill, decode
# ---------------------------------------------------------------------------

class DecodeCaches(NamedTuple):
    """Decode state: the attention stack's K/V (dense family) or the SSM
    stack's conv windows and states (SSM family); the other pair is None.
    ``decode_step`` updates them in place and returns the caches with
    ``pos`` advanced. The JAX package's secondary and cross-attention
    stacks belong to families this port does not run yet."""
    k: Optional[Tensor]                # (L, B, W, KV, hd)
    v: Optional[Tensor]
    pos: int                           # next absolute position
    ssm_conv: Optional[Tensor] = None  # (L, B, cw-1, d_in + 2N), KV dtype
    ssm_h: Optional[Tensor] = None     # (L, B, H, N, P) f32


def cache_window(cfg: ModelConfig, seq_len: int) -> int:
    return min(seq_len, cfg.window) if cfg.window > 0 else seq_len


def init_caches(cfg: ModelConfig, batch: int, seq_len: int, *,
                device=None) -> DecodeCaches:
    _check_ported(cfg)
    kw = dict(dtype=cfg.kv_torch_dtype, device=resolve_device(device))
    if cfg.arch_type == "ssm":
        st = ssm.init_ssm_state(cfg, batch, **kw)
        n = cfg.num_layers
        return DecodeCaches(
            k=None, v=None, pos=0,
            ssm_conv=st.conv.new_zeros((n,) + st.conv.shape),
            ssm_h=st.h.new_zeros((n,) + st.h.shape))
    W = cache_window(cfg, seq_len)
    shape = (cfg.num_layers, batch, W, cfg.num_kv_heads, cfg.hd)
    return DecodeCaches(torch.zeros(shape, **kw), torch.zeros(shape, **kw), 0)


def _decode_attn_block(p, cfg: ModelConfig, x, kc, vc, pos: int, impl):
    h = layers.apply_norm(cfg.norm, p["ln1"], x)
    y, kc, vc = attention.decode_attention(p["attn"], cfg, h, kc, vc, pos,
                                           impl=impl)
    x = x + y
    h = layers.apply_norm(cfg.norm, p["ln2"], x)
    return x + layers.apply_mlp(cfg.mlp, p["mlp"], h), kc, vc


def _decode_ssm_block(p, cfg: ModelConfig, x, state: ssm.SSMState):
    h = layers.apply_norm(cfg.norm, p["ln1"], x)
    y, state = ssm.mamba2_decode(p["mixer"], cfg, h, state)
    return x + y, state


def decode_step(params, cfg: ModelConfig, token: Tensor,
                caches: DecodeCaches, impl: Optional[str] = None):
    """One serve step: token (B, 1) -> f32 logits (B, V), caches (updated
    in place, ``pos`` advanced)."""
    _check_ported(cfg)
    x = _embed(params, cfg, token)                           # (B, 1, D)
    for i in range(cfg.num_layers):
        p = _layer(params["blocks"], i)
        if cfg.arch_type == "ssm":
            x, st = _decode_ssm_block(p, cfg, x, ssm.SSMState(
                caches.ssm_conv[i], caches.ssm_h[i]))
            caches.ssm_conv[i].copy_(st.conv)
            caches.ssm_h[i].copy_(st.h)
        else:
            x, _, _ = _decode_attn_block(p, cfg, x, caches.k[i], caches.v[i],
                                         caches.pos, impl)
    x = layers.apply_norm(cfg.norm, params["final_norm"], x)
    return _logits(params, cfg, x[:, 0]), caches._replace(pos=caches.pos + 1)


def prefill(params, cfg: ModelConfig, tokens: Tensor, *,
            cache_len: Optional[int] = None, impl: Optional[str] = None):
    """The prompt through ``decode_step`` token by token (the oracle of
    ``prefill_forward``). Returns (logits of the last position, caches)."""
    B, S = tokens.shape
    caches = init_caches(cfg, B, cache_len or S, device=tokens.device)
    logits = None
    for i in range(S):
        logits, caches = decode_step(params, cfg, tokens[:, i:i + 1], caches,
                                     impl)
    return logits, caches


def prefill_forward(params, cfg: ModelConfig, tokens: Tensor, *,
                    cache_len: Optional[int] = None,
                    impl: Optional[str] = None):
    """Batched prefill: one full-sequence pass that emits the decode
    caches (roped per-layer K/V in ring-buffer layout, or the SSM stack's
    conv windows and states) and the last token's f32 logits (B, V)."""
    _check_ported(cfg)
    x = _embed(params, cfg, tokens)
    S = x.shape[1]
    if cfg.arch_type == "ssm":
        convs, hs = [], []
        for i in range(cfg.num_layers):
            x, st = _apply_ssm_block(_layer(params["blocks"], i), cfg, x,
                                     impl)
            convs.append(st.conv)
            hs.append(st.h)
        caches = DecodeCaches(k=None, v=None, pos=S,
                              ssm_conv=torch.stack(convs),
                              ssm_h=torch.stack(hs))
    else:
        positions = torch.arange(S, device=x.device)
        W = cache_window(cfg, cache_len or S)
        ks, vs = [], []
        for i in range(cfg.num_layers):
            x, (k, v) = _apply_attn_block_kv(_layer(params["blocks"], i),
                                             cfg, x, positions, impl)
            ks.append(k)
            vs.append(v)
        caches = DecodeCaches(k=_place_kv(torch.stack(ks), W, S),
                              v=_place_kv(torch.stack(vs), W, S), pos=S)
    x = layers.apply_norm(cfg.norm, params["final_norm"], x)
    return _logits(params, cfg, x[:, -1]), caches
