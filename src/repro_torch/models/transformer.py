"""Model assembly for every architecture family of the JAX package.

Parameters are nested dicts of tensors with per-layer leaves stacked on
axis 0, the JAX package's tree; its ``lax.scan`` over layers (and over
groups of layers) is a loop over that axis here. Entry points:

  * ``forward_train``   — tokens -> (loss, metrics), differentiable by
    torch autograd; chunked cross-entropy, so the (B, S, V) logits are
    never held, and optional per-layer activation checkpointing (remat).
  * ``prefill_forward`` — one full-sequence pass that emits the decode
    caches and the last token's logits: the serving path.
  * ``prefill``         — the token-by-token oracle through ``decode_step``.
  * ``decode_step``     — one token against the caches.

Families (``cfg.arch_type``):

  * ``dense`` — attention blocks; ``ssm`` — Mamba2 blocks.
  * ``hybrid`` (Zamba2) — groups of ``shared_attn_every`` Mamba2 blocks,
    each group followed by one application of the parameter-shared
    attention block, which has its own entry of the secondary cache stack
    (``shared_k`` / ``shared_v``).
  * ``moe`` — attention + MoE FFN blocks (``models/moe.py``). With
    ``moe_every > 1`` (Llama-4) each MoE block follows ``moe_every - 1``
    dense blocks, whose caches are the secondary stack.
  * ``vlm`` — dense blocks behind early fusion: ``frontend=`` embeddings
    (the vision tower is a stub, as in the JAX package) are projected and
    put before the text.
  * ``audio`` (Whisper) — a bidirectional encoder over the stubbed
    frontend's ``encoder_frames=`` and decoder blocks that cross-attend to
    its output; prefill stores each layer's cross K/V (``cross_k`` /
    ``cross_v``) for decode.

``impl`` selects the attention route (``models/attention.py``) and the SSD
scan's (``models/ssm.py``); None is the CUDA kernels on the card and the
plain route on the CPU for serving, and ``chunked`` on every device for
``forward_train``: the kernels have no backward (neither have the JAX
package's Pallas kernels, and its train step runs ``chunked``), so a
kernel route under autograd raises ``NotImplementedError``. Decode's
cross-attention is an einsum over the encoder's frames, as in the JAX
package.

KV caches may be of another dtype than the model's (``cfg.kv_dtype``,
fp8 included): ``init_caches`` allocates them so, ``prefill`` and
``decode_step`` write them through ``layers.astype`` (the JAX package's
cast bits), and attention reads them in the compute dtype. As in the JAX
package, ``prefill_forward`` builds its caches in the compute dtype, and
the SSM families' decode raises ``ValueError`` on an fp8 conv state.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import tree
from repro_torch.core.types import resolve_device
from repro_torch.models import attention, layers, moe, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.pspec import (embed_lookup, gathered,
                                      grad_reduced, hint, logsumexp_last,
                                      reduced, reshaped, take_last)

Tensor = torch.Tensor


def _need_frames(cfg: ModelConfig, frames: Optional[Tensor]) -> None:
    if frames is None:
        raise ValueError(
            f"{cfg.name}: an encoder-decoder model needs encoder_frames (B, "
            f"T, {cfg.frontend_dim or cfg.d_model}), its frontend's frame "
            "features; none were given")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_attn_block(gen, cfg: ModelConfig, *, cross: bool = False,
                     lead: tuple = (), **kw):
    D = cfg.d_model
    p = {
        "ln1": layers.init_norm(cfg.norm, D, lead=lead, **kw),
        "attn": attention.init_attention(gen, cfg, lead=lead, **kw),
        "ln2": layers.init_norm(cfg.norm, D, lead=lead, **kw),
        "mlp": layers.init_mlp(gen, cfg.mlp, D, cfg.d_ff, lead=lead, **kw),
    }
    if cross:
        p["ln_x"] = layers.init_norm(cfg.norm, D, lead=lead, **kw)
        p["xattn"] = attention.init_attention(gen, cfg, lead=lead, **kw)
    return p


def _init_moe_block(gen, cfg: ModelConfig, *, lead: tuple, **kw):
    D = cfg.d_model
    return {
        "ln1": layers.init_norm(cfg.norm, D, lead=lead, **kw),
        "attn": attention.init_attention(gen, cfg, lead=lead, **kw),
        "ln2": layers.init_norm(cfg.norm, D, lead=lead, **kw),
        "moe": moe.init_moe(gen, cfg, lead=lead, **kw),
    }


def _init_ssm_block(gen, cfg: ModelConfig, *, lead: tuple, **kw):
    return {
        "ln1": layers.init_norm(cfg.norm, cfg.d_model, lead=lead, **kw),
        "mixer": ssm.init_mamba2(gen, cfg, lead=lead, **kw),
    }


def stack_sizes(cfg: ModelConfig) -> Dict[str, int]:
    """The layer axis of each stacked subtree of ``init_model``'s tree (the
    hybrid's ``shared_attn`` is one unstacked block)."""
    n = {"blocks": cfg.num_layers}
    if cfg.arch_type == "moe":
        n["blocks"] = cfg.num_layers // cfg.moe_every
        if cfg.moe_every > 1:
            n["dense_blocks"] = cfg.num_layers - n["blocks"]
    if cfg.is_encdec:
        n["encoder_blocks"] = cfg.encoder_layers
    return n


def init_model(cfg: ModelConfig, *, seed: int = 0, device=None,
               dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random parameters with the JAX package's distributions and tree,
    drawn from a generator on ``device`` seeded with ``seed``. ``dtype``
    is the storage dtype: f32 master weights as in the JAX package, or
    the config's compute dtype for serving, which gives the values JAX's
    cast at use gives. On ``device="meta"`` the tree has the real one's
    shapes and dtypes and nothing is drawn or allocated (the counterpart
    of ``jax.eval_shape`` over JAX's ``init_model``)."""
    device = resolve_device(device)
    # A meta tensor takes no draw, and there is no generator on meta.
    gen = torch.Generator(
        device="cpu" if device.type == "meta" else device).manual_seed(seed)
    kw = dict(device=device, dtype=dtype)
    D = cfg.d_model
    n = stack_sizes(cfg)
    params: Dict[str, Any] = {
        "embed": layers.embed_init(gen, cfg.vocab_size, D, **kw),
        "final_norm": layers.init_norm(cfg.norm, D, **kw),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(gen, D, cfg.vocab_size, **kw)
    if cfg.arch_type in ("dense", "vlm", "audio"):
        params["blocks"] = _init_attn_block(
            gen, cfg, cross=cfg.is_encdec, lead=(n["blocks"],), **kw)
    elif cfg.arch_type == "moe":
        params["blocks"] = _init_moe_block(gen, cfg, lead=(n["blocks"],),
                                           **kw)
        if "dense_blocks" in n:  # interleaved dense layers (Llama-4 style)
            params["dense_blocks"] = _init_attn_block(
                gen, cfg, lead=(n["dense_blocks"],), **kw)
    elif cfg.arch_type in ("ssm", "hybrid"):
        params["blocks"] = _init_ssm_block(gen, cfg, lead=(n["blocks"],),
                                           **kw)
    else:
        raise ValueError(cfg.arch_type)
    if cfg.arch_type == "hybrid":
        params["shared_attn"] = _init_attn_block(gen, cfg, **kw)
    if cfg.is_encdec:
        params["encoder_blocks"] = _init_attn_block(
            gen, cfg, lead=(n["encoder_blocks"],), **kw)
        params["enc_final_norm"] = layers.init_norm(cfg.norm, D, **kw)
    if cfg.frontend_tokens > 0 or cfg.is_encdec:
        params["frontend_proj"] = layers.dense_init(
            gen, cfg.frontend_dim or D, D, **kw)
    return params


def head_weight(params, cfg: ModelConfig) -> Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unstack(tree, n: int) -> list:
    """The ``n`` per-layer trees of a stacked tree, by one ``unbind`` a
    leaf. Its backward stacks the layers' gradients once, as the JAX
    package's scan does; ``_layer``'s select per layer would build a
    zero gradient of the whole stack for each layer and add them up, work
    and memory quadratic in the depth."""
    if not isinstance(tree, dict):
        return list(torch.unbind(tree))
    parts = {k: _unstack(v, n) for k, v in tree.items()}
    return [{k: parts[k][i] for k in tree} for i in range(n)]


def _embed(params, cfg: ModelConfig, tokens: Tensor) -> Tensor:
    return params["embed"][tokens.long()].to(cfg.torch_dtype)


def _logits(params, cfg: ModelConfig, x: Tensor) -> Tensor:
    """x (B, D) after the final norm -> f32 logits (B, V)."""
    return (x @ head_weight(params, cfg).to(x.dtype)).float()


# ---------------------------------------------------------------------------
# block application (sequence form)
# ---------------------------------------------------------------------------

def _apply_attn_block_kv(p, cfg: ModelConfig, x, positions, impl, enc=None,
                         mode="causal"):
    """The block and its (roped) K/V; ``enc`` = (encoder output, its
    positions) adds the cross-attention sub-block."""
    # On a mesh each sub-block's row-parallel partial sums are completed
    # where it ends, as in the decode blocks, and the gradient of its
    # normed input where the column-parallel projections take it
    # (Megatron's all-reduces forward and backward).
    h = _normed(cfg, p["ln1"], x)
    y, kv = attention.attention(p["attn"], cfg, h, positions, mode=mode,
                                impl=impl, return_kv=True)
    x = x + reduced(y)
    if enc is not None:
        h = _normed(cfg, p["ln_x"], x)
        x = x + reduced(attention.attention(
            p["xattn"], cfg, h, positions, kv_src=enc[0],
            kv_positions=enc[1], mode="full", rope=False, impl=impl))
    h = _normed(cfg, p["ln2"], x)
    return x + reduced(layers.apply_mlp(cfg.mlp, p["mlp"], h)), kv


def _normed(cfg: ModelConfig, w, x):
    """The sub-block's norm of ``x``; on a mesh its gradient's partial
    sums are completed (pspec.grad_reduced)."""
    return grad_reduced(layers.apply_norm(cfg.norm, w, x))


def _apply_moe_block_kv(p, cfg: ModelConfig, x, positions, impl):
    """The block, its K/V and its aux loss."""
    h = _normed(cfg, p["ln1"], x)
    y, kv = attention.attention(p["attn"], cfg, h, positions, impl=impl,
                                return_kv=True)
    x = x + reduced(y)
    h = _normed(cfg, p["ln2"], x)
    y, aux = moe.apply_moe(p["moe"], cfg, h)
    return x + reduced(y), kv, aux


def _apply_ssm_block(p, cfg: ModelConfig, x, impl):
    """The block and its decode state (the scan computes the state in
    every route, so it is returned whether or not the caller keeps it)."""
    h = _normed(cfg, p["ln1"], x)
    y, st = ssm.mamba2_forward(p["mixer"], cfg, h, return_state=True,
                               impl=impl)
    return x + reduced(y), st


def _maybe_remat(fn, remat: bool):
    """Per-layer activation checkpointing: applied to each block inside
    the layer loop, so the backward holds one layer's internals at a time
    (a checkpoint around the whole forward would save nothing: the
    backward would re-run it whole). The JAX package's ``jax.checkpoint``
    inside its layer scan."""
    if not remat:
        return fn
    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                             use_reentrant=False)


def _run_stack(params, cfg: ModelConfig, x: Tensor, positions: Tensor,
               impl, enc=None, remat: bool = False):
    """The decoder blocks over a full sequence, in the order of the JAX
    package's scans, each block under ``_maybe_remat``. Returns (x, aux,
    kv, shared, states): the mean MoE aux loss (0 without MoE), and what
    the blocks emit for the caches, block by block: the primary attention
    stack's (k, v), the secondary stack's (the hybrid's shared-block
    applications, the interleaved dense layers), the SSM states."""
    kv, shared, states, auxs = [], [], [], []
    n = stack_sizes(cfg)
    blocks = _unstack(params["blocks"], n["blocks"])
    kind = cfg.arch_type
    attn_blk = _maybe_remat(_apply_attn_block_kv, remat)
    if kind in ("dense", "vlm", "audio"):
        for i in range(cfg.num_layers):
            x, kv_i = attn_blk(blocks[i], cfg, x, positions, impl, enc)
            kv.append(kv_i)
    elif kind == "moe":
        moe_blk = _maybe_remat(_apply_moe_block_kv, remat)
        per = cfg.moe_every - 1
        dense = (_unstack(params["dense_blocks"], n["dense_blocks"])
                 if per else [])
        for g in range(n["blocks"]):
            for j in range(per):
                x, kv_i = attn_blk(dense[g * per + j], cfg, x, positions,
                                   impl)
                shared.append(kv_i)
            x, kv_i, aux = moe_blk(blocks[g], cfg, x, positions, impl)
            kv.append(kv_i)
            auxs.append(aux)
    elif kind in ("ssm", "hybrid"):
        ssm_blk = _maybe_remat(_apply_ssm_block, remat)
        for i in range(cfg.num_layers):
            x, st = ssm_blk(blocks[i], cfg, x, impl)
            states.append(st)
            if kind == "hybrid" and (i + 1) % cfg.shared_attn_every == 0:
                x, kv_i = attn_blk(params["shared_attn"], cfg, x, positions,
                                   impl)
                shared.append(kv_i)
    else:
        raise ValueError(kind)
    aux = (torch.stack(auxs).mean() if auxs
           else torch.zeros((), device=x.device))
    return x, aux, kv, shared, states


def decoder_stack(params, cfg: ModelConfig, x: Tensor, positions: Tensor,
                  impl: Optional[str] = None, enc_out=None,
                  enc_positions=None, remat: bool = False):
    """The decoder blocks over a full sequence. Returns (x, aux); aux is
    the mean MoE load-balance loss, 0 for the other families."""
    enc = None if enc_out is None else (enc_out, enc_positions)
    x, aux, _, _, _ = _run_stack(params, cfg, x, positions, impl, enc,
                                 remat)
    return x, aux


def encoder_stack(params, cfg: ModelConfig, frames: Tensor,
                  impl: Optional[str] = None, remat: bool = False) -> Tensor:
    """Whisper-style bidirectional encoder over (stub) frame features
    (B, T, frontend_dim) in the compute dtype: full-mode self-attention
    with RoPE over positions 0..T-1, then the encoder's final norm."""
    x = frames @ params["frontend_proj"].to(frames.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    blk = _maybe_remat(_apply_attn_block_kv, remat)
    for p in _unstack(params["encoder_blocks"], cfg.encoder_layers):
        x, _ = blk(p, cfg, x, positions, impl, mode="full")
    return layers.apply_norm(cfg.norm, params["enc_final_norm"], x)


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


def _cross_kv(params, cfg: ModelConfig, enc_out: Tensor):
    """Every decoder layer's cross-attention K/V (L, B, T, KV, hd) from the
    encoder's output, without the projections' biases (as the JAX
    package computes them)."""
    B, T, _ = enc_out.shape
    # The broadcast product over layers flattens (L, B) into one batch,
    # which DTensor cannot split back when B is sharded on a mesh: the
    # encoder's batch is gathered first (pspec.gathered).
    enc_out = gathered(enc_out, 0)
    xattn = params["blocks"]["xattn"]
    shape = (cfg.num_layers, B, T, cfg.num_kv_heads, cfg.hd)
    return {f"cross_{n}": (enc_out @ xattn[f"w_{n}"].to(enc_out.dtype)[:, None]
                           ).reshape(shape) for n in ("k", "v")}


# ---------------------------------------------------------------------------
# training forward + chunked loss
# ---------------------------------------------------------------------------

def _ce_block(h: Tensor, w_head: Tensor, labels: Tensor,
              mask: Tensor) -> Tuple[Tensor, Tensor]:
    """One block's masked next-token NLL sum and mask sum, from f32 logits
    (B, block, V)."""
    logits = hint((h @ w_head.to(h.dtype)).float(), "logits")
    lse = logsumexp_last(logits)
    picked = take_last(logits, labels.long())
    return ((lse - picked) * mask).sum(), mask.sum()


def chunked_cross_entropy(h: Tensor, w_head: Tensor, labels: Tensor,
                          mask: Tensor, block: int = 512
                          ) -> Tuple[Tensor, Tensor]:
    """Next-token CE without holding (B, S, V) logits: each block of
    ``block`` positions runs under a checkpoint, so its logits are
    recomputed in the backward and freed after it.

    h: (B, S, D) final hidden states; labels / mask: (B, S). Returns
    (sum_nll, sum_mask) so callers can weight across microbatches."""
    S = h.shape[1]
    block = min(block, S)
    assert S % block == 0, (S, block)
    nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    m_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, block):
        sl = slice(i, i + block)
        nll, m = torch.utils.checkpoint.checkpoint(
            _ce_block, h[:, sl], w_head, labels[:, sl], mask[:, sl],
            use_reentrant=False)
        nll_sum = nll_sum + nll
        m_sum = m_sum + m
    return nll_sum, m_sum


def forward_train(params, cfg: ModelConfig, batch: Dict[str, Tensor],
                  impl: Optional[str] = "chunked", remat: bool = False
                  ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The training loss and its metrics: batch holds tokens (B, S_text)
    and labels (B, S_text), and frontend (B, F, frontend_dim) for the VLM
    family, encoder_frames (B, T, frontend_dim) for the encoder-decoder
    family (which raises ValueError without them).

    The VLM's frontend embeddings are put before the text with label
    mask 0; the MoE families add ``router_aux_weight`` times the mean
    load-balance loss. ``impl`` None is ``chunked``; ``cuda`` (the
    kernels, which have no backward) raises NotImplementedError when any
    parameter requires grad. Returns (loss, {"nll", "aux", "tokens"}),
    "nll" being the loss, as in the JAX package."""
    impl = impl or "chunked"
    if impl == "cuda" and any(t.requires_grad for t in tree.leaves(params)):
        raise NotImplementedError(
            f"{cfg.name}: impl='cuda' under autograd: the CUDA kernels have "
            "no backward (their outputs carry no gradient). Train on the "
            "'chunked' route, as the JAX package's train step does "
            "(make_train_step(impl='chunked')).")
    tokens, labels = batch["tokens"], batch["labels"]
    B = tokens.shape[0]
    dt = cfg.torch_dtype
    x = hint(params["embed"].to(dt)[tokens.long()], "activations")

    enc_out = enc_positions = None
    if cfg.is_encdec:
        frames = batch.get("encoder_frames")
        _need_frames(cfg, frames)
        enc_out = encoder_stack(params, cfg, frames.to(dt), impl,
                                remat=remat)
        enc_positions = torch.arange(enc_out.shape[1], device=x.device)
    if cfg.frontend_tokens > 0 and not cfg.is_encdec:
        fe = batch["frontend"].to(dt) @ params["frontend_proj"].to(dt)
        x = torch.cat([fe, x], dim=1)                      # early fusion
        pad = labels.new_zeros((B, cfg.frontend_tokens))
        labels = torch.cat([pad, labels], dim=1)
        mask = torch.cat([
            torch.zeros((B, cfg.frontend_tokens), device=x.device),
            torch.ones(batch["labels"].shape, device=x.device)], dim=1)
    else:
        mask = torch.ones(labels.shape, device=x.device)

    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = decoder_stack(params, cfg, x, positions, impl, enc_out,
                           enc_positions, remat=remat)
    x = _normed(cfg, params["final_norm"], x)
    nll_sum, m_sum = chunked_cross_entropy(x, head_weight(params, cfg),
                                           labels, mask)
    loss = nll_sum / torch.clamp_min(m_sum, 1.0)
    if cfg.is_moe:
        loss = loss + cfg.router_aux_weight * aux
    return loss, {"nll": loss, "aux": aux, "tokens": m_sum}


# ---------------------------------------------------------------------------
# serving: caches, prefill, decode
# ---------------------------------------------------------------------------

class DecodeCaches(NamedTuple):
    """Decode state, stacked over layers; a stack the family does not use
    is None. ``decode_step`` updates the stacks in place and returns the
    caches with ``pos`` advanced.

    ``shared_k`` / ``shared_v`` hold the secondary attention stack: the
    hybrid's parameter-shared block (one entry per application) or the
    interleaved-MoE family's dense layers (Llama-4)."""
    k: Optional[Tensor]                # (L, B, W, KV, hd) primary stack
    v: Optional[Tensor]
    pos: int                           # next absolute position
    ssm_conv: Optional[Tensor] = None  # (L, B, cw-1, d_in + 2N), KV dtype
    ssm_h: Optional[Tensor] = None     # (L, B, H, N, P) f32
    shared_k: Optional[Tensor] = None  # (n2, B, W, KV, hd) secondary stack
    shared_v: Optional[Tensor] = None
    cross_k: Optional[Tensor] = None   # (L, B, T_enc, KV, hd) Whisper
    cross_v: Optional[Tensor] = None


def cache_window(cfg: ModelConfig, seq_len: int) -> int:
    return min(seq_len, cfg.window) if cfg.window > 0 else seq_len


def init_caches(cfg: ModelConfig, batch: int, seq_len: int, *,
                enc_seq: int = 0, device=None) -> DecodeCaches:
    """Zero caches for ``batch`` rows of ``seq_len`` positions (and
    ``enc_seq`` encoder frames for the encoder-decoder family), in
    ``cfg.kv_torch_dtype`` but for the SSM state ``ssm_h``, which is
    f32."""
    kw = dict(dtype=cfg.kv_torch_dtype, device=resolve_device(device))
    kinds = cfg.layer_kinds()
    if cfg.arch_type == "moe" and cfg.moe_every > 1:
        n_attn = cfg.num_layers // cfg.moe_every           # moe layers
        n_secondary = cfg.num_layers - n_attn              # dense layers
    else:
        n_attn = sum(1 for k in kinds if k in ("attn", "moe"))
        n_secondary = 0
    if cfg.arch_type == "hybrid":
        n_secondary = cfg.num_layers // cfg.shared_attn_every
    W = cache_window(cfg, seq_len)

    def stack(n: int, rows=W):
        if not n:
            return None
        return torch.zeros((n, batch, rows, cfg.num_kv_heads, cfg.hd), **kw)

    conv = h = None
    n_ssm = sum(1 for k in kinds if k == "ssm")
    if n_ssm:
        st = ssm.init_ssm_state(cfg, batch, **kw)
        conv = st.conv.new_zeros((n_ssm,) + st.conv.shape)
        h = st.h.new_zeros((n_ssm,) + st.h.shape)
    n_cross = cfg.num_layers if cfg.is_encdec else 0
    return DecodeCaches(
        k=stack(n_attn), v=stack(n_attn), pos=0, ssm_conv=conv, ssm_h=h,
        shared_k=stack(n_secondary), shared_v=stack(n_secondary),
        cross_k=stack(n_cross, enc_seq), cross_v=stack(n_cross, enc_seq))


def _decode_attn_block(p, cfg: ModelConfig, x, kc, vc, pos: int, impl,
                       cross_kv=None):
    # On a mesh each row-parallel projection's partial sums are completed
    # where the sub-block ends, once, in the compute dtype (Megatron's
    # two all-reduces a block); DTensor would carry them on into the norm
    # and complete them there, in f32, for each use.
    h = layers.apply_norm(cfg.norm, p["ln1"], x)
    y, kc, vc = attention.decode_attention(p["attn"], cfg, h, kc, vc, pos,
                                           impl=impl)
    x = x + reduced(y)
    if cross_kv is not None:
        h = layers.apply_norm(cfg.norm, p["ln_x"], x)
        x = x + reduced(_cross_decode(p["xattn"], cfg, h, *cross_kv))
    h = layers.apply_norm(cfg.norm, p["ln2"], x)
    return x + reduced(layers.apply_mlp(cfg.mlp, p["mlp"], h)), kc, vc


def _cross_decode(p, cfg: ModelConfig, x, ck, cv):
    """Cross-attention of one decode token against the precomputed
    (B, T_enc, KV, hd) K/V: the einsum form, as in the JAX package (no
    kernel; the encoder's 1,500 frames need not be tile-divisible)."""
    B = x.shape[0]
    dt = x.dtype
    q = (x @ p["w_q"].to(dt)).reshape(B, 1, cfg.num_heads, cfg.hd)
    valid = torch.ones(ck.shape[1], dtype=torch.bool, device=x.device)
    out = attention._einsum_decode(q, ck, cv, valid)
    return reshaped(out, (B, 1, cfg.num_heads * cfg.hd), 2,
                    cfg.num_heads) @ p["w_o"].to(dt)


def _decode_moe_block(p, cfg: ModelConfig, x, kc, vc, pos: int, impl):
    h = layers.apply_norm(cfg.norm, p["ln1"], x)
    y, kc, vc = attention.decode_attention(p["attn"], cfg, h, kc, vc, pos,
                                           impl=impl)
    x = x + reduced(y)
    h = layers.apply_norm(cfg.norm, p["ln2"], x)
    y, _ = moe.apply_moe(p["moe"], cfg, h)
    return x + reduced(y), kc, vc


def _decode_ssm_block(p, cfg: ModelConfig, x, state: ssm.SSMState):
    h = layers.apply_norm(cfg.norm, p["ln1"], x)
    y, state = ssm.mamba2_decode(p["mixer"], cfg, h, state)
    return x + reduced(y), state


def _decode_layers(params, cfg: ModelConfig, x: Tensor,
                   caches: DecodeCaches, impl) -> Tensor:
    """One token's activations (B, 1, D) through every block at position
    ``caches.pos``, writing the caches in place; returns the last block's
    output."""
    pos = caches.pos
    blocks = params["blocks"]
    kind = cfg.arch_type
    if kind in ("dense", "vlm", "audio"):
        if cfg.is_encdec and caches.cross_k is None:
            raise ValueError(f"{cfg.name}: the caches hold no cross-attention "
                             "K/V; prefill with encoder_frames first")
        for i in range(cfg.num_layers):
            cross = ((caches.cross_k[i], caches.cross_v[i])
                     if cfg.is_encdec else None)
            x, _, _ = _decode_attn_block(_layer(blocks, i), cfg, x,
                                         caches.k[i], caches.v[i], pos, impl,
                                         cross)
    elif kind == "moe":
        per = cfg.moe_every - 1
        for g in range(stack_sizes(cfg)["blocks"]):
            for j in range(per):
                d = g * per + j
                x, _, _ = _decode_attn_block(
                    _layer(params["dense_blocks"], d), cfg, x,
                    caches.shared_k[d], caches.shared_v[d], pos, impl)
            x, _, _ = _decode_moe_block(_layer(blocks, g), cfg, x,
                                        caches.k[g], caches.v[g], pos, impl)
    elif kind in ("ssm", "hybrid"):
        for i in range(cfg.num_layers):
            x, st = _decode_ssm_block(_layer(blocks, i), cfg, x, ssm.SSMState(
                caches.ssm_conv[i], caches.ssm_h[i]))
            caches.ssm_conv[i].copy_(st.conv)
            caches.ssm_h[i].copy_(st.h)
            if kind == "hybrid" and (i + 1) % cfg.shared_attn_every == 0:
                a = i // cfg.shared_attn_every
                x, _, _ = _decode_attn_block(
                    params["shared_attn"], cfg, x, caches.shared_k[a],
                    caches.shared_v[a], pos, impl)
    else:
        raise ValueError(kind)
    return x


def decode_step(params, cfg: ModelConfig, token: Tensor,
                caches: DecodeCaches, impl: Optional[str] = None):
    """One serve step: token (B, 1) -> f32 logits (B, V), caches (updated
    in place, ``pos`` advanced)."""
    # On a mesh the (B, 1) ids are gathered (a token sharded over several
    # mesh axes, pod and data, has no DTensor rule for the lookup), and a
    # table sharded on the vocabulary is looked up on its shards.
    x = embed_lookup(params["embed"], gathered(token, 0).long())
    x = _decode_layers(params, cfg, x.to(cfg.torch_dtype), caches, impl)
    x = layers.apply_norm(cfg.norm, params["final_norm"], x)
    return _logits(params, cfg, x[:, 0]), caches._replace(pos=caches.pos + 1)


def _decode_embedded(params, cfg: ModelConfig, x_emb: Tensor,
                     caches: DecodeCaches, impl):
    """``decode_step`` fed with an embedding (B, 1, D) instead of a token
    id: the VLM's patch embeddings in the oracle prefill. Returns (None,
    caches with ``pos`` advanced), as the JAX package does."""
    if cfg.arch_type not in ("dense", "vlm", "audio") or cfg.is_encdec:
        raise NotImplementedError(
            "embedded prefill only used for decoder-only VLM")
    _decode_layers(params, cfg, x_emb, caches, impl)
    return None, caches._replace(pos=caches.pos + 1)


def prefill(params, cfg: ModelConfig, tokens: Tensor, *,
            frontend: Optional[Tensor] = None,
            encoder_frames: Optional[Tensor] = None,
            cache_len: Optional[int] = None, impl: Optional[str] = None):
    """The prompt through ``decode_step`` token by token (the oracle of
    ``prefill_forward``), after the encoder's cross K/V (encoder-decoder)
    or the frontend embeddings fed as pseudo-tokens (VLM). As in the JAX
    package, the caches hold ``cache_len`` or S positions, S the text's
    length. Returns (logits of the last position, caches)."""
    B, S = tokens.shape
    if cfg.is_encdec:
        _need_frames(cfg, encoder_frames)
    enc_seq = 0 if encoder_frames is None else encoder_frames.shape[1]
    caches = init_caches(cfg, B, cache_len or S, enc_seq=enc_seq,
                         device=tokens.device)
    dt = cfg.torch_dtype
    if cfg.is_encdec:
        # ``einsum`` is a decode route only; the encoder then runs the JAX
        # package's default, ``chunked``.
        enc_out = encoder_stack(params, cfg, encoder_frames.to(dt),
                                "chunked" if impl == "einsum" else impl)
        caches = caches._replace(**_cross_kv(params, cfg, enc_out))
    if frontend is not None:
        fe = frontend.to(dt) @ params["frontend_proj"].to(dt)
        for i in range(fe.shape[1]):
            _, caches = _decode_embedded(params, cfg, fe[:, i:i + 1], caches,
                                         impl)
    logits = None
    for i in range(S):
        logits, caches = decode_step(params, cfg, tokens[:, i:i + 1], caches,
                                     impl)
    return logits, caches


def prefill_forward(params, cfg: ModelConfig, tokens: Tensor, *,
                    frontend: Optional[Tensor] = None,
                    encoder_frames: Optional[Tensor] = None,
                    cache_len: Optional[int] = None,
                    impl: Optional[str] = None):
    """Batched prefill: one full-sequence pass that emits the decode
    caches (roped per-layer K/V in ring-buffer layout, SSM conv windows
    and states, the secondary stack, the cross K/V) and the last token's
    f32 logits (B, V). ``frontend`` (B, F, frontend_dim) is put before the
    text (VLM); ``encoder_frames`` (B, T, frontend_dim) feed the encoder
    (encoder-decoder, which raises ValueError without them). The caches
    are in the compute dtype whatever ``cfg.kv_dtype`` says, as the JAX
    package's are."""
    # On a mesh the lookup leaves the rows sharded on D; they are gathered
    # once, so that each block's projections start from rows whole on
    # the model axis (else every projection is a pending partial sum).
    x = gathered(_embed(params, cfg, tokens), -1)
    dt = x.dtype
    enc = None
    if cfg.is_encdec:
        _need_frames(cfg, encoder_frames)
        enc_out = encoder_stack(params, cfg, encoder_frames.to(dt), impl)
        enc = (enc_out, torch.arange(enc_out.shape[1], device=x.device))
    elif frontend is not None:
        fe = frontend.to(dt) @ params["frontend_proj"].to(dt)
        x = torch.cat([fe, x], dim=1)                      # early fusion
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    W = cache_window(cfg, cache_len or S)
    x, _, kv, shared, states = _run_stack(params, cfg, x, positions, impl,
                                          enc)

    def place(pairs, i):
        if not pairs:
            return None
        return _place_kv(torch.stack([p[i] for p in pairs]), W, S)

    caches = DecodeCaches(
        k=place(kv, 0), v=place(kv, 1), pos=S,
        ssm_conv=torch.stack([s.conv for s in states]) if states else None,
        ssm_h=torch.stack([s.h for s in states]) if states else None,
        shared_k=place(shared, 0), shared_v=place(shared, 1))
    if enc is not None:
        caches = caches._replace(**_cross_kv(params, cfg, enc[0]))
    x = layers.apply_norm(cfg.norm, params["final_norm"], x)
    return _logits(params, cfg, x[:, -1]), caches
