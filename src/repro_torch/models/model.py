"""Model facade of the PyTorch port, twin of ``repro.models.model``.

All six families are ported: dense (``[attn -> mlp] x L`` with the local:global
period of ``_period``/``_window_for``; gemma3's windowed layers keep a ring-buffer
cache of W slots, slot = position mod W), moe (``[attn -> moe] x L``, the dense
stack with ``_ff``'s MoE branch; the layers' load-balance losses summed into
``forward``'s aux), ssm (``[mamba2 SSD] x L``), hybrid
(zamba2: ``[[mamba2 SSD] x k -> shared attn+mlp block] x G``, then the
``L - G*k`` tail layers; the one shared block's params serve every group),
encdec (whisper: an encoder ``[attn -> mlp] x Le``, not causal, over the frame
embeddings, then the decoder ``[attn -> xattn -> mlp] x L``, whose
cross-attention reads the encoder's output; its cross K/V are written once at
prefill and read by every decode step) and vlm (llama-3.2-vision:
``[[attn -> mlp] x (k-1) -> tanh-gated xattn -> mlp] x (L/k)`` over the patch
embeddings). A cross-attention has no RoPE and no qk-norm, and no mask.
PyTorch runs eagerly, so ``lax.scan`` over the stacked layer params becomes a
Python loop over the leading "layers" dim. Three entry points: ``forward`` (full
sequence), ``prefill`` (cache build + last-token logits) and ``decode_step``
(one token against the cache). The cache layout is declared once as a
``TensorDef`` tree (``cache_defs``) that ``init_cache`` and the server's
batch-axis search both read.

The cache is updated in place: ``decode_step`` writes the new token's k/v (dense
and the hybrid's shared block; at slot pos mod W in a windowed layer's ring) and
the new conv tail and SSD state (ssm and the hybrid's mamba2 layers) into the
tensors of the cache it is given and returns them in the new cache.

Every residual add runs fused with the norm that reads its sum
(``ops.add_rmsnorm``): a block returns the residual stream ``x`` and its
un-added output ``d``, and the next block's ln1 (or the final norm in
``_unembed``) adds them as it normalises.

The Trainer's frames and patches are bf16 whatever the params' dtype, as the
JAX package's are; there its products and adds promote bf16 to f32 exactly, and
its rmsnorm rounds to its input's dtype. PyTorch's matmul and K2 refuse mixed
dtypes, so the port casts in two places and rounds as the JAX package does:
``Model._encode`` (the frames, the one stream that enters a stack in another
dtype than its params) and ``layers.qkv_project`` (``kv_from`` in another dtype
than the weights).

Training (every family ported): ``loss_fn`` is the twin of the JAX package's, masked
CE by gather (with ``cfg.loss_chunk``, per-chunk CE under
``torch.utils.checkpoint``) over ``forward``. Autograd runs through the kernels'
autograd Functions (``kernels/autograd.py``). The layer loop takes each layer's
params as ``unbind`` views of the stacked leaves, so their gradients are stacked
once rather than summed from a full-size gradient per layer; the hybrid's shared
block gets the sum of its G applications' gradients.

``cfg.remat`` (``_remat``, twin of the JAX package's) wraps the units the JAX
package wraps in ``jax.checkpoint``: a dense/moe/encdec-decoder group of
``_period`` layers, an ssm layer, a hybrid group (k mamba2 layers and the shared
block) and a hybrid tail layer, a vlm group, an encoder layer. ``none`` runs the
unit; ``full`` is non-reentrant ``torch.utils.checkpoint``: the unit keeps only
its inputs and runs again in the backward; ``dots`` is the same under selective
checkpointing that keeps the outputs of the weight products (``aten.mm`` and
``aten.addmm``, the ``x @ W`` of ``layers.py``; the twin of
``dots_with_no_batch_dims_saveable``) and recomputes the rest: batched products
(``aten.bmm``: the MoE experts' products and every einsum with a batch dim) and
the kernels' autograd Functions, whose launches are no aten ops. A kernel
Function keeps its tensors through ``save_for_backward`` only, so checkpointing
frees and recomputes them; under ``full`` and ``dots`` each kernel forward in a
unit runs twice a step. The units take the ``unbind`` views as inputs (the
stacking happens outside them), so the stacked gradients still arrive once.
Remat applies only while autograd records a gradient of the unit's inputs:
prefill, decode and serving run the units as they are. The Trainer and the
Server force "none", as the JAX package's do.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import device as devices
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as LY
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.params import TensorDef, abstract_params, init_params
from repro_torch.tree import tree_leaves, tree_map

REMAT_MODES = ("none", "dots", "full")
# the weight products whose outputs ``dots`` keeps
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, mode: str):
    """``fn`` under ``cfg.remat`` (see the module docstring). The wrapped unit
    checkpoints only while autograd records and one of its tensor arguments
    requires grad; otherwise it calls ``fn``."""
    if mode == "none":
        return fn
    extra = ({"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                              _dots_policy)} if mode == "dots" else {})

    def unit(*args):
        if not (torch.is_grad_enabled() and any(
                isinstance(t, torch.Tensor) and t.requires_grad for t in tree_leaves(args))):
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **extra)
    return unit


def _period(cfg: ArchConfig) -> int:
    return cfg.local_global_pattern + 1 if cfg.local_global_pattern else 1


def _window_for(cfg: ArchConfig, j: int) -> int:
    """Static sliding window for period position j (gemma3: j<pattern => local)."""
    if cfg.local_global_pattern and j < cfg.local_global_pattern:
        return cfg.sliding_window or 0
    return 0


def _ring_slice(k: torch.Tensor, W: int) -> torch.Tensor:
    """Full-sequence K/V [B,S,...] to the ring layout [B,W,...] (slot = pos % W):
    zero-padded to W when S < W; otherwise the last W positions, which sit at
    their slots only when S is a multiple of W."""
    S = k.shape[1]
    if S < W:
        return torch.nn.functional.pad(k, (0, 0) * (k.dim() - 2) + (0, W - S))
    if S % W:
        raise ValueError(f"prefill length {S} must be below the window {W} or a "
                         f"multiple of it (the ring cache's slot of position p is p % {W})")
    return k[:, -W:]


def _pad_seq(t: torch.Tensor, n: int) -> torch.Tensor:
    """K/V [G,B,S,K,hd] zero-padded along S to n."""
    full = t.new_zeros(t.shape[:2] + (n,) + t.shape[3:])
    full[:, :, :t.shape[2]] = t
    return full


def _unstack(params_layers: dict) -> list:
    """The stacked layer params as one dict per layer, of ``unbind`` views."""
    if isinstance(params_layers, dict):
        parts = {k: _unstack(v) for k, v in params_layers.items()}
        n = len(next(iter(parts.values())))
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return list(params_layers.unbind(0))


# ----------------------------------------------------------------------- layer blocks
def _add_norm(x: torch.Tensor, d: Optional[torch.Tensor], scale: torch.Tensor,
              eps: float):
    """(x + d, rmsnorm(x + d)) in one launch; d None (the first layer): (x, rmsnorm(x))."""
    if d is None:
        return x, LY.rmsnorm(x, scale, eps)
    return ops.add_rmsnorm(x, d, scale, eps=eps)


def _ff(cfg: ArchConfig, p: dict, h: torch.Tensor, decode: bool):
    """Feed-forward: MoE where the layer has one, else SwiGLU. Returns (y, aux):
    aux is the MoE load-balance loss of a full-sequence call, else None (so the
    other families launch nothing for it)."""
    if "moe" in p:
        if decode:
            return MOE.moe_block_decode(cfg, p["moe"], h), None
        return MOE.moe_block(cfg, p["moe"], h)
    return LY.swiglu(p["mlp"], h), None


def _cross_attn(cfg: ArchConfig, p: dict, h: torch.Tensor, memory: torch.Tensor):
    """q from h [B,S,D], k/v from memory [B,M,D]; K1 not causal over Sq != Skv.
    Returns (the un-added output, k, v)."""
    q, k, v = LY.qkv_project(p, h, positions=None, theta=0.0, eps=cfg.norm_eps,
                             kv_from=memory)
    o = ops.flash_attention(q, k, v, causal=False)
    return LY.attn_out(p, o), k, v


def _cross_attn_cached(cfg: ArchConfig, p: dict, h: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """One token's cross-attention against the cross K/V [B,M,K,hd] written at
    prefill: the plain ``attend_cache`` with every one of the M positions live."""
    q = LY._project(h, p["wq"])
    full = torch.full((h.shape[0], 1, 1, 1), k.shape[1] - 1, dtype=torch.int32,
                      device=h.device)
    return LY.attn_out(p, ops.attend_cache(q, k, v, full, packed=cfg.packed_decode))


def _gated(gate: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The vlm cross layer's tanh gate, rounded to a's dtype before the product,
    as the JAX package rounds it."""
    return torch.tanh(gate.float()).to(a.dtype) * a


def _block(cfg: ArchConfig, p: dict, x: torch.Tensor, d: Optional[torch.Tensor],
           positions: torch.Tensor, window: int, want_kv: bool,
           memory: Optional[torch.Tensor] = None, causal: bool = True):
    """attn [-> xattn onto memory] -> ff on the stream x + d. Returns (x, the ff's
    un-added output, kv, the cross-attention's kv, the ff's aux or None)."""
    x, h = _add_norm(x, d, p["ln1"], cfg.norm_eps)
    return _block_normed(cfg, p, x, h, positions, window, want_kv, memory, causal)


def _block_normed(cfg: ArchConfig, p: dict, x: torch.Tensor, h: torch.Tensor,
                  positions: torch.Tensor, window: int, want_kv: bool,
                  memory: Optional[torch.Tensor], causal: bool):
    """``_block`` from the stream x and its ln1 norm h."""
    q, k, v = LY.qkv_project(p["attn"], h, positions=positions,
                             theta=cfg.rope_theta, eps=cfg.norm_eps)
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    a = LY.attn_out(p["attn"], o)
    xkv = None
    if "xattn" in p:
        x, h = ops.add_rmsnorm(x, a, p["ln3"], eps=cfg.norm_eps)
        a, xk, xv = _cross_attn(cfg, p["xattn"], h, memory)
        xkv = {"k": xk, "v": xv} if want_kv else None
    x, h = ops.add_rmsnorm(x, a, p["ln2"], eps=cfg.norm_eps)
    y, aux = _ff(cfg, p, h, decode=False)
    return x, y, ({"k": k, "v": v} if want_kv else None), xkv, aux


def _block_decode(cfg: ArchConfig, p: dict, x: torch.Tensor, d: Optional[torch.Tensor],
                  cache: dict, pos: torch.Tensor, window: int,
                  xkv: Optional[dict] = None):
    """Decode variant of ``_block``; cache is {"k","v"}: a ring of W slots when
    window > 0, else full-length; xkv the layer's cross K/V where it has one."""
    x, h = _add_norm(x, d, p["ln1"], cfg.norm_eps)
    q, k_new, v_new = LY.qkv_project(p["attn"], h, positions=pos[:, None],
                                     theta=cfg.rope_theta, eps=cfg.norm_eps)
    at = torch.remainder(pos, cache["k"].shape[1]) if window > 0 else pos   # ring slot
    k_c = LY._cache_update(cache["k"], k_new, at)
    v_c = LY._cache_update(cache["v"], v_new, at)
    if window > 0:
        o = ops.attend_cache_ring(q, k_c, v_c, pos)
    else:
        o = ops.attend_cache(q, k_c, v_c, pos[:, None, None, None],
                             packed=cfg.packed_decode)
    a = LY.attn_out(p["attn"], o)
    if "xattn" in p:
        x, h = ops.add_rmsnorm(x, a, p["ln3"], eps=cfg.norm_eps)
        a = _cross_attn_cached(cfg, p["xattn"], h, xkv["k"], xkv["v"])
    x, h = ops.add_rmsnorm(x, a, p["ln2"], eps=cfg.norm_eps)
    return x, _ff(cfg, p, h, decode=True)[0]


# ------------------------------------------------------------------- dense stacks
def _stack_kv(kvs: list) -> dict:
    """Per-layer {"k","v"} stacked along a new leading dim."""
    return {n: torch.stack([kv[n] for kv in kvs]) for n in ("k", "v")}


def _stack_fwd(cfg: ArchConfig, params: dict, x: torch.Tensor,
               positions: torch.Tensor, want_kv: bool = False,
               memory: Optional[torch.Tensor] = None):
    """dense / moe / encdec-decoder stack. Returns (x, d, kvs, xkvs, aux): the
    stream is x + d; kvs[j] = {"k","v": [G,B,S,K,hd]} per period position j,
    [G,B,W,K,hd] in ring layout where j is windowed; xkvs[j] the cross K/V
    [G,B,M,K,hd] onto ``memory`` (None where the layers have no cross-attention);
    aux the sum of the layers' MoE load-balance losses (the JAX package's scan
    carry), None where no layer has one."""
    period = _period(cfg)
    windows = [_window_for(cfg, j) for j in range(period)]

    def group(x, d, aux, ps, memory):
        """One group of ``period`` layers (the JAX package's scan body)."""
        kvs, xkvs = [], []
        for j, p in enumerate(ps):
            x, d, kv, xkv, a = _block(cfg, p, x, d, positions, windows[j], want_kv, memory)
            if a is not None:
                aux = a if aux is None else aux + a
            if want_kv and windows[j] > 0:
                kv = {n: _ring_slice(t, windows[j]) for n, t in kv.items()}
            kvs.append(kv)
            xkvs.append(xkv)
        return x, d, aux, kvs, xkvs

    group = _remat(group, cfg.remat)
    kvs = [[] for _ in range(period)]
    xkvs = [[] for _ in range(period)]
    d = aux = None
    layers = _unstack(params["layers"])
    for g in range(cfg.num_layers // period):
        x, d, aux, gkv, gxkv = group(x, d, aux, layers[g * period:(g + 1) * period], memory)
        for j in range(period):
            kvs[j].append(gkv[j])
            xkvs[j].append(gxkv[j])
    if not want_kv:
        return x, d, None, None, aux
    return (x, d, tuple(_stack_kv(kv) for kv in kvs),
            tuple(_stack_kv(xkv) if xkv[0] is not None else None for xkv in xkvs), aux)


def _stack_decode(cfg: ArchConfig, params: dict, x: torch.Tensor,
                  cache_layers: tuple, pos: torch.Tensor,
                  cross_kvs: Optional[tuple] = None):
    """cross_kvs[j]: the cross K/V {"k","v": [G,B,M,K,hd]} of period position j
    (encdec). Returns (x, d): the stream is x + d."""
    period = _period(cfg)
    windows = [_window_for(cfg, j) for j in range(period)]
    d = None
    layers = _unstack(params["layers"])
    for g in range(cfg.num_layers // period):
        for j in range(period):
            p = layers[g * period + j]
            cache = {n: cache_layers[j][n][g] for n in ("k", "v")}
            xkv = None if cross_kvs is None else {n: cross_kvs[j][n][g] for n in ("k", "v")}
            x, d = _block_decode(cfg, p, x, d, cache, pos, windows[j], xkv)
    return x, d


# --------------------------------------------------------------------- ssm stacks
def _ssm_layer(cfg: ArchConfig, lp: dict, x: torch.Tensor, d: Optional[torch.Tensor],
               state: Optional[dict] = None):
    """One mamba2 layer on the stream x + d. Returns (x, its un-added output, its
    new state {"conv", "ssd"}); with ``state`` (decode) the new state is also
    written into it in place."""
    x, h = _add_norm(x, d, lp["ln1"], cfg.norm_eps)
    y, new = SSM.ssm_block(cfg, lp["ssm"], h, state=state)
    if state is not None:
        for n in ("conv", "ssd"):
            state[n].copy_(new[n])
    return x, y, new


def _stack_states(cfg: ArchConfig, states: list, lead: Tuple[int, ...], x: torch.Tensor):
    """The per-layer states {"conv", "ssd"} of a batch like x's stacked to
    ``lead`` + their shape; no states (a hybrid tail of 0 layers): empty leaves of
    the cache's layout."""
    if not states:
        return {n: torch.empty(shape, dtype=dt, device=x.device) for n, (shape, dt)
                in SSM.ssm_state_defs(cfg, x.shape[0], *lead).items()}
    return {n: torch.stack([st[n] for st in states]).reshape(lead + states[0][n].shape)
            for n in ("conv", "ssd")}


def _ssm_fwd(cfg: ArchConfig, params: dict, x: torch.Tensor,
             want_state: bool = False):
    """Returns (x, d, states): the stream is x + d; states = {"conv": [L,B,W-1,C],
    "ssd": [L,B,H,N,P]}."""
    layer = _remat(functools.partial(_ssm_layer, cfg), cfg.remat)
    states = []
    d = None
    for lp in _unstack(params["layers"]):
        x, d, st = layer(lp, x, d)
        if want_state:
            states.append(st)
    if not want_state:
        return x, d, None
    return x, d, _stack_states(cfg, states, (cfg.num_layers,), x)


def _ssm_decode(cfg: ArchConfig, params: dict, x: torch.Tensor, states: dict):
    """One token through every layer; writes each layer's new state into
    ``states`` in place. Returns (x, d): the stream is x + d."""
    d = None
    for i, lp in enumerate(_unstack(params["layers"])):
        x, d, _ = _ssm_layer(cfg, lp, x, d, {n: states[n][i] for n in ("conv", "ssd")})
    return x, d


# ------------------------------------------------------------------ hybrid stack
def _hybrid_split(cfg: ArchConfig, params: dict):
    """(groups, tail): the per-layer params (``_unstack`` views) as the G =
    L // k groups of k = ``shared_block_every`` layers and the L - G*k after them."""
    k = cfg.shared_block_every
    G = cfg.num_layers // k
    layers = _unstack(params["layers"])
    return [layers[g * k:(g + 1) * k] for g in range(G)], layers[G * k:]


def _hybrid_fwd(cfg: ArchConfig, params: dict, x: torch.Tensor,
                positions: torch.Tensor, want_state: bool = False):
    """Returns (x, d, states): the stream is x + d; states = (main {"conv", "ssd":
    [G,k,B,...]}, shared {"k", "v": [G,B,S,K,hd]}, tail {"conv", "ssd":
    [L-G*k,B,...]}). The shared block is ``_block`` with window 0 (causal, full),
    the JAX package's ``_shared_block_fwd``, on the same params in every group."""
    groups, tail = _hybrid_split(cfg, params)

    def group_body(x, d, lps, shared):
        """k mamba2 layers, then the shared block (the JAX package's group body)."""
        sts = []
        for lp in lps:
            x, d, st = _ssm_layer(cfg, lp, x, d)
            sts.append(st)
        x, d, kv, _, _ = _block(cfg, shared, x, d, positions, 0, want_state)
        return x, d, sts, kv

    group_body = _remat(group_body, cfg.remat)
    tail_body = _remat(functools.partial(_ssm_layer, cfg), cfg.remat)
    main_states, kvs, tail_states = [], [], []
    d = None
    for group in groups:
        x, d, sts, kv = group_body(x, d, group, params["shared_block"])
        main_states.extend(sts)
        kvs.append(kv)
    for lp in tail:
        x, d, st = tail_body(lp, x, d)
        tail_states.append(st)
    if not want_state:
        return x, d, None
    return x, d, (_stack_states(cfg, main_states, (len(groups), cfg.shared_block_every), x),
                  _stack_kv(kvs),
                  _stack_states(cfg, tail_states, (len(tail),), x))


def _hybrid_decode(cfg: ArchConfig, params: dict, x: torch.Tensor, cache: dict,
                   pos: torch.Tensor):
    """One token through the groups and the tail; writes the new states of
    ``cache["main"]`` and ``cache["tail"]`` and the shared block's k/v at ``pos``
    of ``cache["shared"]`` in place (the shared block: ``_block_decode`` with
    window 0, the JAX package's ``_shared_decode``). Returns (x, d)."""
    groups, tail = _hybrid_split(cfg, params)
    shared = params["shared_block"]
    d = None
    for g, group in enumerate(groups):
        for j, lp in enumerate(group):
            x, d, _ = _ssm_layer(cfg, lp, x, d,
                                 {n: cache["main"][n][g, j] for n in ("conv", "ssd")})
        x, d = _block_decode(cfg, shared, x, d,
                             {n: cache["shared"][n][g] for n in ("k", "v")}, pos, 0)
    for i, lp in enumerate(tail):
        x, d, _ = _ssm_layer(cfg, lp, x, d, {n: cache["tail"][n][i] for n in ("conv", "ssd")})
    return x, d


# --------------------------------------------------------------------- vlm stack
def _vlm_groups(params: dict) -> list:
    """[(the group's k - 1 self layers, its cross layer)] of ``_unstack`` views,
    one a cross group."""
    return [(_unstack(s), c) for s, c in zip(_unstack(params["self_layers"]),
                                             _unstack(params["cross_layers"]))]


def _vlm_cross_layer(cfg: ArchConfig, p: dict, x: torch.Tensor, d: Optional[torch.Tensor],
                     patches: Optional[torch.Tensor] = None, want_kv: bool = False,
                     xkv: Optional[dict] = None):
    """The gated cross layer on the stream x + d: x + tanh(gate) * xattn(ln1),
    then the mlp; the cross-attention onto the patches, or onto their K/V ``xkv``
    cached at prefill (decode). Returns (x, the mlp's un-added output, the cross
    K/V where ``want_kv``)."""
    x, h = _add_norm(x, d, p["ln1"], cfg.norm_eps)
    if xkv is None:
        a, k, v = _cross_attn(cfg, p["xattn"], h, patches)
        xkv = {"k": k, "v": v} if want_kv else None
    else:
        a = _cross_attn_cached(cfg, p["xattn"], h, xkv["k"], xkv["v"])
    x, h = ops.add_rmsnorm(x, _gated(p["gate"], a), p["ln2"], eps=cfg.norm_eps)
    return x, LY.swiglu(p["mlp"], h), xkv


def _vlm_fwd(cfg: ArchConfig, params: dict, x: torch.Tensor, positions: torch.Tensor,
             patches: torch.Tensor, want_kv: bool = False):
    """Returns (x, d, kvs, xkvs): the stream is x + d; kvs = {"k","v": [nc *
    (k-1), B, S, K, hd]} of the self layers in order, xkvs = {"k","v": [nc, B, P,
    K, hd]} of the cross layers."""
    def group(x, d, selfs, cross, patches):
        """k - 1 self layers, then the gated cross layer (the JAX package's body)."""
        gkv = []
        for lp in selfs:
            x, d, kv, _, _ = _block(cfg, lp, x, d, positions, 0, want_kv)
            gkv.append(kv)
        x, d, xkv = _vlm_cross_layer(cfg, cross, x, d, patches, want_kv)
        return x, d, gkv, xkv

    group = _remat(group, cfg.remat)
    kvs, xkvs = [], []
    d = None
    for selfs, cross in _vlm_groups(params):
        x, d, gkv, xkv = group(x, d, selfs, cross, patches)
        kvs.extend(gkv)
        xkvs.append(xkv)
    if not want_kv:
        return x, d, None, None
    return x, d, _stack_kv(kvs), _stack_kv(xkvs)


def _vlm_decode(cfg: ArchConfig, params: dict, x: torch.Tensor, cache: dict,
                pos: torch.Tensor):
    """One token through the groups; writes each self layer's k/v at ``pos`` of
    ``cache["self"]`` in place and reads ``cache["cross"]``. Returns (x, d)."""
    d = None
    for g, (selfs, cross) in enumerate(_vlm_groups(params)):
        for j, lp in enumerate(selfs):
            x, d = _block_decode(cfg, lp, x, d,
                                 {n: cache["self"][n][g, j] for n in ("k", "v")}, pos, 0)
        x, d, _ = _vlm_cross_layer(cfg, cross, x, d,
                                   xkv={n: cache["cross"][n][g] for n in ("k", "v")})
    return x, d


# =============================================================================== Model
class Model:
    """A model of any of the six families bound to an ArchConfig and a device."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        if cfg.family not in ("dense", "moe", "ssm", "hybrid", "encdec", "vlm"):
            raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
        if cfg.family == "vlm" and cfg.num_layers % cfg.cross_attn_every:
            raise ValueError(
                f"{cfg.name}: num_layers {cfg.num_layers} must be a multiple of "
                f"cross_attn_every {cfg.cross_attn_every} (the stack runs whole groups of "
                f"{cfg.cross_attn_every - 1} self layers and a cross layer, as the JAX "
                f"package's param_defs asserts)")
        period = _period(cfg)
        if cfg.family in ("dense", "moe", "encdec") and cfg.num_layers % period:
            raise ValueError(
                f"{cfg.name}: num_layers {cfg.num_layers} must be a multiple of the "
                f"local:global period {period} (the {cfg.family} stack runs whole groups "
                f"of {period} layers, as the JAX package's _grouped asserts)")
        if cfg.remat not in REMAT_MODES:
            raise ValueError(f"{cfg.name}: remat {cfg.remat!r} is not one of {REMAT_MODES}")
        self.cfg = cfg
        self.device = devices.resolve(device)

    def init_params(self, seed: int = 0) -> dict:
        return init_params(self.cfg, seed, self.device)

    def abstract_params(self) -> dict:
        return abstract_params(self.cfg)

    # --------------------------------------------------------------------- embedding
    def _embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens.long()]

    def _final_norm(self, params: dict, x: torch.Tensor,
                    d: Optional[torch.Tensor]) -> torch.Tensor:
        """rmsnorm of the stream x + d (the final norm takes in the last add)."""
        return _add_norm(x, d, params["final_norm"], self.cfg.norm_eps)[1]

    def _table(self, params: dict) -> torch.Tensor:
        return params["embed"].T if self.cfg.tie_embeddings else params["unembed"]

    def _unembed(self, params: dict, x: torch.Tensor,
                 d: Optional[torch.Tensor]) -> torch.Tensor:
        """Logits of the stream x + d."""
        return self._final_norm(params, x, d) @ self._table(params)

    def _positions(self, B: int, S: int) -> torch.Tensor:
        return torch.arange(S, dtype=torch.int32, device=self.device)[None].expand(B, S)

    def _encode(self, params: dict, frames: torch.Tensor) -> torch.Tensor:
        """The encoder over the frame embeddings [B, M, D]: RoPE positions 0..M-1,
        not causal, then ``enc_norm`` (which takes in the last add). Returns the
        memory [B, M, D] the decoder's cross-attention reads.

        Frames in another dtype than the params (the Trainer's bf16 frames under
        f32 params) are promoted to theirs, exactly, and the first norm rounded
        to the frames' dtype: the JAX package's rmsnorm returns its input's
        dtype, and its q/k/v products and first residual add promote. Where the
        dtypes agree both casts are no-ops."""
        cfg = self.cfg
        positions = self._positions(frames.shape[0], frames.shape[1])

        def first_layer(lp, x):
            h = LY.rmsnorm(x, lp["ln1"], cfg.norm_eps).to(frames.dtype).to(x.dtype)
            return _block_normed(cfg, lp, x, h, positions, 0, False, None, False)[:2]

        def layer(lp, x, d):
            return _block(cfg, lp, x, d, positions, 0, False, causal=False)[:2]

        first, *rest = _unstack(params["enc_layers"])
        x, d = _remat(first_layer, cfg.remat)(first, frames.to(params["enc_norm"].dtype))
        layer = _remat(layer, cfg.remat)
        for lp in rest:
            x, d = layer(lp, x, d)
        return _add_norm(x, d, params["enc_norm"], cfg.norm_eps)[1]

    # ----------------------------------------------------------------------- forward
    def forward(self, params: dict, batch: Dict[str, torch.Tensor],
                return_hidden: bool = False):
        """Full-sequence forward. Returns (logits [B,S,V], aux_loss), or the
        final-normed hidden state [B,S,D] when ``return_hidden`` (chunked CE)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._embed(params, tokens)
        aux = None
        family = self.cfg.family
        if family == "ssm":
            x, d, _ = _ssm_fwd(self.cfg, params, x)
        elif family == "hybrid":
            x, d, _ = _hybrid_fwd(self.cfg, params, x, self._positions(B, S))
        elif family == "vlm":
            x, d, _, _ = _vlm_fwd(self.cfg, params, x, self._positions(B, S),
                                  batch["patches"])
        else:
            memory = self._encode(params, batch["frames"]) if family == "encdec" else None
            x, d, _, _, aux = _stack_fwd(self.cfg, params, x, self._positions(B, S),
                                         memory=memory)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=self.device)
        if return_hidden:
            return self._final_norm(params, x, d), aux
        return self._unembed(params, x, d), aux

    # ------------------------------------------------------------------------- loss
    def loss_fn(self, params: dict, batch: Dict[str, torch.Tensor]):
        """Masked CE (+ 0.01 aux). Returns (loss, metrics {loss, aux_loss, tokens}).

        CE takes log p of the target by a gather, never a one-hot. With
        ``cfg.loss_chunk`` the [B,S,V] logits are never materialised: see
        ``_chunked_ce``. Twin of the JAX package's ``Model.loss_fn``."""
        mask = batch["loss_mask"].float()
        denom = mask.sum().clamp_min(1.0)
        if self.cfg.loss_chunk:
            hidden, aux = self.forward(params, batch, return_hidden=True)
            ce = self._chunked_ce(params, hidden, batch["targets"], mask) / denom
        else:
            logits, aux = self.forward(params, batch)
            logp = torch.log_softmax(logits.float(), dim=-1)
            ll = logp.gather(-1, batch["targets"].long()[..., None])[..., 0]   # [B, S]
            ce = -(ll * mask).sum() / denom
        loss = ce + 0.01 * aux
        metrics = {"loss": ce.detach(), "aux_loss": aux.detach(), "tokens": mask.sum()}
        return loss, metrics

    def _chunked_ce(self, params: dict, hidden: torch.Tensor, targets: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
        """Sum of masked -log p over [B,S] in sequence chunks of cfg.loss_chunk;
        each chunk's logits are recomputed in the backward
        (``torch.utils.checkpoint``, the JAX package's per-chunk
        ``jax.checkpoint``)."""
        table = self._table(params)
        S = hidden.shape[1]
        c = min(self.cfg.loss_chunk, S)
        if S % c:
            raise ValueError(f"loss_chunk {c} must divide seq {S}")

        def body(xc, tc, mc):
            logits = (xc @ table).float()
            ll = logits.gather(-1, tc.long()[..., None])[..., 0] \
                - torch.logsumexp(logits, dim=-1)
            return -(ll * mc).sum()

        total = None
        for i in range(0, S, c):
            part = checkpoint(body, hidden[:, i:i + c], targets[:, i:i + c],
                              mask[:, i:i + c], use_reentrant=False)
            total = part if total is None else total + part
        return total

    # ----------------------------------------------------------------------- prefill
    def prefill(self, params: dict, batch: Dict[str, torch.Tensor],
                max_len: Optional[int] = None):
        """Build the decode cache from a full prompt; returns (last_logits, cache).
        A windowed layer's cache is its ring of W slots; a full layer's (and the
        hybrid's shared block's, and the encdec and vlm self layers') is padded to
        ``max_len``; the cross K/V (encdec, vlm) keep the memory's length."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        max_len = max_len or S
        if max_len < S:
            raise ValueError(f"prompt of {S} tokens exceeds max_len {max_len}")
        x = self._embed(params, tokens)
        pos = torch.full((B,), S, dtype=torch.int32, device=self.device)
        family = self.cfg.family
        if family == "vlm":
            x, d, kv, xkv = _vlm_fwd(self.cfg, params, x, self._positions(B, S),
                                     batch["patches"], want_kv=True)
            groups = (xkv["k"].shape[0], self.cfg.cross_attn_every - 1)
            cache = {"pos": pos, "cross": xkv, "self": {
                n: _pad_seq(t, max_len).unflatten(0, groups) for n, t in kv.items()}}
        elif family == "encdec":
            memory = self._encode(params, batch["frames"])
            x, d, (kv,), (xkv,), _ = _stack_fwd(self.cfg, params, x, self._positions(B, S),
                                               want_kv=True, memory=memory)
            cache = {"pos": pos, "self": {n: _pad_seq(t, max_len) for n, t in kv.items()},
                     "cross": xkv}
        elif family == "ssm":
            x, d, layers = _ssm_fwd(self.cfg, params, x, want_state=True)
            cache = {"pos": pos, "layers": layers}
        elif self.cfg.family == "hybrid":
            x, d, (main, kv, tail) = _hybrid_fwd(self.cfg, params, x,
                                                 self._positions(B, S), want_state=True)
            cache = {"pos": pos, "main": main,
                     "shared": {n: _pad_seq(t, max_len) for n, t in kv.items()},
                     "tail": tail}
        else:
            x, d, kvs, _, _ = _stack_fwd(self.cfg, params, x, self._positions(B, S),
                                         want_kv=True)
            # a windowed layer's kv is in ring layout already
            cache = {"pos": pos, "layers": tuple(
                kv if _window_for(self.cfg, j) else
                {n: _pad_seq(t, max_len) for n, t in kv.items()}
                for j, kv in enumerate(kvs))}
        last_logits = self._unembed(params, x[:, -1:],
                                    None if d is None else d[:, -1:])[:, 0]
        return last_logits, cache

    # ------------------------------------------------------------------- decode step
    def decode_step(self, params: dict, tokens: torch.Tensor, cache: dict):
        """tokens [B, 1] -> (logits [B, V], new_cache). Writes the cache in place."""
        pos = cache["pos"]
        x = self._embed(params, tokens)
        if self.cfg.family == "ssm":
            x, d = _ssm_decode(self.cfg, params, x, cache["layers"])
        elif self.cfg.family == "hybrid":
            x, d = _hybrid_decode(self.cfg, params, x, cache, pos)
        elif self.cfg.family == "encdec":
            x, d = _stack_decode(self.cfg, params, x, (cache["self"],), pos,
                                 cross_kvs=(cache["cross"],))
        elif self.cfg.family == "vlm":
            x, d = _vlm_decode(self.cfg, params, x, cache, pos)
        else:
            x, d = _stack_decode(self.cfg, params, x, cache["layers"], pos)
        logits = self._unembed(params, x, d)[:, 0]
        return logits, dict(cache, pos=pos + 1)

    # ------------------------------------------------------------------- cache views
    def cache_defs(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        pos = TensorDef((batch,), torch.int32)
        dt = getattr(torch, cfg.dtype)
        K, hd = cfg.num_kv_heads, cfg.head_dim

        def kv(G, S):
            return {"k": TensorDef((G, batch, S, K, hd), dt),
                    "v": TensorDef((G, batch, S, K, hd), dt)}

        def ssm_state(*lead):
            return {n: TensorDef(*d)
                    for n, d in SSM.ssm_state_defs(cfg, batch, *lead).items()}

        if cfg.family == "ssm":
            return {"pos": pos, "layers": ssm_state(cfg.num_layers)}
        if cfg.family == "hybrid":
            k = cfg.shared_block_every
            G = cfg.num_layers // k
            return {"pos": pos, "main": ssm_state(G, k), "shared": kv(G, max_len),
                    "tail": ssm_state(cfg.num_layers - G * k)}
        if cfg.family == "encdec":
            return {"pos": pos, "self": kv(cfg.num_layers, max_len),
                    "cross": kv(cfg.num_layers, cfg.encoder_frames)}
        if cfg.family == "vlm":
            nc = cfg.num_layers // cfg.cross_attn_every
            grp = cfg.cross_attn_every - 1
            return {"pos": pos,
                    "self": {n: TensorDef((nc, grp, batch, max_len, K, hd), dt)
                             for n in ("k", "v")},
                    "cross": kv(nc, cfg.num_patches)}
        period = _period(cfg)
        G = cfg.num_layers // period
        return {"pos": pos,
                "layers": tuple(kv(G, _window_for(cfg, j) or max_len)
                                for j in range(period))}

    def abstract_cache(self, batch: int, max_len: int) -> dict:
        """The cache's ``TensorDef`` tree (the JAX package's ShapeDtypeStructs)."""
        return self.cache_defs(batch, max_len)

    def init_cache(self, batch: int, max_len: int) -> dict:
        return tree_map(lambda d: torch.zeros(d.shape, dtype=d.dtype, device=self.device),
                        self.cache_defs(batch, max_len))
