"""Model facade of the PyTorch port, twin of ``repro.models.model``.

All six families are ported: dense (``[attn -> mlp] x L`` with the local:global
period of ``_period``/``_window_for``; gemma3's windowed layers keep a ring-buffer
cache of W slots, slot = position mod W), moe (``[attn -> moe] x L``, the dense
stack with ``_ff``'s MoE branch; each layer's routing statistics summed over the
batch's tokens, and over the batch axes on a mesh, before its load-balance loss
is formed, the layers' losses summed into ``forward``'s aux), ssm (``[mamba2
SSD] x L``), hybrid (zamba2: ``[[mamba2 SSD] x k -> shared attn+mlp block] x
G``, then the ``L - G*k`` tail layers; the one shared block's params serve every
group),
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

A ``Model`` carries a ``MeshPlan`` (``parallel/sharding.py``) as the JAX
package's does: ``param_specs`` and ``cache_specs`` lay the params and the cache
out by its rules (the cache's logical axes are the JAX package's, declared in
``cache_defs``). On a one-device plan every layout is the identity and the code
above runs as it is.

Tensor and data parallelism (every family on a plan over a ``DeviceMesh``:
``ranked``): the params are DTensors laid out by
``param_specs``. Every entry point works on this rank's shards in the compute
layout (``shard_params``: the "model" splits of heads, kv heads, ffn, vocab, ssm
heads and experts, ``parallel.sharding.compute_spec``; any other split gathered)
and on its rows of the batch (``_rows``: a DTensor leaf's rows by its placements, a
plain leaf holds the whole batch and each rank takes its rows by the "batch"
rule; whisper's frames and llama-vision's patches ride the tokens' rows), and
the layers run the collectives of ``parallel/sharding.py`` at the JAX package's
``constrain`` sites, with ``self.tp`` (``TensorParallel``). ``_embed`` is a
vocab-parallel lookup (a masked local gather, summed over "model"); ``_unembed``
gives vocab-split logits,
which ``forward`` returns as a DTensor on ``plan.spec(("batch", "seq",
"vocab"))``'s placements; ``loss_fn``'s cross-entropy is vocab-parallel (max and
sum of exp reduced over "model", the target's logit from the rank that holds it;
``_chunked_ce`` alike), its mask's denominator and its CE summed over the batch
axes, so every rank reports the global loss. Plain params on such a plan are
taken to be this rank's compute shards (the train step's gradient leaves).
``prefill`` writes its k/v into the cache laid out by ``cache_specs``, whose
"cache_seq" rule splits the sequence over "model" where it divides it:
``decode_step`` then gathers q's heads (and the new k/v's), each rank attends its
own cache positions for all heads (``ops.attend_cache_part``), the partial
softmaxes are combined across "model" by log-sum-exp (``_lse_combine``; a rank
with no live position adds zero weight), and each rank keeps its heads for the
row-parallel ``wo``; gemma3's ring takes the same combine over its slots. A
cross-attention (encdec, vlm) takes q from the rank's heads and k/v from the
memory (the encoder's output, the patches) on the kv heads the rank holds; the
memory enters the split region once, before the decoder stack (``copy_to``, so
the encoder's gradient is summed over "model"); vlm's tanh gate multiplies the
row-parallel output after its reduction. Its cross K/V cache, written once at
prefill, is split as ``cache_specs`` says: along the memory (whisper's 1,500
frames over 2 or 4 ranks), where each rank attends its slice with every
position live and ``_lse_combine`` joins them; by kv heads (llama-vision's
1,601 patches, a prime), where attention is local; or not at all. A
mamba2 layer (ssm, and the hybrid's; ``models/ssm.py``) splits d_inner and its
heads over "model" where the axis divides both, and the hybrid's shared block is
the dense layers' code. Its decode state is computed in its own layout (the
rank's heads of the SSD state; a conv tail of the rank's xs channels and all of
B and C) and handed out in the JAX package's ``cache_specs`` layout, whose
"ffn" rule splits the conv tail's channels [xs | B | C] into contiguous slices:
prefill lays the tails out (``_conv_laid_out``: the xs channels gathered over
"model", the rank's slice cut), and a decode step takes them back into its
layout (``_conv_computed``) and lays the new tails out again, two all-gathers of
the tails a step. A moe layer holds its 1/M of the experts where "model"
divides them (``models/moe.py``: every rank routes each token alike from the
gathered router, dispatches its rows to its own experts and combines by an
all-reduce of the partial sums, or under ``plan.moe_combine_reshard`` by
gathering the slot buffer first); its shared experts are the split SwiGLU; the
load-balance loss sums each layer's assignment counts and probability sums over
the batch axes (``sum_over``: its backward the identity, so each rank takes its
rows' share of the gradient) before it forms their product, so every rank
reports the global aux, as the JAX package computes it over the global batch. On
a one-rank mesh every axis has size 1: no collective runs and the code is the
one-card code op for op.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import device as devices
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as LY
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.params import (TensorDef, abstract_params, init_params, param_defs,
                                       partition_specs)
from repro_torch.parallel.sharding import (MeshPlan, OneDeviceMesh, PartitionSpec,
                                           TensorParallel, as_dtensor, compute_spec, copy_to,
                                           gather_along, local_range, max_over, placements,
                                           reduce_from, relayout, sum_over)
from repro_torch.tree import tree_leaves, tree_map

REMAT_MODES = ("none", "dots", "full")
# the weight products whose outputs ``dots`` keeps
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _split(spec, dim: int) -> bool:
    """Whether ``spec`` splits tensor dim ``dim`` over "model" (a compute spec)."""
    return dim < len(spec) and spec[dim] == "model"


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


def _ff(cfg: ArchConfig, p: dict, h: torch.Tensor, decode: bool,
        tp: Optional[TensorParallel] = None):
    """Feed-forward: MoE where the layer has one, else SwiGLU. Returns (y, stats):
    stats is the MoE layer's ``routing_stats`` [2, E] of a full-sequence call,
    else None (so the other families launch nothing for it)."""
    if "moe" in p:
        if decode:
            return MOE.moe_block_decode(cfg, p["moe"], h, tp), None
        return MOE.moe_block_stats(cfg, p["moe"], h, tp)
    return LY.swiglu(p["mlp"], h, tp), None


def _cross_attn(cfg: ArchConfig, p: dict, h: torch.Tensor, memory: torch.Tensor,
                tp: Optional[TensorParallel] = None):
    """q from h [B,S,D], k/v from memory [B,M,D]; K1 not causal over Sq != Skv.
    Returns (the un-added output, k, v). Under ``tp`` q holds the rank's heads and
    k/v the kv heads the rank holds; ``memory`` has entered the split region
    (``copy_to``) before the stack."""
    q, k, v = LY.qkv_project(p, h, positions=None, theta=0.0, eps=cfg.norm_eps,
                             kv_from=memory, tp=tp)
    o = ops.flash_attention(q, LY.local_kv(q, k, tp), LY.local_kv(q, v, tp), causal=False)
    return LY.attn_out(p, o, tp), k, v


def _cross_attn_cached(cfg: ArchConfig, p: dict, h: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, tp: Optional[TensorParallel] = None,
                       seq: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One token's cross-attention against the cross K/V [B,M,K,hd] written at
    prefill: the plain ``attend_cache`` with every one of the M positions live.
    Under ``tp`` the cache holds the kv heads the rank computes (``seq`` None:
    local, K1's local kv heads read) or every kv head of a slice of the memory
    (``seq``: each rank attends its slice with every position live,
    ``_attend_split``)."""
    q = LY._project(h, p["wq"])
    if seq is not None:
        live = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
        return LY.attn_out(p, _attend_split(q, k, v, live, tp), tp)
    full = torch.full((h.shape[0], 1, 1, 1), k.shape[1] - 1, dtype=torch.int32,
                      device=h.device)
    o = ops.attend_cache(q, LY.local_kv(q, k, tp), LY.local_kv(q, v, tp), full,
                         packed=cfg.packed_decode)
    return LY.attn_out(p, o, tp)


def _gated(gate: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The vlm cross layer's tanh gate, rounded to a's dtype before the product,
    as the JAX package rounds it. Under tensor parallelism ``a`` is the reduced
    output of the row-parallel ``wo``, so the gate's gradient is whole on every
    rank."""
    return torch.tanh(gate.float()).to(a.dtype) * a


def _into_split(memory: Optional[torch.Tensor],
                tp: Optional[TensorParallel]) -> Optional[torch.Tensor]:
    """The memory a stack's cross-attentions read, entered into the split region
    once (``copy_to``) where ``tp`` splits their heads: each layer's k/v of the
    rank's kv heads give partial gradients of it, summed over "model" in one
    all-reduce."""
    if memory is None or tp is None or not tp.heads:
        return memory
    return copy_to(memory, tp.plan)


def _block(cfg: ArchConfig, p: dict, x: torch.Tensor, d: Optional[torch.Tensor],
           positions: torch.Tensor, window: int, want_kv: bool,
           memory: Optional[torch.Tensor] = None, causal: bool = True,
           tp: Optional[TensorParallel] = None):
    """attn [-> xattn onto memory] -> ff on the stream x + d. Returns (x, the ff's
    un-added output, kv, the cross-attention's kv, the ff's routing stats or
    None)."""
    x, h = _add_norm(x, d, p["ln1"], cfg.norm_eps)
    return _block_normed(cfg, p, x, h, positions, window, want_kv, memory, causal, tp)


def _block_normed(cfg: ArchConfig, p: dict, x: torch.Tensor, h: torch.Tensor,
                  positions: torch.Tensor, window: int, want_kv: bool,
                  memory: Optional[torch.Tensor], causal: bool,
                  tp: Optional[TensorParallel] = None):
    """``_block`` from the stream x and its ln1 norm h. Under ``tp`` the kv
    returned are the kv heads the rank holds (``layers.qkv_project``), K1 reads
    those of its local q heads."""
    q, k, v = LY.qkv_project(p["attn"], h, positions=positions,
                             theta=cfg.rope_theta, eps=cfg.norm_eps, tp=tp)
    o = ops.flash_attention(q, LY.local_kv(q, k, tp), LY.local_kv(q, v, tp),
                            causal=causal, window=window)
    a = LY.attn_out(p["attn"], o, tp)
    xkv = None
    if "xattn" in p:
        x, h = ops.add_rmsnorm(x, a, p["ln3"], eps=cfg.norm_eps)
        a, xk, xv = _cross_attn(cfg, p["xattn"], h, memory, tp)
        xkv = {"k": xk, "v": xv} if want_kv else None
    x, h = ops.add_rmsnorm(x, a, p["ln2"], eps=cfg.norm_eps)
    y, stats = _ff(cfg, p, h, decode=False, tp=tp)
    return x, y, ({"k": k, "v": v} if want_kv else None), xkv, stats


def _block_decode(cfg: ArchConfig, p: dict, x: torch.Tensor, d: Optional[torch.Tensor],
                  cache: dict, pos: torch.Tensor, window: int,
                  xkv: Optional[dict] = None, tp: Optional[TensorParallel] = None,
                  seq: Optional[Tuple[int, int]] = None,
                  xseq: Optional[Tuple[int, int]] = None):
    """Decode variant of ``_block``; cache is {"k","v"}: a ring of W slots when
    window > 0, else full-length; xkv the layer's cross K/V where it has one.
    Under ``tp`` the cache holds, at every position, the kv heads the rank
    computes (``seq`` None: the write and the attention are local, K1's local
    kv heads read), or every kv head of a slice of the positions (``seq``, the
    slice's first position and the whole length: ``_attend_slices``); ``xseq``
    is the cross K/V's (``_cross_attn_cached``)."""
    x, h = _add_norm(x, d, p["ln1"], cfg.norm_eps)
    q, k_new, v_new = LY.qkv_project(p["attn"], h, positions=pos[:, None],
                                     theta=cfg.rope_theta, eps=cfg.norm_eps, tp=tp)
    if seq is not None:
        o = _attend_slices(q, k_new, v_new, cache, pos, window, tp, seq)
    else:
        at = torch.remainder(pos, cache["k"].shape[1]) if window > 0 else pos   # ring slot
        k_c = LY.local_kv(q, LY._cache_update(cache["k"], k_new, at), tp)
        v_c = LY.local_kv(q, LY._cache_update(cache["v"], v_new, at), tp)
        if window > 0:
            o = ops.attend_cache_ring(q, k_c, v_c, pos)
        else:
            o = ops.attend_cache(q, k_c, v_c, pos[:, None, None, None],
                                 packed=cfg.packed_decode)
    a = LY.attn_out(p["attn"], o, tp)
    if "xattn" in p:
        x, h = ops.add_rmsnorm(x, a, p["ln3"], eps=cfg.norm_eps)
        a = _cross_attn_cached(cfg, p["xattn"], h, xkv["k"], xkv["v"], tp, xseq)
    x, h = ops.add_rmsnorm(x, a, p["ln2"], eps=cfg.norm_eps)
    return x, _ff(cfg, p, h, decode=True, tp=tp)[0]


def _lse_combine(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor, plan: MeshPlan,
                 dtype: torch.dtype) -> torch.Tensor:
    """The softmax attention of the whole cache from each "model" rank's share of
    it (``ops.attend_cache_part``: row max m, sum l, weighted v o, f32): each
    share scaled by exp(m - the max over the ranks), summed, normalised. A rank
    whose slice holds no live position has l = 0 and adds zero weight.
    Returns [B, 1, H, D] in ``dtype``."""
    top = max_over(m, plan)
    w = torch.where(l > 0, torch.exp(m - top), torch.zeros_like(m))
    parts = reduce_from(torch.cat([o * w[..., None], (l * w)[..., None]], dim=-1), plan)
    return (parts[..., :-1] / parts[..., -1:])[:, None].to(dtype)


def _attend_slices(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor, cache: dict,
                   pos: torch.Tensor, window: int, tp: TensorParallel,
                   seq: Tuple[int, int]) -> torch.Tensor:
    """One token's attention over a cache split along the sequence over "model",
    this rank holding every kv head of positions (ring slots) [lo, lo + Sl): q's
    heads and the new k/v's are gathered, the rank that owns the position writes
    it, each rank attends its slice for all heads and ``_lse_combine`` joins them.
    Returns the output of this rank's q heads."""
    plan = tp.plan
    lo, length = seq
    Sl = cache["k"].shape[1]
    if tp.kv_heads:
        k_new, v_new = gather_along(k_new, 2, plan), gather_along(v_new, 2, plan)
    at = torch.remainder(pos, length) if window > 0 else pos
    LY._cache_write_slice(cache["k"], k_new, at - lo)
    LY._cache_write_slice(cache["v"], v_new, at - lo)
    slots = lo + torch.arange(Sl, device=pos.device)[None, :]
    if window > 0:       # slot s holds position pos - ((pos - s) mod W)
        live = pos[:, None] - torch.remainder(pos[:, None] - slots, length) >= 0
    else:
        live = slots <= pos[:, None]
    return _attend_split(q, cache["k"], cache["v"], live, tp)


def _attend_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, live: torch.Tensor,
                  tp: TensorParallel) -> torch.Tensor:
    """One token's attention over k/v [B, Sl, K, hd], this rank's slice of a cache
    split along the sequence over "model" (``live`` [B, Sl] its positions that
    hold a token): q's heads gathered, the slice attended for all heads
    (``ops.attend_cache_part``), the slices joined by ``_lse_combine``. Returns
    the output of this rank's q heads."""
    qf = gather_along(q, 2, tp.plan) if tp.heads else q
    o = _lse_combine(*ops.attend_cache_part(qf, k, v, live), tp.plan, q.dtype)
    return o.narrow(2, tp.rank * q.shape[2], q.shape[2]) if tp.heads else o


# ------------------------------------------------------------------- dense stacks
def _stack_kv(kvs: list) -> dict:
    """Per-layer {"k","v"} stacked along a new leading dim."""
    return {n: torch.stack([kv[n] for kv in kvs]) for n in ("k", "v")}


def _stack_fwd(cfg: ArchConfig, params: dict, x: torch.Tensor,
               positions: torch.Tensor, want_kv: bool = False,
               memory: Optional[torch.Tensor] = None, tp: Optional[TensorParallel] = None):
    """dense / moe / encdec-decoder stack. Returns (x, d, kvs, xkvs, stats): the
    stream is x + d; kvs[j] = {"k","v": [G,B,S,K,hd]} per period position j,
    [G,B,W,K,hd] in ring layout where j is windowed; xkvs[j] the cross K/V
    [G,B,M,K,hd] onto ``memory`` (None where the layers have no cross-attention);
    stats the MoE layers' ``routing_stats`` stacked [L, 2, E], None where no layer
    has one."""
    period = _period(cfg)
    windows = [_window_for(cfg, j) for j in range(period)]
    memory = _into_split(memory, tp)

    def group(x, d, ps, memory):
        """One group of ``period`` layers (the JAX package's scan body)."""
        kvs, xkvs, stats = [], [], []
        for j, p in enumerate(ps):
            x, d, kv, xkv, st = _block(cfg, p, x, d, positions, windows[j], want_kv, memory,
                                       tp=tp)
            if st is not None:
                stats.append(st)
            if want_kv and windows[j] > 0:
                kv = {n: _ring_slice(t, windows[j]) for n, t in kv.items()}
            kvs.append(kv)
            xkvs.append(xkv)
        return x, d, stats, kvs, xkvs

    group = _remat(group, cfg.remat)
    kvs = [[] for _ in range(period)]
    xkvs = [[] for _ in range(period)]
    d, stats = None, []
    layers = _unstack(params["layers"])
    for g in range(cfg.num_layers // period):
        x, d, gst, gkv, gxkv = group(x, d, layers[g * period:(g + 1) * period], memory)
        stats.extend(gst)
        for j in range(period):
            kvs[j].append(gkv[j])
            xkvs[j].append(gxkv[j])
    stats = torch.stack(stats) if stats else None
    if not want_kv:
        return x, d, None, None, stats
    return (x, d, tuple(_stack_kv(kv) for kv in kvs),
            tuple(_stack_kv(xkv) if xkv[0] is not None else None for xkv in xkvs), stats)


def _stack_decode(cfg: ArchConfig, params: dict, x: torch.Tensor,
                  cache_layers: tuple, pos: torch.Tensor,
                  cross_kvs: Optional[tuple] = None, tp: Optional[TensorParallel] = None,
                  seq: Optional[tuple] = None, xseq: Optional[tuple] = None):
    """cross_kvs[j]: the cross K/V {"k","v": [G,B,M,K,hd]} of period position j
    (encdec); seq[j], xseq[j]: ``_block_decode``'s ``seq`` and ``xseq`` of period
    position j's caches. Returns (x, d): the stream is x + d."""
    period = _period(cfg)
    windows = [_window_for(cfg, j) for j in range(period)]
    d = None
    layers = _unstack(params["layers"])
    for g in range(cfg.num_layers // period):
        for j in range(period):
            p = layers[g * period + j]
            cache = {n: cache_layers[j][n][g] for n in ("k", "v")}
            xkv = None if cross_kvs is None else {n: cross_kvs[j][n][g] for n in ("k", "v")}
            x, d = _block_decode(cfg, p, x, d, cache, pos, windows[j], xkv, tp,
                                 None if seq is None else seq[j],
                                 None if xseq is None else xseq[j])
    return x, d


# --------------------------------------------------------------------- ssm stacks
def _ssm_layer(cfg: ArchConfig, lp: dict, x: torch.Tensor, d: Optional[torch.Tensor],
               state: Optional[dict] = None, tp: Optional[TensorParallel] = None):
    """One mamba2 layer on the stream x + d. Returns (x, its un-added output, its
    new state {"conv", "ssd"}); with ``state`` (decode) the new state is also
    written into it in place. Under ``tp`` the state is in the compute layout
    (``ssm.ssm_block``)."""
    x, h = _add_norm(x, d, lp["ln1"], cfg.norm_eps)
    y, new = SSM.ssm_block(cfg, lp["ssm"], h, state=state, tp=tp)
    if state is not None:
        for n in ("conv", "ssd"):
            state[n].copy_(new[n])
    return x, y, new


def _stack_states(cfg: ArchConfig, states: list, lead: Tuple[int, ...], x: torch.Tensor,
                  tp: Optional[TensorParallel] = None):
    """The per-layer states {"conv", "ssd"} of a batch like x's stacked to
    ``lead`` + their shape; no states (a hybrid tail of 0 layers): empty leaves of
    the cache's layout (its compute layout under ``tp``)."""
    if not states:
        defs = SSM.ssm_state_defs(cfg, x.shape[0], *lead)
        if tp is not None and tp.ssm:
            conv, ssd = list(defs["conv"][0]), list(defs["ssd"][0])
            conv[-1] -= cfg.d_inner - cfg.d_inner // tp.size
            ssd[-3] //= tp.size
            defs = {"conv": (tuple(conv), defs["conv"][1]), "ssd": (tuple(ssd), defs["ssd"][1])}
        return {n: torch.empty(shape, dtype=dt, device=x.device)
                for n, (shape, dt) in defs.items()}
    return {n: torch.stack([st[n] for st in states]).reshape(lead + states[0][n].shape)
            for n in ("conv", "ssd")}


def _ssm_fwd(cfg: ArchConfig, params: dict, x: torch.Tensor,
             want_state: bool = False, tp: Optional[TensorParallel] = None):
    """Returns (x, d, states): the stream is x + d; states = {"conv": [L,B,W-1,C],
    "ssd": [L,B,H,N,P]} (the compute layout under ``tp``)."""
    layer = _remat(functools.partial(_ssm_layer, cfg, tp=tp), cfg.remat)
    states = []
    d = None
    for lp in _unstack(params["layers"]):
        x, d, st = layer(lp, x, d)
        if want_state:
            states.append(st)
    if not want_state:
        return x, d, None
    return x, d, _stack_states(cfg, states, (cfg.num_layers,), x, tp)


def _ssm_decode(cfg: ArchConfig, params: dict, x: torch.Tensor, states: dict,
                tp: Optional[TensorParallel] = None):
    """One token through every layer; writes each layer's new state into
    ``states`` in place. Returns (x, d): the stream is x + d."""
    d = None
    for i, lp in enumerate(_unstack(params["layers"])):
        x, d, _ = _ssm_layer(cfg, lp, x, d, {n: states[n][i] for n in ("conv", "ssd")}, tp)
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
                positions: torch.Tensor, want_state: bool = False,
                tp: Optional[TensorParallel] = None):
    """Returns (x, d, states): the stream is x + d; states = (main {"conv", "ssd":
    [G,k,B,...]}, shared {"k", "v": [G,B,S,K,hd]}, tail {"conv", "ssd":
    [L-G*k,B,...]}). The shared block is ``_block`` with window 0 (causal, full),
    the JAX package's ``_shared_block_fwd``, on the same params in every group.
    Under ``tp`` the states are in the compute layout and the kv are the kv heads
    the rank holds (``_block``)."""
    groups, tail = _hybrid_split(cfg, params)

    def group_body(x, d, lps, shared):
        """k mamba2 layers, then the shared block (the JAX package's group body)."""
        sts = []
        for lp in lps:
            x, d, st = _ssm_layer(cfg, lp, x, d, tp=tp)
            sts.append(st)
        x, d, kv, _, _ = _block(cfg, shared, x, d, positions, 0, want_state, tp=tp)
        return x, d, sts, kv

    group_body = _remat(group_body, cfg.remat)
    tail_body = _remat(functools.partial(_ssm_layer, cfg, tp=tp), cfg.remat)
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
    return x, d, (_stack_states(cfg, main_states, (len(groups), cfg.shared_block_every), x,
                                tp),
                  _stack_kv(kvs),
                  _stack_states(cfg, tail_states, (len(tail),), x, tp))


def _hybrid_decode(cfg: ArchConfig, params: dict, x: torch.Tensor, cache: dict,
                   pos: torch.Tensor, tp: Optional[TensorParallel] = None,
                   seq: Optional[Tuple[int, int]] = None):
    """One token through the groups and the tail; writes the new states of
    ``cache["main"]`` and ``cache["tail"]`` and the shared block's k/v at ``pos``
    of ``cache["shared"]`` in place (the shared block: ``_block_decode`` with
    window 0, the JAX package's ``_shared_decode``; under ``tp`` with ``seq``, its
    cache's slice of the sequence, as a dense layer's). Returns (x, d)."""
    groups, tail = _hybrid_split(cfg, params)
    shared = params["shared_block"]
    d = None
    for g, group in enumerate(groups):
        for j, lp in enumerate(group):
            x, d, _ = _ssm_layer(cfg, lp, x, d,
                                 {n: cache["main"][n][g, j] for n in ("conv", "ssd")}, tp)
        x, d = _block_decode(cfg, shared, x, d,
                             {n: cache["shared"][n][g] for n in ("k", "v")}, pos, 0, tp=tp,
                             seq=seq)
    for i, lp in enumerate(tail):
        x, d, _ = _ssm_layer(cfg, lp, x, d, {n: cache["tail"][n][i] for n in ("conv", "ssd")},
                             tp)
    return x, d


# --------------------------------------------------------------------- vlm stack
def _vlm_groups(params: dict) -> list:
    """[(the group's k - 1 self layers, its cross layer)] of ``_unstack`` views,
    one a cross group."""
    return [(_unstack(s), c) for s, c in zip(_unstack(params["self_layers"]),
                                             _unstack(params["cross_layers"]))]


def _vlm_cross_layer(cfg: ArchConfig, p: dict, x: torch.Tensor, d: Optional[torch.Tensor],
                     patches: Optional[torch.Tensor] = None, want_kv: bool = False,
                     xkv: Optional[dict] = None, tp: Optional[TensorParallel] = None,
                     xseq: Optional[Tuple[int, int]] = None):
    """The gated cross layer on the stream x + d: x + tanh(gate) * xattn(ln1),
    then the mlp; the cross-attention onto the patches, or onto their K/V ``xkv``
    cached at prefill (decode; ``xseq`` its slice of the patches under ``tp``).
    Returns (x, the mlp's un-added output, the cross K/V where ``want_kv``)."""
    x, h = _add_norm(x, d, p["ln1"], cfg.norm_eps)
    if xkv is None:
        a, k, v = _cross_attn(cfg, p["xattn"], h, patches, tp)
        xkv = {"k": k, "v": v} if want_kv else None
    else:
        a = _cross_attn_cached(cfg, p["xattn"], h, xkv["k"], xkv["v"], tp, xseq)
    x, h = ops.add_rmsnorm(x, _gated(p["gate"], a), p["ln2"], eps=cfg.norm_eps)
    return x, LY.swiglu(p["mlp"], h, tp), xkv


def _vlm_fwd(cfg: ArchConfig, params: dict, x: torch.Tensor, positions: torch.Tensor,
             patches: torch.Tensor, want_kv: bool = False,
             tp: Optional[TensorParallel] = None):
    """Returns (x, d, kvs, xkvs): the stream is x + d; kvs = {"k","v": [nc *
    (k-1), B, S, K, hd]} of the self layers in order, xkvs = {"k","v": [nc, B, P,
    K, hd]} of the cross layers (under ``tp``, the kv heads the rank holds)."""
    def group(x, d, selfs, cross, patches):
        """k - 1 self layers, then the gated cross layer (the JAX package's body)."""
        gkv = []
        for lp in selfs:
            x, d, kv, _, _ = _block(cfg, lp, x, d, positions, 0, want_kv, tp=tp)
            gkv.append(kv)
        x, d, xkv = _vlm_cross_layer(cfg, cross, x, d, patches, want_kv, tp=tp)
        return x, d, gkv, xkv

    group = _remat(group, cfg.remat)
    patches = _into_split(patches, tp)
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
                pos: torch.Tensor, tp: Optional[TensorParallel] = None,
                seq: Optional[Tuple[int, int]] = None,
                xseq: Optional[Tuple[int, int]] = None):
    """One token through the groups; writes each self layer's k/v at ``pos`` of
    ``cache["self"]`` in place and reads ``cache["cross"]`` (under ``tp``, ``seq``
    and ``xseq`` their slices of the sequence and of the patches, as
    ``_block_decode``'s). Returns (x, d)."""
    d = None
    for g, (selfs, cross) in enumerate(_vlm_groups(params)):
        for j, lp in enumerate(selfs):
            x, d = _block_decode(cfg, lp, x, d,
                                 {n: cache["self"][n][g, j] for n in ("k", "v")}, pos, 0,
                                 tp=tp, seq=seq)
        x, d, _ = _vlm_cross_layer(cfg, cross, x, d,
                                   xkv={n: cache["cross"][n][g] for n in ("k", "v")}, tp=tp,
                                   xseq=xseq)
    return x, d


# =============================================================================== Model
class Model:
    """A model of any of the six families bound to an ArchConfig, a device and a
    ``MeshPlan`` (by default the one-device plan of ``device``)."""

    def __init__(self, cfg: ArchConfig, device="cuda", plan: Optional[MeshPlan] = None):
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
        self.plan = plan if plan is not None else MeshPlan(mesh=OneDeviceMesh(self.device))
        self.ranked = isinstance(self.plan.mesh, DeviceMesh)
        self.tp = self._tensor_parallel()

    def init_params(self, seed: int = 0) -> dict:
        return init_params(self.cfg, seed, self.device)

    def abstract_params(self) -> dict:
        return abstract_params(self.cfg)

    def param_specs(self) -> dict:
        return partition_specs(self.cfg, self.plan)

    # ---------------------------------------------------------- tensor parallelism
    def compute_specs(self) -> dict:
        """The spec of every parameter in the layout the layers compute on
        (``parallel.sharding.compute_spec``). A mamba2 block splits its d_inner and
        its heads in step or not at all: where "model" divides only one of them,
        its leaves are whole."""
        specs = tree_map(lambda d: compute_spec(self.plan, d.logical, d.shape),
                         param_defs(self.cfg))
        block = specs.get("layers", {}).get("ssm")
        if block is not None and not (_split(block["w_x"], 2) and _split(block["a_log"], 1)):
            specs["layers"]["ssm"] = tree_map(lambda _: PartitionSpec(), block)
        return specs

    def _tensor_parallel(self) -> Optional[TensorParallel]:
        """The split over a "model" axis of more than one rank: the attention and
        MLP of the dense layers, the shared block (hybrid), the decoder's and the
        encoder's layers and the decoder's cross-attention (encdec), the self and
        the cross layers (vlm), the attention, the experts and the shared experts'
        MLP of the moe layers; the mamba2 blocks' (ssm, hybrid) and the vocab.
        Every stack of a model has the same heads, kv heads and ffn, so they split
        alike; a ``ValueError`` where they would not."""
        if not self.ranked or self.plan.axis_size("model") == 1:
            return None
        specs = self.compute_specs()
        family = self.cfg.family
        flags = {"heads": False, "kv_heads": False, "ffn": False,
                 "vocab": _split(specs["embed"], 0)}
        if family in ("ssm", "hybrid"):
            flags["ssm"] = _split(specs["layers"]["ssm"]["w_x"], 2)
        # (attention, lead dims) and (MLP, lead dims) of each stack
        attns, mlps = [], []
        if family in ("dense", "encdec", "moe"):
            attns.append((specs["layers"]["attn"], 1))
        if family in ("dense", "encdec"):
            mlps.append((specs["layers"]["mlp"], 1))
        if family == "moe":
            moe = specs["layers"]["moe"]
            flags["experts"] = _split(moe["we_gate"], 1)
            if "shared" in moe:
                mlps.append((moe["shared"], 1))
        if family == "hybrid":
            attns.append((specs["shared_block"]["attn"], 0))
            mlps.append((specs["shared_block"]["mlp"], 0))
        if family == "encdec":
            attns += [(specs["layers"]["xattn"], 1), (specs["enc_layers"]["attn"], 1)]
            mlps.append((specs["enc_layers"]["mlp"], 1))
        if family == "vlm":
            attns += [(specs["self_layers"]["attn"], 2), (specs["cross_layers"]["xattn"], 1)]
            mlps += [(specs["self_layers"]["mlp"], 2), (specs["cross_layers"]["mlp"], 1)]
        for flag, leaves, name in (("heads", attns, "wq"), ("kv_heads", attns, "wk"),
                                   ("ffn", mlps, "w_gate")):
            split = {_split(block[name], lead + 1) for block, lead in leaves}
            if len(split) > 1:
                raise ValueError(f"{self.cfg.name}: the stacks split {flag} over 'model' "
                                 f"in some places and not in others")
            flags[flag] = split == {True}
        return TensorParallel(self.plan, **flags)

    def shard_params(self, params: dict) -> dict:
        """This rank's shards of DTensor params in the compute layout, as plain
        tensors (views where the param layout splits no more than the compute
        layout; else gathered); plain params as they are."""
        if not isinstance(params["embed"], DTensor):
            return params
        mesh = self.plan.mesh
        return tree_map(lambda t, s: relayout(t.to_local(), mesh, t.shape, tuple(t.placements),
                                              placements(mesh, s)),
                        params, self.compute_specs())

    def batch_axes(self, rows: int) -> tuple:
        """The mesh axes of more than one rank that the "batch" rule splits a
        batch of ``rows`` rows over."""
        spec = self.plan.spec(("batch",), (rows,))
        entry = spec[0] if len(spec) else None
        axes = (entry,) if isinstance(entry, str) else entry or ()
        return tuple(a for a in axes if self.plan.axis_size(a) > 1)

    def _rows(self, batch: dict):
        """(this rank's rows of ``batch``, the mesh axes of more than one rank that
        split them). A DTensor leaf gives the rows its placements split dim 0 into
        (any other split gathered); a plain leaf holds the whole batch and the rows
        are this rank's under the "batch" rule at its size. Off ``ranked``: the
        batch as it is, no axes."""
        if not self.ranked:
            return batch, ()
        mesh, plan = self.plan.mesh, self.plan
        names = mesh.mesh_dim_names
        out, axes = {}, None
        for name, v in batch.items():
            if isinstance(v, DTensor):
                keep = tuple(pl if pl.is_shard(0) else Replicate() for pl in v.placements)
                split = tuple(n for i, (n, pl) in enumerate(zip(names, keep))
                              if pl.is_shard(0) and mesh.size(i) > 1)
                v = (v if keep == tuple(v.placements) else v.redistribute(mesh, keep)).to_local()
            else:
                split = self.batch_axes(v.shape[0])
                lo, hi = local_range(plan, plan.spec(("batch",), (v.shape[0],)), 0, v.shape[0])
                if hi - lo != v.shape[0]:
                    v = v[lo:hi]
            if axes not in (None, split):
                raise ValueError(f"batch leaf {name!r} splits its rows over {split}, "
                                 f"another leaf over {axes}")
            axes, out[name] = split, v
        return out, axes or ()

    def _wrap(self, local: torch.Tensor, logical: tuple, axes: tuple):
        """This rank's shard of an output (rows split over ``axes``, the last dim
        over "model" where it is the split vocab) as a DTensor on
        ``plan.sharding(logical)``'s placements."""
        mesh = self.plan.mesh
        names = mesh.mesh_dim_names
        vocab = logical[-1] == "vocab" and self.tp is not None and self.tp.vocab
        shape = list(local.shape)
        shape[0] *= math.prod(self.plan.axis_size(a) for a in axes)
        if vocab:
            shape[-1] *= self.tp.size
        target = self.plan.sharding(logical, shape)
        have = tuple(target[i] if mesh.size(i) == 1 else
                     Shard(0) if n in axes else
                     Shard(len(shape) - 1) if n == "model" and vocab else Replicate()
                     for i, n in enumerate(names))
        out = as_dtensor(local, mesh, have, shape)
        return out if have == tuple(target) else out.redistribute(mesh, target)

    # --------------------------------------------------------------------- embedding
    def _embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """The token embeddings; under a vocab split, a masked lookup of the local
        rows of the table summed over "model" (one rank holds each token's row)."""
        if self.tp is None or not self.tp.vocab:
            return params["embed"][tokens.long()]
        table = params["embed"]
        n = table.shape[0]
        ids = tokens.long() - self.tp.rank * n
        hit = (ids >= 0) & (ids < n)
        x = table[ids.clamp(0, n - 1)].masked_fill(~hit[..., None], 0)
        return reduce_from(x, self.plan)

    def _final_norm(self, params: dict, x: torch.Tensor,
                    d: Optional[torch.Tensor]) -> torch.Tensor:
        """rmsnorm of the stream x + d (the final norm takes in the last add)."""
        return _add_norm(x, d, params["final_norm"], self.cfg.norm_eps)[1]

    def _table(self, params: dict) -> torch.Tensor:
        return params["embed"].T if self.cfg.tie_embeddings else params["unembed"]

    def _unembed(self, params: dict, x: torch.Tensor,
                 d: Optional[torch.Tensor]) -> torch.Tensor:
        """Logits of the stream x + d (under a vocab split, this rank's vocab)."""
        h = self._final_norm(params, x, d)
        if self.tp is not None and self.tp.vocab:
            h = copy_to(h, self.plan)
        return h @ self._table(params)

    def _target_logp(self, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """log p of the targets [B, S] from logits [B, S, V]; under a vocab split,
        from this rank's vocab: the max and the sum of exp reduced over "model"
        (the max is a shift, so no gradient flows through it), the target's
        logit from the rank that holds it."""
        if self.tp is None or not self.tp.vocab:
            logp = torch.log_softmax(logits.float(), dim=-1)
            return logp.gather(-1, targets.long()[..., None])[..., 0]
        z = logits.float()
        n = z.shape[-1]
        top = max_over(z.max(dim=-1).values.detach(), self.plan)
        total = reduce_from(torch.exp(z - top[..., None]).sum(dim=-1), self.plan)
        t = targets.long() - self.tp.rank * n
        hit = (t >= 0) & (t < n)
        zt = z.gather(-1, t.clamp(0, n - 1)[..., None])[..., 0].masked_fill(~hit, 0)
        return reduce_from(zt, self.plan) - top - torch.log(total)

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
        dtypes agree both casts are no-ops.

        On ranks the frames are this rank's rows, whole over "model", and the
        layers are tensor-parallel (``self.tp``) as the decoder's."""
        cfg, tp = self.cfg, self.tp
        positions = self._positions(frames.shape[0], frames.shape[1])

        def first_layer(lp, x):
            h = LY.rmsnorm(x, lp["ln1"], cfg.norm_eps).to(frames.dtype).to(x.dtype)
            return _block_normed(cfg, lp, x, h, positions, 0, False, None, False, tp)[:2]

        def layer(lp, x, d):
            return _block(cfg, lp, x, d, positions, 0, False, causal=False, tp=tp)[:2]

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
        final-normed hidden state [B,S,D] when ``return_hidden`` (chunked CE).
        DTensor params are tensor-parallel and the output a DTensor."""
        dtensors = isinstance(params["embed"], DTensor)
        if dtensors:
            mesh = params["embed"].device_mesh
            if not self.ranked or self.plan.mesh != mesh:
                raise ValueError(f"params are DTensors on {mesh}, the model's plan is on "
                                 f"{self.plan.mesh}")
        rows, axes = self._rows(batch)
        out, aux = self._forward_local(self.shard_params(params), rows, return_hidden, axes)
        if not dtensors:
            return out, aux
        logical = ("batch", "seq", None if return_hidden else "vocab")
        return (self._wrap(out, logical, axes),
                as_dtensor(aux, self.plan.mesh, (Replicate(),) * self.plan.mesh.ndim, ()))

    def _forward_local(self, params: dict, batch: Dict[str, torch.Tensor],
                       return_hidden: bool, axes: tuple = ()):
        """``forward`` on this rank's shards and rows (split over the mesh axes
        ``axes``)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._embed(params, tokens)
        stats = None
        family = self.cfg.family
        if family == "ssm":
            x, d, _ = _ssm_fwd(self.cfg, params, x, tp=self.tp)
        elif family == "hybrid":
            x, d, _ = _hybrid_fwd(self.cfg, params, x, self._positions(B, S), tp=self.tp)
        elif family == "vlm":
            x, d, _, _ = _vlm_fwd(self.cfg, params, x, self._positions(B, S),
                                  batch["patches"], tp=self.tp)
        else:
            memory = self._encode(params, batch["frames"]) if family == "encdec" else None
            x, d, _, _, stats = _stack_fwd(self.cfg, params, x, self._positions(B, S),
                                           memory=memory, tp=self.tp)
        aux = self._aux(stats, B * S, axes)
        if return_hidden:
            return self._final_norm(params, x, d), aux
        return self._unembed(params, x, d), aux

    def _aux(self, stats: Optional[torch.Tensor], tokens: int, axes: tuple) -> torch.Tensor:
        """The sum of the MoE layers' load-balance losses over the whole batch from
        their ``routing_stats`` [L, 2, E] of this rank's ``tokens`` tokens, summed
        over the batch ``axes`` first (the identity backward); 0 without MoE
        layers."""
        if stats is None:
            return torch.zeros((), dtype=torch.float32, device=self.device)
        stats = sum_over(stats, self.plan, axes)
        n = tokens * math.prod(self.plan.axis_size(a) for a in axes)
        return MOE.aux_from_stats(self.cfg, stats, n).sum()

    # ------------------------------------------------------------------------- loss
    def loss_fn(self, params: dict, batch: Dict[str, torch.Tensor]):
        """Masked CE (+ 0.01 aux). Returns (loss, metrics {loss, aux_loss, tokens}).

        CE takes log p of the target by a gather, never a one-hot. With
        ``cfg.loss_chunk`` the [B,S,V] logits are never materialised: see
        ``_chunked_ce``. Twin of the JAX package's ``Model.loss_fn``.

        On ranks (see the module docstring) the CE's denominator is the global
        token count and the CE is summed over the batch axes (identity backward),
        so the loss is the global one on every rank and each rank's gradient is
        its rows' share; the MoE aux is the global batch's too (``_aux``)."""
        params = self.shard_params(params)
        batch, axes = self._rows(batch)
        mask = batch["loss_mask"].float()
        tokens = sum_over(mask.sum(), self.plan, axes)
        denom = tokens.clamp_min(1.0)
        if self.cfg.loss_chunk:
            hidden, aux = self._forward_local(params, batch, True, axes)
            ce = self._chunked_ce(params, hidden, batch["targets"], mask) / denom
        else:
            logits, aux = self._forward_local(params, batch, False, axes)
            ll = self._target_logp(logits, batch["targets"])                 # [B, S]
            ce = -(ll * mask).sum() / denom
        ce = sum_over(ce, self.plan, axes)
        loss = ce + 0.01 * aux
        metrics = {"loss": ce.detach(), "aux_loss": aux.detach(), "tokens": tokens}
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
            if self.tp is not None and self.tp.vocab:
                ll = self._target_logp(copy_to(xc, self.plan) @ table, tc)
                return -(ll * mc).sum()
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
        ``max_len``; the cross K/V (encdec, vlm) keep the memory's length.
        On ranks the logits and the cache are DTensors, the cache on
        ``cache_specs``' placements (``_cache_laid_out``)."""
        params = self.shard_params(params)
        batch, axes = self._rows(batch)
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
                                     batch["patches"], want_kv=True, tp=self.tp)
            groups = (xkv["k"].shape[0], self.cfg.cross_attn_every - 1)
            cache = {"pos": pos, "cross": xkv, "self": {
                n: _pad_seq(t, max_len).unflatten(0, groups) for n, t in kv.items()}}
        elif family == "encdec":
            memory = self._encode(params, batch["frames"])
            x, d, (kv,), (xkv,), _ = _stack_fwd(self.cfg, params, x, self._positions(B, S),
                                               want_kv=True, memory=memory, tp=self.tp)
            cache = {"pos": pos, "self": {n: _pad_seq(t, max_len) for n, t in kv.items()},
                     "cross": xkv}
        elif family == "ssm":
            x, d, layers = _ssm_fwd(self.cfg, params, x, want_state=True, tp=self.tp)
            cache = {"pos": pos, "layers": layers}
        elif self.cfg.family == "hybrid":
            x, d, (main, kv, tail) = _hybrid_fwd(self.cfg, params, x, self._positions(B, S),
                                                 want_state=True, tp=self.tp)
            cache = {"pos": pos, "main": main,
                     "shared": {n: _pad_seq(t, max_len) for n, t in kv.items()},
                     "tail": tail}
        else:
            x, d, kvs, _, _ = _stack_fwd(self.cfg, params, x, self._positions(B, S),
                                         want_kv=True, tp=self.tp)
            # a windowed layer's kv is in ring layout already
            cache = {"pos": pos, "layers": tuple(
                kv if _window_for(self.cfg, j) else
                {n: _pad_seq(t, max_len) for n, t in kv.items()}
                for j, kv in enumerate(kvs))}
        last_logits = self._unembed(params, x[:, -1:],
                                    None if d is None else d[:, -1:])[:, 0]
        if self.ranked:
            rows = B * math.prod(self.plan.axis_size(a) for a in axes)
            return (self._wrap(last_logits, ("batch", "vocab"), axes),
                    self._cache_laid_out(cache, rows, max_len))
        return last_logits, cache

    def _cache_laid_out(self, cache: dict, batch: int, max_len: int) -> dict:
        """A prefill's cache of this rank's rows in the compute layout as DTensors
        on ``cache_specs``' placements: of a k/v leaf (self or cross; [G, B, S, K,
        hd], vlm's self cache [nc, grp, B, S, K, hd]: its dims read from its
        logical axes) the kv heads gathered where the cache does not split them,
        the sequence narrowed to this rank's slice where it does; a conv tail
        laid out by ``_conv_laid_out``; the SSD state's heads split as they are
        computed."""
        mesh, plan = self.plan.mesh, self.plan

        def lay(t, d):
            spec = plan.spec(d.logical, d.shape)
            if "cache_seq" in d.logical:                # a k/v leaf
                seq, heads = d.logical.index("cache_seq"), d.logical.index("kv_heads")
                if (self.tp is not None and self.tp.kv_heads
                        and (spec[heads] if heads < len(spec) else None) is None):
                    t = gather_along(t, heads, plan)
                lo, hi = local_range(plan, spec, seq, d.shape[seq])
                if hi - lo != t.shape[seq]:
                    t = t.narrow(seq, lo, hi - lo).contiguous()
            elif d.logical[-1] == "ffn":                # the conv tail
                t = self._conv_laid_out(t, d)
            return as_dtensor(t, mesh, placements(mesh, spec), d.shape)
        return tree_map(lay, cache, self.cache_defs(batch, max_len))

    def _conv_laid_out(self, t: torch.Tensor, d: TensorDef) -> torch.Tensor:
        """A conv tail [..., W-1, C_local] in the compute layout (this rank's xs
        channels, then all of B and C) as this rank's slice of the JAX package's
        layout: its contiguous 1/M of the channels [xs | B | C] where
        ``cache_specs`` splits them over "model"."""
        plan, C = self.plan, d.shape[-1]
        split = self.tp is not None and self.tp.ssm
        lo, hi = local_range(plan, plan.spec(d.logical, d.shape), len(d.shape) - 1, C)
        if not t.numel():
            return t.new_empty(t.shape[:-1] + (hi - lo,))
        if split:
            DIl = t.shape[-1] - 2 * self.cfg.ssm_state
            t = torch.cat([gather_along(t[..., :DIl].contiguous(), t.dim() - 1, plan),
                           t[..., DIl:]], dim=-1)
        return t if hi - lo == C else t[..., lo:hi].contiguous()

    def _conv_computed(self, t: torch.Tensor, d: TensorDef) -> torch.Tensor:
        """This rank's slice of a conv tail in the JAX package's layout (as
        ``cache_specs`` lays it out) in the compute layout: the inverse of
        ``_conv_laid_out``."""
        plan, C = self.plan, d.shape[-1]
        split = self.tp is not None and self.tp.ssm
        DI, M = self.cfg.d_inner, plan.axis_size("model")
        width = C - DI + DI // M if split else C
        if not t.numel():
            return t.new_empty(t.shape[:-1] + (width,))
        if t.shape[-1] != C:
            t = gather_along(t.contiguous(), t.dim() - 1, plan)
        if not split:
            return t
        r = self.tp.rank
        return torch.cat([t[..., r * (DI // M):(r + 1) * (DI // M)], t[..., DI:]], dim=-1)

    def _seq_slice(self, kv: DTensor, d: TensorDef) -> Optional[Tuple[int, int]]:
        """(first position, whole length) of this rank's slice of a k/v cache leaf
        (``d`` its ``cache_defs`` entry) whose sequence is split over "model";
        None where it is not split."""
        spec = self.plan.spec(d.logical, kv.shape)
        seq = d.logical.index("cache_seq")
        if self.tp is None or len(spec) <= seq or spec[seq] is None:
            return None
        return local_range(self.plan, spec, seq, kv.shape[seq])[0], kv.shape[seq]

    # ------------------------------------------------------------------- decode step
    def decode_step(self, params: dict, tokens: torch.Tensor, cache: dict):
        """tokens [B, 1] -> (logits [B, V], new_cache). Writes the cache in place.
        On ranks the cache is DTensors on ``cache_specs``' placements (``init_cache``,
        ``prefill``) and the logits a DTensor."""
        if self.ranked:
            return self._decode_ranked(params, tokens, cache)
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

    def _decode_ranked(self, params: dict, tokens: torch.Tensor, cache: dict):
        if not isinstance(cache["pos"], DTensor):
            raise ValueError("a decode step on ranks takes the cache as DTensors laid out "
                             "by cache_specs (init_cache, prefill)")
        params = self.shard_params(params)
        rows, axes = self._rows({"tokens": tokens})
        local = tree_map(lambda t: t.to_local(), cache)
        pos = local["pos"]
        x = self._embed(params, rows["tokens"])
        family = self.cfg.family
        defs = self.cache_defs(cache["pos"].shape[0], 1)

        def seq(name):
            return self._seq_slice(cache[name]["k"], defs[name]["k"])
        if family in ("dense", "moe"):
            slices = tuple(self._seq_slice(kv["k"], dk["k"])
                           for kv, dk in zip(cache["layers"], defs["layers"]))
            x, d = _stack_decode(self.cfg, params, x, local["layers"], pos, tp=self.tp,
                                 seq=slices)
        elif family == "encdec":
            x, d = _stack_decode(self.cfg, params, x, (local["self"],), pos,
                                 cross_kvs=(local["cross"],), tp=self.tp,
                                 seq=(seq("self"),), xseq=(seq("cross"),))
        elif family == "vlm":
            x, d = _vlm_decode(self.cfg, params, x, local, pos, self.tp, seq("self"),
                               seq("cross"))
        else:      # the conv tails in the compute layout for the step, then laid back
            stacks = ("layers",) if family == "ssm" else ("main", "tail")
            states = {n: dict(local[n], conv=self._conv_computed(local[n]["conv"],
                                                                 defs[n]["conv"]))
                      for n in stacks}
            if family == "ssm":
                x, d = _ssm_decode(self.cfg, params, x, states["layers"], self.tp)
            else:
                x, d = _hybrid_decode(self.cfg, params, x, dict(local, **states), pos, self.tp,
                                      seq("shared"))
            for n in stacks:
                local[n]["conv"].copy_(self._conv_laid_out(states[n]["conv"], defs[n]["conv"]))
        logits = self._wrap(self._unembed(params, x, d)[:, 0], ("batch", "vocab"), axes)
        new_pos = as_dtensor(pos + 1, self.plan.mesh, tuple(cache["pos"].placements),
                             cache["pos"].shape)
        return logits, dict(cache, pos=new_pos)

    # ------------------------------------------------------------------- cache views
    def cache_defs(self, batch: int, max_len: int) -> dict:
        """The cache's ``TensorDef`` tree with the JAX package's logical axes."""
        cfg = self.cfg
        pos = TensorDef((batch,), torch.int32, ("batch",))
        dt = getattr(torch, cfg.dtype)
        K, hd = cfg.num_kv_heads, cfg.head_dim
        kv_log = (None, "batch", "cache_seq", "kv_heads", None)

        def kv(G, S):
            return {"k": TensorDef((G, batch, S, K, hd), dt, kv_log),
                    "v": TensorDef((G, batch, S, K, hd), dt, kv_log)}

        def ssm_state(*lead):
            defs = SSM.ssm_state_defs(cfg, batch, *lead)
            lead_log = (None,) * len(lead)
            return {"conv": TensorDef(*defs["conv"], lead_log + ("batch", None, "ffn")),
                    "ssd": TensorDef(*defs["ssd"],
                                     lead_log + ("batch", "ssm_heads", None, None))}

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
                    "self": {n: TensorDef((nc, grp, batch, max_len, K, hd), dt,
                                          (None,) + kv_log)
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
        """Zeros of ``cache_defs``; on ranks each rank's shard of them, as DTensors
        on ``cache_specs``' placements."""
        if not self.ranked:
            return tree_map(lambda d: torch.zeros(d.shape, dtype=d.dtype, device=self.device),
                            self.cache_defs(batch, max_len))
        mesh = self.plan.mesh

        def zeros(d):
            pls = self.plan.sharding(d.logical, d.shape)
            shape = list(d.shape)
            for i, pl in enumerate(pls):
                if pl.is_shard():
                    shape[pl.dim] //= mesh.size(i)
            return as_dtensor(torch.zeros(shape, dtype=d.dtype, device=self.device), mesh,
                              pls, d.shape)
        return tree_map(zeros, self.cache_defs(batch, max_len))

    def cache_specs(self, batch: int, max_len: int) -> dict:
        return tree_map(lambda d: self.plan.spec(d.logical, d.shape),
                        self.cache_defs(batch, max_len))
