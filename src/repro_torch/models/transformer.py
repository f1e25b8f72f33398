"""Decoder-only transformer family (port of ``repro.models.transformer``):
dense GQA (yi, granite, minitron) and MoE (dbrx, deepseek-moe), on one
device or over a mesh of ranks (``mesh=``: training through
``forward``/``loss_fn``, serving through ``prefill``/``decode_step``).

On a mesh (``distributed/fsdp.py``): the params are this rank's ZeRO-3
blocks of :func:`param_axes` (the reference's logical axes), each gathered
in the layer that reads it; the tokens are (``batch``@data, ``seq``@model)
blocks, so the loss gets the rank's data rows and the forward takes its
sequence block; attention gathers K and V over ``model`` (``seq_kv`` ->
replicated) and masks with global positions; ``embed.table`` and
``head.w`` are ``vocab``@model blocks, gathered for the lookup and the
logits. The MoE computes what the reference computes on that mesh, which
is not the single device's result: with at least 64 tokens a shard it is
the shard-mapped MoE (each (data, model) shard routes its own tokens with
its own capacity, and the expert slots cross ``model`` in two all_to_alls
to the ranks that hold their experts, whose ``d_ff`` is gathered over data
only); below that, the dispatch groups of ``_moe_groups`` (contiguous
slices of the row-major B x S tokens, whatever the ranks hold: every rank
gathers the tokens, runs the groups and keeps its own block's outputs).
The aux loss reads the global ``probs`` and ``top_e`` means. ``moe_tiles=
(dp, ml)`` on one device runs the shard-mapped dispatch as a loop over the
mesh's token blocks (the card's check of the mesh run).

Serving on a mesh runs without grad: ``prefill`` is the training forward
(the same layer code) into a cache of (``cache_batch``@data,
``cache_seq``@model) blocks; ``decode_step`` is flash-decoding over the
split cache (``cache_seq``, or ``cache_seq_flat`` at batch 1), its MoE in
the reference's ``_moe_groups(B, mesh)`` groups. Neither gathers the vocab
leaves: a token is looked up on the rank's ``embed.table`` rows and summed
over ``model``, and the logits come from the rank's ``head.w`` columns.

Parameters are the reference's tree: ``embed.table`` (V, d), ``head.w``
(d, V), ``ln_f`` (d,) and ``layers``, whose weights are stacked (L, ...).
A forward splits the stack once with ``torch.unbind`` (indexing ``w[l]``
inside the layer loop would make every select's backward allocate a whole
(L, ...) zero tensor).

What stays as the reference computes it: the attention is a blocked online
softmax over KV blocks of ``q_chunk`` with f32 accumulators and -inf
masking (not ``scaled_dot_product_attention``), scores are f32 products of
the compute-dtype operands; the MoE is the sort-based capacity dispatch of
one group with the Switch-style aux loss; the cross-entropy is chunked over
``ce_chunk``. Ties in the router take the lower expert index (a stable
descending sort, as ``lax.top_k``), and the dispatch order is a stable
argsort.

Remat: ``jax.checkpoint(nothing_saveable)`` becomes
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, only while
grad is on: each layer (or each of ``scan_groups`` groups), each KV block
of the attention and each cross-entropy chunk. None of it changes a value.

Deliberate differences: ``decode_step`` and ``prefill`` write the new K/V
into the cache tensors in place and return them (the reference returns a
new cache: 34 GB a step at decode_32k batch 8); embeddings are gathered
then cast, so the table's gradient accumulates duplicate ids in f32 (the
reference casts the table first and accumulates in the compute dtype).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.distributed import comm, fsdp
from repro_torch.distributed import sharding as sh
from repro_torch.models import nn


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0          # deepseek-style always-on shared experts
    d_ff: int = 0              # per-expert hidden dim
    capacity_factor: float = 1.25
    impl: str = "dropping"     # "dropping" (sort+capacity) | "dense" (debug)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                  # dense-FFN hidden (MoE archs: shared/dense path)
    vocab: int
    d_head: int = 128
    moe: MoEConfig | None = None
    ffn_type: str = "swiglu"   # "swiglu" (3 mats) | "gelu" (2 mats, gpt-bigcode)
    rope_theta: float = 10_000.0
    q_chunk: int = 1024        # attention KV-block size
    ce_chunk: int = 512        # cross-entropy seq-block size
    remat: bool = True
    scan_groups: int = 1       # checkpoint groups of L / G layers instead of each layer
    cast_params_once: bool = True   # cast the stacked mats to compute_dtype once a forward
    compute_dtype: Any = torch.bfloat16

    @property
    def n_params(self) -> int:
        """Analytic parameter count (embed + layers + head)."""
        d, dh = self.d_model, self.d_head
        attn = d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh + self.n_heads * dh * d
        dense_ffn = (3 if self.ffn_type == "swiglu" else 2) * d * self.d_ff
        per_layer = attn + 2 * d  # + norms
        if self.moe is not None:
            per_layer += self.moe.n_experts * 3 * d * self.moe.d_ff
            per_layer += self.moe.n_shared * 3 * d * self.moe.d_ff
            per_layer += d * self.moe.n_experts
        else:
            per_layer += dense_ffn
        return self.n_layers * per_layer + 2 * self.vocab * d + d

    @property
    def n_active_params(self) -> int:
        """Params touched per token (MoE: top-k + shared experts only)."""
        if self.moe is None:
            return self.n_params
        d = self.d_model
        inactive = self.n_layers * (self.moe.n_experts - self.moe.top_k) * 3 * d * self.moe.d_ff
        return self.n_params - inactive


# --------------------------------------------------------------------- init
def param_table(cfg: TransformerConfig) -> dict:
    """Static parameter spec: the params tree with ``(shape, init scale)``
    leaves (scale ``"ones"`` for the norms); building it allocates nothing."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    L = cfg.n_layers
    s_attn = 1.0 / (d ** 0.5)
    s_ffn = 1.0 / (d ** 0.5)

    def lyr(shape, scale):
        return ((L, *shape), scale)

    layers = {
        "wq": lyr((d, h * dh), s_attn),
        "wk": lyr((d, kv * dh), s_attn),
        "wv": lyr((d, kv * dh), s_attn),
        "wo": lyr((h * dh, d), 1.0 / (h * dh) ** 0.5),
        "ln1": ((L, d), "ones"),
        "ln2": ((L, d), "ones"),
    }
    if cfg.moe is None:
        if cfg.ffn_type == "swiglu":
            layers["w_gate"] = lyr((d, cfg.d_ff), s_ffn)
        layers["w_up"] = lyr((d, cfg.d_ff), s_ffn)
        layers["w_down"] = lyr((cfg.d_ff, d), 1.0 / cfg.d_ff ** 0.5)
    else:
        e, f = cfg.moe.n_experts, cfg.moe.d_ff
        layers["router"] = lyr((d, e), s_ffn)
        layers["we_gate"] = lyr((e, d, f), s_ffn)
        layers["we_up"] = lyr((e, d, f), s_ffn)
        layers["we_down"] = lyr((e, f, d), 1.0 / f ** 0.5)
        if cfg.moe.n_shared:
            sf = cfg.moe.n_shared * cfg.moe.d_ff
            layers["ws_gate"] = lyr((d, sf), s_ffn)
            layers["ws_up"] = lyr((d, sf), s_ffn)
            layers["ws_down"] = lyr((sf, d), 1.0 / sf ** 0.5)
    return {
        "embed": {"table": ((cfg.vocab, d), 0.02)},
        "head": {"w": ((d, cfg.vocab), s_attn)},
        "layers": layers,
        "ln_f": ((d,), "ones"),
    }


def param_axes(cfg: TransformerConfig) -> dict:
    """The params' logical axes (the reference's ``param_axes``): ZeRO-3
    ``fsdp`` storage of the layer matrices, experts on ``experts`` with
    their ``d_ff`` on ``expert_ff``, the vocab on ``vocab``; norms and the
    router replicated."""
    kv_axes = (None, "fsdp") if (cfg.n_kv_heads * cfg.d_head) % 512 == 0 else ("fsdp", None)
    layers = {"wq": ("layers", None, "fsdp"), "wk": ("layers", *kv_axes),
              "wv": ("layers", *kv_axes), "wo": ("layers", None, "fsdp"),
              "ln1": ("layers", None), "ln2": ("layers", None)}
    if cfg.moe is None:
        if cfg.ffn_type == "swiglu":
            layers["w_gate"] = ("layers", None, "fsdp")
        layers["w_up"] = ("layers", None, "fsdp")
        layers["w_down"] = ("layers", "fsdp", None)
    else:
        layers["router"] = ("layers", None, None)
        layers["we_gate"] = ("layers", "experts", None, "expert_ff")
        layers["we_up"] = ("layers", "experts", None, "expert_ff")
        layers["we_down"] = ("layers", "experts", "expert_ff", None)
        if cfg.moe.n_shared:
            sfa = (None, "fsdp") if (cfg.moe.n_shared * cfg.moe.d_ff) % 512 == 0 \
                else ("fsdp", None)
            layers["ws_gate"] = ("layers", *sfa)
            layers["ws_up"] = ("layers", *sfa)
            layers["ws_down"] = ("layers", *reversed(sfa))
    return {"embed": {"table": ("vocab", None)}, "head": {"w": (None, "vocab")},
            "layers": layers, "ln_f": (None,)}


def _spec_items(table: dict, path: str = ""):
    """(path, (shape, scale)) in the reference's flatten order (sorted keys)."""
    for k in sorted(table):
        v = table[k]
        if isinstance(v, dict):
            yield from _spec_items(v, f"{path}.{k}".lstrip("."))
        else:
            yield f"{path}.{k}".lstrip("."), v


def init(generator: torch.Generator | None, cfg: TransformerConfig,
         device: str | torch.device = "cuda") -> dict:
    """Random f32 parameters with the reference's shapes and scales, drawn
    from ``generator`` (on ``device``) leaf by leaf in flatten order: N(0, 1)
    times the scale, ones for the norms. ``device="meta"`` with no generator
    gives the shapes and allocates nothing."""
    dev = resolve_device(device)
    out: dict = {}
    for path, (shape, scale) in _spec_items(param_table(cfg)):
        if scale == "ones":
            leaf = torch.ones(shape, device=dev)
        else:
            leaf = torch.randn(shape, generator=generator, device=dev).mul_(scale)
        node = out
        *parents, name = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return out


# ---------------------------------------------------------------- attention
def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, dh); positions: (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs          # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _scalar(value: float, dtype: torch.dtype) -> torch.Tensor:
    """A 0-dim constant in ``dtype``: a Python scalar times a bf16 tensor
    rounds the scalar to bf16 first in JAX, and this keeps that rounding."""
    return torch.tensor(value, dtype=dtype)


def _attend(q, k, v, q_pos, kv_pos, cfg: TransformerConfig, causal: bool = True):
    """q: (B, Sq, H, dh); k/v: (B, Skv, KV, dh) -> (B, Sq, H, dh) in the
    compute dtype. Online softmax over KV blocks of ``q_chunk`` (one block
    when ``q_chunk`` does not divide Skv), f32 accumulators; with remat and
    grad on, each block is checkpointed."""
    b, sq, h, dh = q.shape
    skv, kv = k.shape[1], k.shape[2]
    group = h // kv
    qg = (q * _scalar(dh ** -0.5, q.dtype)).reshape(b, sq, kv, group, dh).float()

    c = min(cfg.q_chunk, skv)
    n_blk = skv // c if skv % c == 0 else 1
    c = skv // n_blk
    kv_pos = kv_pos if kv_pos.dim() == 2 else kv_pos.expand(b, skv)
    m = torch.full((b, kv, group, sq), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kv, group, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, kv, group, sq, dh), dtype=torch.float32, device=q.device)
    ck = cfg.remat and torch.is_grad_enabled()
    for i in range(n_blk):
        blk = slice(i * c, (i + 1) * c)
        args = (qg, k[:, blk], v[:, blk], q_pos, kv_pos[:, blk], m, l, o, causal,
                cfg.compute_dtype)
        m, l, o = checkpoint(_attend_block, *args, use_reentrant=False) if ck else \
            _attend_block(*args)
    o = o / torch.clamp(l[..., None], min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(cfg.compute_dtype)


def _attend_block(qg, kb, vb, q_pos, pb, m_prev, l_prev, o_prev, causal, dt):
    """One KV block of the online softmax: the reference's scan body."""
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kb.float())        # (B, KV, G, Sq, c)
    if causal:
        mask = q_pos[:, None, None, :, None] >= pb[:, None, None, None, :]
        s = s.masked_fill(~mask, -math.inf)
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    corr = torch.where(torch.isfinite(m_prev), torch.exp(m_prev - m_safe), 0.0)
    l_new = l_prev * corr + p.sum(dim=-1)
    o_blk = torch.einsum("bkgqs,bskd->bkgqd", p.to(dt), vb)
    return m_new, l_new, o_prev * corr[..., None] + o_blk.float()


# ------------------------------------------------------------- parallelism
@dataclasses.dataclass(frozen=True)
class _Par:
    """How a forward's tokens are split. ``mesh`` None and ``tiles`` False:
    one device, the reference without a mesh. ``mesh``: this rank holds
    token block (``di``, ``mi``) of a (dp, ml) grid, B x S global.
    ``tiles``: one device computes every block's shard-mapped dispatch."""
    mesh: Any = None
    dp: int = 1
    ml: int = 1
    di: int = 0
    mi: int = 0
    tiles: bool = False
    axes: Any = None               # param_axes(cfg) on a mesh
    # whether this rank's tokens are its data block of the B rows and its
    # model block of the S positions (training, prefill), or hold them whole
    # (decode: one position; at batch 1 every row); an axis of size 1 splits
    split: tuple = (True, True)

    @property
    def n(self) -> int:
        return self.dp * self.ml

    @property
    def grid(self) -> bool:
        """The tokens are this rank's (B / dp, S / ml) block."""
        return self.split == (True, True)

    def block(self, b: int, s: int) -> tuple[int, int, int, int]:
        """(global rows, global positions, first row, first position) of a
        (b, s) token block held here."""
        rows, cols = self.split
        return (b * self.dp if rows else b, s * self.ml if cols else s,
                self.di * b if rows else 0, self.mi * s if cols else 0)

    def all_axes(self) -> tuple[str, ...]:
        return tuple(self.mesh.axis_names)

    def data_axes(self) -> tuple[str, ...]:
        return sh.mesh_axes(self.mesh, "batch")

    def model_axes(self) -> tuple[str, ...]:
        return sh.mesh_axes(self.mesh, "seq")


def _par(cfg: TransformerConfig, mesh, moe_tiles, split=(True, True)) -> _Par:
    if mesh is not None and moe_tiles is not None:
        raise ValueError("moe_tiles emulates a mesh on one device: pass one or the other")
    if moe_tiles is not None:
        return _Par(dp=int(moe_tiles[0]), ml=int(moe_tiles[1]), tiles=True)
    if mesh is None:
        return _Par()
    dp, ml = sh.axis_count(mesh, "batch"), sh.axis_count(mesh, "seq")
    return _Par(mesh, dp, ml, sh.index_along(mesh, sh.mesh_axes(mesh, "batch")),
                sh.index_along(mesh, sh.mesh_axes(mesh, "seq")), False, param_axes(cfg),
                (split[0] or dp == 1, split[1] or ml == 1))


def _use(par: _Par, name: str, w: torch.Tensor, over=None) -> torch.Tensor:
    """Layer leaf ``name`` (one layer's slice of its block) to compute with."""
    if par.mesh is None:
        return w
    return fsdp.use(w, par.mesh, par.axes["layers"][name][1:], over=over)


def _tok_axis(t: int, mesh) -> str | None:
    """Widest shardable logical axis for a length-t token dimension."""
    if mesh is None:
        return None
    if t % math.prod(mesh.shape.values()) == 0:
        return "tokens_flat"
    return "batch" if t % sh.axis_count(mesh, "batch") == 0 else None


def _moe_groups(t: int, par: _Par) -> int:
    """Dispatch-group count: the flat grid size when tokens allow, else the
    data-parallel size, else 1 (one device)."""
    if par.mesh is None:
        return 1
    if t % par.n == 0 and t // par.n >= 16:
        return par.n
    if t % par.dp == 0 and t // par.dp >= 4:
        return par.dp
    return 1


def _capacity(t: int, m: MoEConfig) -> int:
    cap = max(int(-(-t * m.top_k // m.n_experts) * m.capacity_factor), m.top_k)
    return -(-cap // 8) * 8


# ---------------------------------------------------------------------- MoE
def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x: torch.Tensor, router: torch.Tensor, k: int):
    """f32 router softmax and its top-k: (probs (t, E), top_p (t, k) f32
    renormalised, top_e (t, k))."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    top_p, top_e = _top_k(probs, k)
    return probs, top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9), top_e


def _moe_dispatch(x, router, wg, wu, wd, cfg: TransformerConfig, cap: int,
                  exchange=None):
    """The dropping MoE over one dispatch group: route, sort the (token,
    choice) slots by expert (stable), give each expert its first ``cap``
    slots, run the expert GEMMs on (E, cap, d), and give each kept slot its
    expert's output row at its rank; a slot past its expert's capacity
    contributes zero (the reference's ascending masked dynamic_update_slice
    combine). x: (t, d). ``exchange``: (to the experts' ranks, back), the
    shard-mapped MoE's two all_to_alls around the GEMMs, whose ``wg``,
    ``wu``, ``wd`` then hold this rank's experts. Returns (y, probs,
    top_e)."""
    m = cfg.moe
    dt = cfg.compute_dtype
    t, d = x.shape
    e, k = router.shape[-1], m.top_k
    mg = t * k
    probs, top_p, top_e = _route(x, router, k)
    ge = top_e.reshape(mg)
    gw = top_p.to(dt).reshape(mg)
    gtok = torch.arange(t, device=x.device).repeat_interleave(k)
    order = torch.argsort(ge, stable=True)
    se, stok, sw = ge[order], gtok[order], gw[order]
    seg_start = torch.searchsorted(se, torch.arange(e + 1, device=x.device))
    rank = torch.arange(mg, device=x.device) - seg_start[se]
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, 0)
    # a dropped slot writes a spare last row, cut off after: no data-dependent
    # shape (no host sync for a mask's count; the step runs on the meta device)
    dest = torch.where(keep, slot, e * cap)
    buf = x.new_zeros((e * cap + 1, d)).index_put((dest,), x[stok])[:-1]
    buf = buf.view(e, cap, d)
    if exchange is not None:
        buf = exchange[0](buf)
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, wg.to(dt))) * \
        torch.einsum("ecd,edf->ecf", buf, wu.to(dt))
    y_e = torch.einsum("ecf,efd->ecd", h, wd.to(dt))
    if exchange is not None:
        y_e = exchange[1](y_e)
    y_e = y_e.reshape(e * cap, d)
    contrib = torch.where(keep[:, None], y_e[slot], 0.0) * sw[:, None]
    inv = torch.argsort(order)
    y = contrib[inv].reshape(t, k, d).sum(dim=1)
    return y, probs, top_e


def _moe_ffn(p, y3, cfg: TransformerConfig, par: _Par = _Par()):
    """Capacity-dispatch MoE. y3: (B, S, d) (on a mesh: this rank's token
    block) -> ((B, S, d), aux loss); the aux loss is the global one, the
    same on every rank."""
    if par.mesh is not None or par.tiles:
        return _moe_ffn_split(p, y3, cfg, par)[:2]
    m = cfg.moe
    b, s, d = y3.shape
    t = b * s
    dt = cfg.compute_dtype
    e, k = m.n_experts, m.top_k
    x_flat = y3.reshape(t, d)
    if m.impl == "dense":
        probs, top_p, top_e = _route(x_flat, p["router"], k)
        h_g = torch.einsum("td,edf->tef", x_flat, p["we_gate"].to(dt))
        h_u = torch.einsum("td,edf->tef", x_flat, p["we_up"].to(dt))
        y_e = torch.einsum("tef,efd->ted", F.silu(h_g) * h_u, p["we_down"].to(dt))
        w = torch.zeros((t, e), dtype=dt, device=y3.device).scatter(1, top_e, top_p.to(dt))
        y = torch.einsum("ted,te->td", y_e, w)
    elif m.impl == "dropping":
        y, probs, top_e = _moe_dispatch(x_flat, p["router"], p["we_gate"], p["we_up"],
                                        p["we_down"], cfg, _capacity(t, m))
    else:
        raise ValueError(f"moe impl {m.impl!r}")
    if m.n_shared:
        hs = F.silu(x_flat @ p["ws_gate"].to(dt)) * (x_flat @ p["ws_up"].to(dt))
        y = y + hs @ p["ws_down"].to(dt)
    # load-balance aux loss (Switch-style)
    me = torch.mean(probs.float(), dim=0)
    ce_frac = torch.zeros(e, device=y3.device).index_add_(
        0, top_e.reshape(-1), torch.ones(t * k, device=y3.device)) / (t * k)
    aux = e * torch.sum(me * ce_frac)
    return y.reshape(b, s, d), aux


def _moe_ffn_split(p, y3, cfg: TransformerConfig, par: _Par):
    """``_moe_ffn`` over a token grid: on a mesh of ranks, or one device
    looping over the grid's blocks (``par.tiles``). Returns (y, aux, the
    top-k experts of y3's tokens)."""
    m = cfg.moe
    b, s, d = y3.shape
    dt = cfg.compute_dtype
    e, k = m.n_experts, m.top_k
    b_glob, s_glob, row0, col0 = par.block(b, s)
    t_glob = b * s if par.tiles else b_glob * s_glob
    t_loc = t_glob // par.n
    use_sm = m.impl == "dropping" and e % par.ml == 0 and t_loc >= 64 and par.grid
    mesh = par.mesh
    full = lambda name: _use(par, name, p[name])
    summed = True              # probs / top_e are this rank's shares (psum them)
    if par.tiles:
        if not use_sm:
            raise ValueError(f"moe_tiles emulates the shard-mapped MoE, which needs "
                             f">= 64 tokens a block ({t_loc})")
        bl, sl = b // par.dp, s // par.ml
        ys, probs, top_e = [], [], []
        for i in range(par.dp):
            row = []
            for j in range(par.ml):
                blk = y3[i * bl:(i + 1) * bl, j * sl:(j + 1) * sl].reshape(-1, d)
                y, pr, te = _moe_dispatch(blk, p["router"], p["we_gate"], p["we_up"],
                                          p["we_down"], cfg, _capacity(t_loc, m))
                row.append(y.reshape(bl, sl, d))
                probs.append(pr)
                top_e.append(te)
            ys.append(torch.cat(row, dim=1))
        y = torch.cat(ys, dim=0).reshape(b * s, d)
        probs, top_e = torch.cat(probs), torch.cat(top_e)
        summed = False
    elif m.impl == "dense" or use_sm:
        router = full("router")
        x_loc = y3.reshape(-1, d)
        if m.impl == "dense":
            wg, wu, wd = full("we_gate"), full("we_up"), full("we_down")
            probs, top_p, top_e = _route(x_loc, router, k)
            h = F.silu(torch.einsum("td,edf->tef", x_loc, wg.to(dt))) * \
                torch.einsum("td,edf->tef", x_loc, wu.to(dt))
            y_e = torch.einsum("tef,efd->ted", h, wd.to(dt))
            w = torch.zeros((x_loc.shape[0], e), dtype=dt, device=y3.device).scatter(
                1, top_e, top_p.to(dt))
            y = torch.einsum("ted,te->td", y_e, w)
        else:
            data = par.data_axes()
            wg = _use(par, "we_gate", p["we_gate"], over=data)    # (e_loc, d, f)
            wu = _use(par, "we_up", p["we_up"], over=data)
            wd = _use(par, "we_down", p["we_down"], over=data)
            e_loc, ml, model = e // par.ml, par.ml, par.model_axes()
            cap = _capacity(t_loc, m)

            def to_experts(buf):                   # (E, cap, d) -> (e_loc, ml * cap, d)
                got = comm.all_to_all(buf.reshape(ml, e_loc, cap, d), mesh, model)
                return got.transpose(0, 1).reshape(e_loc, ml * cap, d)

            def back(y_e):                         # (e_loc, ml * cap, d) -> (E, cap, d)
                y_e = y_e.reshape(e_loc, ml, cap, d).transpose(0, 1).contiguous()
                return comm.all_to_all(y_e, mesh, model).reshape(e, cap, d)

            y, probs, top_e = _moe_dispatch(x_loc, router, wg, wu, wd, cfg, cap,
                                            exchange=(to_experts, back))
    else:
        # the dispatch groups are contiguous slices of the global row-major
        # tokens: gather them, run every group, keep this block's outputs
        x_all = y3
        if par.split[1]:
            x_all = comm.all_gather(x_all, mesh, par.model_axes(), dim=1)
        if par.split[0]:
            x_all = comm.all_gather(x_all, mesh, par.data_axes(), dim=0)
        g = _moe_groups(t_glob, par)
        tg = t_glob // g
        cap = _capacity(tg, m)
        ws = [full(n) for n in ("router", "we_gate", "we_up", "we_down")]
        parts = [_moe_dispatch(xg, *ws, cfg, cap) for xg in x_all.reshape(g, tg, d)]
        y_all = torch.cat([q[0] for q in parts]).reshape(b_glob, s_glob, d)
        y = y_all[row0:row0 + b, col0:col0 + s].reshape(-1, d)
        probs, top_e = torch.cat([q[1] for q in parts]), torch.cat([q[2] for q in parts])
        summed = False
    x_flat = y3.reshape(-1, d)
    if m.n_shared:
        hs = F.silu(x_flat @ full("ws_gate").to(dt)) * (x_flat @ full("ws_up").to(dt))
        y = y + hs @ full("ws_down").to(dt)
    # load-balance aux loss over the global probs and top_e
    p_sum = probs.float().sum(dim=0)
    counts = torch.zeros(e, device=y3.device).index_add_(
        0, top_e.reshape(-1), torch.ones(top_e.numel(), device=y3.device))
    if summed and mesh is not None:
        p_sum = comm.psum(p_sum, mesh, par.all_axes())
        counts = comm.psum(counts, mesh, par.all_axes())
    aux = e * torch.sum((p_sum / t_glob) * (counts / (t_glob * k)))
    if not summed and not par.tiles:           # keep this block's routing
        top_e = top_e.reshape(b_glob, s_glob, k)[row0:row0 + b, col0:col0 + s]
    return y.reshape(b, s, d), aux, top_e.reshape(b, s, k)


def _dense_ffn(p, y, cfg: TransformerConfig):
    dt = cfg.compute_dtype
    if cfg.ffn_type == "swiglu":
        h = F.silu(y @ p["w_gate"].to(dt)) * (y @ p["w_up"].to(dt))
    else:
        h = F.gelu(y @ p["w_up"].to(dt), approximate="tanh")   # jax.nn.gelu's default
    return h @ p["w_down"].to(dt)


# ------------------------------------------------------------------- blocks
def _qkv(p, y, positions, cfg: TransformerConfig):
    b, s, _ = y.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = cfg.compute_dtype
    q = (y @ p["wq"].to(dt)).reshape(b, s, h, dh)
    k = (y @ p["wk"].to(dt)).reshape(b, s, kv, dh)
    v = (y @ p["wv"].to(dt)).reshape(b, s, kv, dh)
    return _rope(q, positions, cfg.rope_theta), _rope(k, positions, cfg.rope_theta), v


_EXPERT_LEAVES = ("router", "we_gate", "we_up", "we_down", "ws_gate", "ws_up", "ws_down")


def _ffn(p, x, cfg: TransformerConfig, par: _Par = _Par()):
    """The block's second half: x + FFN(rmsnorm(x)) and the aux loss."""
    y = nn.rmsnorm({"scale": p["ln2"]}, x)
    if cfg.moe is None:
        return x + _dense_ffn(p, y, cfg), torch.zeros((), device=x.device)
    y_moe, aux = _moe_ffn(p, y, cfg, par)
    return x + y_moe, aux


def _gathered(p, par: _Par) -> dict:
    """A layer's leaves to compute with: on a mesh each gathered from its
    block, but the experts' (the MoE gathers those it needs)."""
    if par.mesh is None:
        return p
    return {k: (w if k in _EXPERT_LEAVES else _use(par, k, w)) for k, w in p.items()}


def _attention(p, x, positions, cfg: TransformerConfig, par: _Par = _Par()):
    """The block's first half: x + attention(rmsnorm(x)), and the K/V
    attended over (on a mesh gathered over ``model``: the whole sequence of
    this rank's rows)."""
    b, s, _ = x.shape
    kv_pos = positions
    y = nn.rmsnorm({"scale": p["ln1"]}, x)
    q, k, v = _qkv(p, y, positions, cfg)
    if par.mesh is not None and par.ml > 1:
        # seq_kv -> replicated: every rank attends over the whole sequence
        k = comm.all_gather(k, par.mesh, par.model_axes(), dim=1)
        v = comm.all_gather(v, par.mesh, par.model_axes(), dim=1)
        kv_pos = torch.arange(s * par.ml, device=x.device).expand(b, s * par.ml)
    o = _attend(q, k, v, positions, kv_pos, cfg)
    return x + (o.reshape(b, s, -1) @ p["wo"].to(cfg.compute_dtype)), k, v


def _layer(p, x, positions, cfg: TransformerConfig, par: _Par = _Par()):
    """One pre-norm block. x: (B, S, d), this rank's token block on a mesh
    (``positions`` global); the layer's leaves are gathered here, so remat
    gathers them again."""
    p = _gathered(p, par)
    x, _, _ = _attention(p, x, positions, cfg, par)
    return _ffn(p, x, cfg, par)


def _cast_layer_params(layers: dict, cfg: TransformerConfig) -> dict:
    """One cast of the big stacked mats (ndim >= 3) to the compute dtype;
    norm scales (ndim 2) stay f32."""
    if not cfg.cast_params_once:
        return layers
    return {k: w.to(cfg.compute_dtype) if w.dim() >= 3 else w for k, w in layers.items()}


def _unstack(layers: dict) -> list[dict]:
    """The stacked (L, ...) weights as L per-layer dicts of views (one
    ``unbind`` a leaf)."""
    split = {k: w.unbind(0) for k, w in layers.items()}
    n = len(next(iter(split.values())))
    return [{k: split[k][i] for k in split} for i in range(n)]


def _scan_layers(body, x, layer_params: list[dict], cfg: TransformerConfig):
    """The layer loop. With remat and grad on, each layer is checkpointed,
    or (``scan_groups`` G dividing L) each group of L / G layers. Returns
    (x, [aux per layer])."""
    L, G = len(layer_params), cfg.scan_groups
    ck = cfg.remat and torch.is_grad_enabled()
    groups = [layer_params] if G <= 1 or L % G else \
        [layer_params[i:i + L // G] for i in range(0, L, L // G)]
    if len(groups) == 1 and ck:
        groups = [[lp] for lp in layer_params]

    def run(xc, group):
        auxes = []
        for lp in group:
            xc, a = body(xc, lp)
            auxes.append(a)
        return xc, torch.stack(auxes)

    aux = []
    for group in groups:
        x, a = checkpoint(run, x, group, use_reentrant=False) if ck else run(x, group)
        aux.append(a)
    return x, torch.cat(aux)


def forward(params, tokens, cfg: TransformerConfig, mesh=None, moe_tiles=None):
    """tokens (B, S) -> final hidden states (B, S, d) + aux loss. On a
    ``mesh``: ``params`` are this rank's blocks, ``tokens`` its data rows
    (B / dp, S), and the result is its (B / dp, S / ml) block of hidden
    states with the global aux loss. ``moe_tiles``: module docstring."""
    return _forward(params, tokens, cfg, _par(cfg, mesh, moe_tiles))


def _forward(params, tokens, cfg: TransformerConfig, par: _Par):
    b, s = tokens.shape
    if par.mesh is not None:
        if s % par.ml:
            raise ValueError(f"seq {s} does not split over {par.ml} model ranks")
        s //= par.ml
        tokens = tokens[:, par.mi * s:(par.mi + 1) * s]
        table = fsdp.use(params["embed"]["table"], par.mesh, par.axes["embed"]["table"])
        x = nn.embed({"table": table}, tokens, cfg.compute_dtype)
        ln_f = fsdp.use(params["ln_f"], par.mesh, par.axes["ln_f"])
    else:
        x = nn.embed(params["embed"], tokens, cfg.compute_dtype)
        ln_f = params["ln_f"]
    positions = (torch.arange(s, device=tokens.device) + par.mi * s).expand(b, s)
    layers = _unstack(_cast_layer_params(params["layers"], cfg))
    x, aux = _scan_layers(lambda xc, lp: _layer(lp, xc, positions, cfg, par), x, layers, cfg)
    x = nn.rmsnorm({"scale": ln_f}, x)
    return x, torch.sum(aux)


def _ce_block(xb, lb, head):
    logits = (xb @ head).float()                                  # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lb[..., None].long())[..., 0]
    return torch.sum(lse - gold)


def loss_fn(params, batch, cfg: TransformerConfig, mesh=None, aux_weight: float = 0.01,
            moe_tiles=None):
    """Chunked cross-entropy (``ce_chunk`` positions a chunk, one chunk when
    it does not divide S; each chunk checkpointed while grad is on, so no
    chunk's f32 logits outlive it) + ``aux_weight`` x the MoE aux loss. On a
    ``mesh`` (``batch`` this rank's data rows): the global loss, whose
    gradient is this rank's share (its tokens' cross-entropy, 1 / N of the
    aux loss)."""
    par = _par(cfg, mesh, moe_tiles)
    x, aux = _forward(params, batch["tokens"], cfg, par)
    b, s, d = x.shape
    labels = batch["labels"]
    if par.mesh is not None:
        labels = labels[:, par.mi * s:(par.mi + 1) * s]
        head = fsdp.use(params["head"]["w"], mesh, par.axes["head"]["w"])
        ce = _ce_sum(x, labels, head.to(cfg.compute_dtype), cfg)
        n_tok = b * s * par.n
        value = comm.psum(ce.detach(), mesh, par.all_axes()) / n_tok + aux_weight * aux
        return fsdp.objective(value, ce / n_tok + aux_weight * aux / par.n)
    head = params["head"]["w"].to(cfg.compute_dtype)
    return _ce_sum(x, labels, head, cfg) / (b * s) + aux_weight * aux


def _ce_sum(x, labels, head, cfg: TransformerConfig):
    b, s, d = x.shape
    c = min(cfg.ce_chunk, s)
    n_chunk = s // c if s % c == 0 else 1
    c = s // n_chunk
    ck = torch.is_grad_enabled()
    parts = []
    for i in range(n_chunk):
        blk = slice(i * c, (i + 1) * c)
        args = (x[:, blk], labels[:, blk], head)
        parts.append(checkpoint(_ce_block, *args, use_reentrant=False) if ck else
                     _ce_block(*args))
    return torch.sum(torch.stack(parts))


# ------------------------------------------------------------------ serving
CACHE_AXES = ("layers", "cache_batch", "cache_seq", "kv_heads", "d_head")
# batch 1 (long_500k): the cache's sequence split over the whole grid
CACHE_AXES_FLAT = ("layers", None, "cache_seq_flat", "kv_heads", "d_head")


def cache_axes(flat: bool = False) -> dict:
    """The cache's logical axes (the reference's ``cache_axes``; ``flat``:
    its batch-1 layout, ``cache_seq_flat``)."""
    ax = CACHE_AXES_FLAT if flat else CACHE_AXES
    return {"k": ax, "v": ax, "pos": (None,) if flat else ("cache_batch",)}


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int, dtype=None,
               device: str | torch.device = "cuda", mesh=None) -> dict:
    """A zero cache of ``batch`` rows and ``max_seq`` positions; on a
    ``mesh``, this rank's (``cache_batch``, ``cache_seq``) block of it, the
    layout ``prefill`` writes."""
    dev = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    pos = (batch,)
    if mesh is not None:
        axes = cache_axes()
        shape = sh.block_shape(shape, mesh, axes["k"], "cache")
        pos = sh.block_shape(pos, mesh, axes["pos"], "cache pos")
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": torch.zeros(pos, dtype=torch.int32, device=dev)}


def _vocab_rows(block: torch.Tensor, ids: torch.Tensor, mesh, dtype) -> torch.Tensor:
    """This rank's share of the embedding of ``ids`` (global token ids):
    the rows of its ``vocab`` block, zeros for the others, in ``dtype``. A
    sum over the ``vocab`` axes gives the lookup, exactly (one rank holds
    each row)."""
    n = block.shape[0]
    lo = sh.index_along(mesh, sh.mesh_axes(mesh, "vocab")) * n
    mine = (ids >= lo) & (ids < lo + n)
    rows = F.embedding(torch.where(mine, ids - lo, 0).long(), block).to(dtype)
    return torch.where(mine[..., None], rows, torch.zeros((), dtype=dtype, device=rows.device))


def prefill(params, tokens, cache, cfg: TransformerConfig, mesh=None, moe_tiles=None):
    """Full-sequence prefill: writes each layer's K/V into
    ``cache["k"/"v"][:, :, :S]`` in place and returns (last-position logits
    (B, 1, V) f32, the cache with ``pos`` = S).

    On a ``mesh`` (no grad): ``params`` are this rank's blocks, ``tokens``
    its data rows (B / dp, S) and ``cache`` its (``cache_batch``,
    ``cache_seq``) block. The forward is the training forward's, context
    parallel over ``model`` (the layers gathered one at a time); the
    embedding is a masked lookup on the rank's vocab rows, reduce-scattered
    over ``model`` to its sequence block. Each rank writes the positions of
    its cache block from the K/V that attention gathered over ``model``
    (the cache may be longer than the prompt). Returns the rank's (B / dp,
    1, V / ml) block of the logits (computed on its ``head.w`` columns) and
    its cache block. ``moe_tiles``: as in :func:`forward`."""
    if mesh is None:
        return _prefill(params, tokens, cache, cfg, _par(cfg, None, moe_tiles))
    with torch.no_grad():
        return _prefill(params, tokens, cache, cfg, _par(cfg, mesh, None))


def _prefill(params, tokens, cache, cfg: TransformerConfig, par: _Par):
    b, s = tokens.shape
    dt = cfg.compute_dtype
    mesh = par.mesh
    if mesh is None:
        x = nn.embed(params["embed"], tokens, dt)
        lo = 0
    else:
        if s % par.ml:
            raise ValueError(f"seq {s} does not split over {par.ml} model ranks")
        x = _vocab_rows(params["embed"]["table"], tokens, mesh, dt)
        x = comm.reduce_scatter(x, mesh, par.model_axes(), dim=1)   # (B / dp, S / ml, d)
        lo = sh.index_along(mesh, sh.mesh_axes(mesh, "cache_seq")) * cache["k"].shape[2]
    n_cache = cache["k"].shape[2] * (1 if mesh is None else par.ml)
    if s > n_cache:
        raise ValueError(f"a prompt of {s} positions does not fit a cache of {n_cache}")
    s_loc = x.shape[1]
    positions = (torch.arange(s_loc, device=tokens.device) + par.mi * s_loc).expand(b, s_loc)
    width = max(0, min(cache["k"].shape[2], s - lo))           # cache positions the prompt fills
    for li, lp in enumerate(_unstack(_cast_layer_params(params["layers"], cfg))):
        lp = _gathered(lp, par)
        x, k, v = _attention(lp, x, positions, cfg, par)
        x, _ = _ffn(lp, x, cfg, par)
        cache["k"][li, :, :width] = k[:, lo:lo + width]
        cache["v"][li, :, :width] = v[:, lo:lo + width]
    cache = dict(cache, pos=torch.full((b,), s, dtype=torch.int32, device=tokens.device))
    x = x[:, -1:]
    if mesh is None:
        ln_f, head = params["ln_f"], params["head"]["w"]
    else:                                   # the last position is on the last model rank
        x = comm.all_gather(x, mesh, par.model_axes(), dim=1)[:, -1:]
        ln_f = fsdp.use(params["ln_f"], mesh, par.axes["ln_f"])
        head = params["head"]["w"]                                  # (d, V / ml) block
    x = nn.rmsnorm({"scale": ln_f}, x)
    return (x @ head.to(dt)).float(), cache


def decode_step(params, tokens, cache, cfg: TransformerConfig, mesh=None, flat: bool = False):
    """One-token decode against the KV cache: tokens (B,) -> (logits (B, 1,
    V) f32, the cache with the new K/V written in place at ``pos`` (clamped
    to the cache's end, as ``dynamic_update_slice`` clamps) and ``pos`` + 1).
    Scores are f32 products scaled by dh^-0.5, positions past ``pos``
    masked to -1e30, as in the reference.

    On a ``mesh`` (no grad), flash-decoding over the split cache:
    ``params`` are this rank's blocks and ``cache`` its block, laid out by
    :func:`cache_axes` (``flat``: batch 1, the sequence over the whole
    grid, ``tokens`` whole; else ``tokens`` and the cache's rows this
    rank's data rows, the sequence over ``model``). The rank whose block
    holds ``pos`` writes the new K/V; scores, the mask and AV are local to
    the block, and the softmax is reduced across the sequence's shards
    (``pmax`` of the max, ``psum`` of the sum, the probabilities cast to the
    compute dtype as the reference casts them, the partial outputs
    multiplied and summed in f32 and rounded once). The MoE dispatches in
    the reference's ``_moe_groups(B, mesh)`` groups. Returns the rank's
    logits block (its rows, its ``head.w`` columns) and its cache block."""
    if mesh is None:
        return _decode(params, tokens, cache, cfg, _Par(), ())
    with torch.no_grad():
        ax = cache_axes(flat)["k"]
        par = _par(cfg, mesh, None, split=(not flat, False))
        return _decode(params, tokens, cache, cfg, par, sh.mesh_axes(mesh, ax[2]))


def _decode(params, tokens, cache, cfg: TransformerConfig, par: _Par, seq_axes):
    b = tokens.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = cfg.compute_dtype
    group = h // kv
    mesh = par.mesh
    pos = cache["pos"]
    s_loc = cache["k"].shape[2]
    if mesh is None:
        x = nn.embed(params["embed"], tokens[:, None], dt)       # (B, 1, d)
        lo, s_max = 0, s_loc
    else:
        x = _vocab_rows(params["embed"]["table"], tokens[:, None], mesh, dt)
        x = comm.psum(x, mesh, sh.mesh_axes(mesh, "vocab"))
        lo, s_max = sh.index_along(mesh, seq_axes) * s_loc, s_loc * comm.axis_size(mesh, seq_axes)
    at = pos.long().clamp(max=s_max - 1)
    mine = (at >= lo) & (at < lo + s_loc)                        # this block holds pos
    at = torch.where(mine, at - lo, 0)
    rows = torch.arange(b, device=tokens.device)
    kv_pos = torch.arange(s_loc, device=tokens.device) + lo
    mask = (kv_pos[None, :] <= pos[:, None])[:, None, None, :]
    # on a mesh the blocks are cast once, so the gathers move the compute dtype
    layers = params["layers"] if mesh is None else _cast_layer_params(params["layers"], cfg)
    for li, lp in enumerate(_unstack(layers)):
        lp = _gathered(lp, par)
        ck, cv = cache["k"][li], cache["v"][li]                   # (B, S, KV, dh) views
        y = nn.rmsnorm({"scale": lp["ln1"]}, x)
        q, knew, vnew = _qkv(lp, y, pos[:, None], cfg)
        keep = ~mine[:, None, None]
        ck[rows, at] = torch.where(keep, ck[rows, at], knew[:, 0].to(ck.dtype))
        cv[rows, at] = torch.where(keep, cv[rows, at], vnew[:, 0].to(cv.dtype))
        qg = q.reshape(b, kv, group, dh)
        s = torch.einsum("bkgd,bskd->bkgs", qg.float(), ck.float()) * dh ** -0.5
        s = torch.where(mask, s, -1e30)
        if mesh is None:
            p_att = torch.softmax(s, dim=-1).to(dt)
            o = torch.einsum("bkgs,bskd->bkgd", p_att, cv)
        else:
            m = comm.pmax(s.amax(dim=-1), mesh, seq_axes)
            e = torch.exp(s - m[..., None])
            p_att = (e / comm.psum(e.sum(dim=-1), mesh, seq_axes)[..., None]).to(dt)
            # the partial products in f32: the output rounds once, as one device's does
            o = torch.einsum("bkgs,bskd->bkgd", p_att.float(), cv.float())
            o = comm.psum(o, mesh, seq_axes).to(dt)
        x = x + o.reshape(b, 1, h * dh) @ lp["wo"].to(dt)
        x, _ = _ffn(lp, x, cfg, par)
    cache = dict(cache, pos=pos + 1)
    ln_f = params["ln_f"] if mesh is None else fsdp.use(params["ln_f"], mesh, par.axes["ln_f"])
    x = nn.rmsnorm({"scale": ln_f}, x)
    return (x @ params["head"]["w"].to(dt)).float(), cache
