"""RecSys model family: FM / DeepFM / Wide&Deep / xDeepFM over a shared
embedding-bag substrate (port of ``repro.models.recsys``).

All per-field tables are stacked into one (V_total, D) table; the wide /
first-order weights live in a parallel (V_total, 1) table. Parameters are a
nested dict of tensors with the reference's names (``convert`` carries them
across).

The FM second-order interaction goes through ``kernels.fm_interact``: its
CUDA kernel for a tensor on the card, its plain version on the CPU (the
reference's ``use_pallas`` switch is the tensor's device here).

Training on a mesh (``forward``/``loss_fn`` with ``mesh=``): ``table`` and
``wide`` are ``table_rows`` blocks over the flat (data, model) grid and
everything else is replicated (:func:`param_axes`); the batch's rows split
over ``data``. The lookup is row-sharded: every rank gathers the ids of the
data ranks, answers those in its own row range (zeros elsewhere), and the
answers are reduce-scattered back to the data blocks over ``data`` and
summed over ``model``; exactly one rank answers each id, so the sums are
exact. A table's gradient lands on its own rows only. ``fm_interact`` runs
on each rank's rows. Ranks that differ only in ``model`` compute the same
rows, so each differentiates 1 / M of their loss (``distributed/fsdp.py``).
``serve`` takes the same blocks (without grad). ``score_candidates`` on a
mesh scores this rank's block of the candidates (the flat ``candidates``
grid) and only each block's top-k crosses.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.distributed import comm, fsdp
from repro_torch.distributed import sharding as sh
from repro_torch.kernels.fm_interact import ops as fm_ops
from repro_torch.models import nn


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    arch: str                      # fm | deepfm | wide_deep | xdeepfm
    n_fields: int
    embed_dim: int
    vocab_sizes: tuple[int, ...]   # per field (len == n_fields)
    n_dense: int = 13
    multi_hot: int = 1             # ids per field (EmbeddingBag width)
    mlp_dims: tuple[int, ...] = ()
    cin_dims: tuple[int, ...] = ()
    interaction: str = "fm"        # fm | concat | cin | fm-2way
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def total_vocab(self) -> int:
        return int(sum(self.vocab_sizes))

    @property
    def field_offsets(self) -> tuple[int, ...]:
        return tuple(int(o) for o in np.cumsum((0,) + self.vocab_sizes[:-1]))


# ------------------------------------------------------------ embedding bag
def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mode: str = "sum",
                  weights: torch.Tensor | None = None,
                  compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Fixed-hot EmbeddingBag: ids (..., hot) -> (..., D) reduced over hot.

    Row gather + sum/mean. ``compute_dtype`` casts the gathered rows before
    the reduction: the cast is elementwise, so this gives the bits of
    casting the whole table first, at the cost of the rows alone."""
    if mode not in ("sum", "mean"):
        raise ValueError(mode)
    emb = table[ids.long()]                                # (..., hot, D)
    if compute_dtype is not None:
        emb = emb.to(compute_dtype)
    if weights is not None:
        emb = emb * weights[..., None]
    return emb.sum(dim=-2) if mode == "sum" else emb.mean(dim=-2)


def embedding_bag_ragged(table: torch.Tensor, flat_ids: torch.Tensor,
                         segment_ids: torch.Tensor, n_bags: int,
                         mode: str = "sum") -> torch.Tensor:
    """Ragged EmbeddingBag: variable-length bags summed by segment id
    (torch ``EmbeddingBag(..., offsets)`` semantics); segment ids outside
    [0, n_bags) are dropped, as ``jax.ops.segment_sum`` drops them."""
    emb = table[flat_ids.long()]                           # (nnz, D)
    seg = segment_ids.long()
    ok = (seg >= 0) & (seg < n_bags)
    seg, emb = seg[ok], emb[ok]
    s = torch.zeros((n_bags, emb.shape[-1]), dtype=emb.dtype, device=emb.device)
    s.index_add_(0, seg, emb)
    if mode == "mean":
        cnt = torch.zeros(n_bags, dtype=s.dtype, device=s.device)
        cnt.index_add_(0, seg, torch.ones_like(seg, dtype=s.dtype))
        s = s / torch.clamp(cnt[:, None], min=1.0)
    return s


# --------------------------------------------------------------------- init
def param_axes(cfg: RecsysConfig) -> dict:
    """The params' logical axes (the reference's ``param_axes``): the tables
    row-sharded, the rest replicated."""
    axes: dict = {"table": ("table_rows", None), "wide": ("table_rows", None), "bias": ()}
    if cfg.n_dense:
        axes["dense_proj"] = {"w": (None, None)}
    if cfg.mlp_dims:
        n = len(cfg.mlp_dims) + 1
        axes["mlp"] = {}
        for i in range(n):
            axes["mlp"][f"fc{i}"] = {"w": (None, "mlp_hidden" if i < n - 1 else None)}
            axes["mlp"][f"b{i}"] = ("mlp_hidden" if i < n - 1 else None,)
    if cfg.interaction == "cin":
        axes["cin"] = {f"w{i}": (None, None, None) for i in range(len(cfg.cin_dims))}
        axes["cin_out"] = {"w": (None, None)}
    return axes


def init(generator: torch.Generator | None, cfg: RecsysConfig,
         device: str | torch.device = "cuda") -> dict:
    """Random parameters with the reference's shapes and scales, drawn from
    ``generator`` (which must live on ``device``; None only for
    ``device="meta"``, which gives the shapes and allocates nothing)."""
    dev = resolve_device(device)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    params: dict = {
        "table": normal(cfg.total_vocab, cfg.embed_dim) * 0.01,
        "wide": normal(cfg.total_vocab, 1) * 0.01,
        "bias": torch.zeros((), device=dev),
    }
    if cfg.n_dense:
        params["dense_proj"] = nn.dense_init(generator, cfg.n_dense, cfg.embed_dim, device=dev)
    if cfg.mlp_dims:
        d_in = cfg.n_fields * cfg.embed_dim + (cfg.embed_dim if cfg.n_dense else 0)
        params["mlp"] = nn.mlp_init(generator, (d_in, *cfg.mlp_dims, 1), device=dev)
    if cfg.interaction == "cin":
        cin_p = {}
        h_prev = cfg.n_fields
        for i, h in enumerate(cfg.cin_dims):
            cin_p[f"w{i}"] = normal(h, h_prev, cfg.n_fields) / math.sqrt(h_prev * cfg.n_fields)
            h_prev = h
        params["cin"] = cin_p
        params["cin_out"] = nn.dense_init(generator, int(sum(cfg.cin_dims)), 1, device=dev)
    return params


# ------------------------------------------------------------------ forward
@functools.lru_cache(maxsize=16)
def _offsets(offsets: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The fields' first rows in the stacked table, made once per device (a
    copy to the card per call would stall the stream)."""
    return torch.tensor(offsets, dtype=torch.int64, device=device)


def _sharded_rows(block: torch.Tensor, ids: torch.Tensor, mesh, dtype) -> torch.Tensor:
    """Rows ``ids`` (global rows, this rank's data block of them) of the
    ``table_rows``-sharded table whose block this rank holds, in ``dtype``:
    (..., D) for ids (...). An id outside this rank's rows reads a spare
    zero row that the lookup's backward skips (``padding_idx``), so the
    gradient's scatter touches this rank's own ids only."""
    data = sh.mesh_axes(mesh, "batch")
    rows = sh.mesh_axes(mesh, "table_rows")
    n = block.shape[0]
    lo = sh.index_along(mesh, rows) * n
    every = comm.all_gather(ids, mesh, data)                  # the data ranks' ids
    mine = (every >= lo) & (every < lo + n)
    padded = torch.cat([block, block.new_zeros((1, block.shape[1]))])
    got = F.embedding(torch.where(mine, every - lo, n), padded, padding_idx=n).to(dtype)
    got = comm.reduce_scatter(got, mesh, data)                # back to the data blocks
    return comm.psum(got, mesh, tuple(a for a in rows if a not in data))


def _field_embed(params: dict, batch: dict, cfg: RecsysConfig, mesh=None):
    """(B, F, hot) per-field ids -> (B, F, D) bagged embeddings in
    ``compute_dtype`` + the f32 wide logit (B,).

    The reference casts the whole stacked table to ``compute_dtype`` and
    then gathers (676.5 MB read, 338 MB written per DeepFM FULL forward);
    gathering first and casting the rows gives the same bits."""
    ids = batch["sparse_ids"].long() + _offsets(cfg.field_offsets, params["table"].device)[
        None, :, None]                                          # global rows
    if mesh is not None:
        emb = _sharded_rows(params["table"], ids, mesh, cfg.compute_dtype).sum(dim=-2)
        wide = _sharded_rows(params["wide"], ids, mesh, torch.float32).sum(dim=-2)[..., 0]
        return emb, wide.sum(dim=-1)
    emb = embedding_bag(params["table"], ids, compute_dtype=cfg.compute_dtype)
    wide = embedding_bag(params["wide"].float(), ids)[..., 0]  # (B, F)
    return emb, wide.sum(dim=-1)


def _cin(params: dict, x0: torch.Tensor, cfg: RecsysConfig) -> torch.Tensor:
    """Compressed Interaction Network (xDeepFM): x0 (B, F, D) -> (B, sum H)."""
    outs = []
    xk = x0
    for i in range(len(cfg.cin_dims)):
        w = params["cin"][f"w{i}"].to(x0.dtype)                 # (H, Hk, F)
        z = xk[:, :, None, :] * x0[:, None, :, :]               # (B, Hk, F, D)
        xk = torch.einsum("bhfd,nhf->bnd", z, w)                # (B, H, D)
        outs.append(xk.sum(dim=-1))                             # (B, H)
    return torch.cat(outs, dim=-1)


def _replicated(params: dict, cfg: RecsysConfig, mesh) -> dict:
    """The replicated leaves through ``fsdp.use`` (their gradients sum over
    the mesh); the tables stay blocks."""
    axes = param_axes(cfg)
    return {k: (v if k in ("table", "wide") else
                sh.tree_map_axes(lambda t, ax, name: fsdp.use(t, mesh, ax), v, axes[k]))
            for k, v in params.items()}


def forward(params: dict, batch: dict, cfg: RecsysConfig, mesh=None) -> torch.Tensor:
    """Returns pre-sigmoid logits (B,) in f32:
    ``bias + wide + (fm | cin) + deep``, summed in that order. On a
    ``mesh``: ``params`` are this rank's blocks and ``batch`` its data
    rows, whose logits come back."""
    dt = cfg.compute_dtype
    if mesh is not None:
        params = _replicated(params, cfg, mesh)
    emb, wide_logit = _field_embed(params, batch, cfg, mesh)
    b = emb.shape[0]
    logit = params["bias"] + wide_logit

    # only the deep tower reads the dense projection (FM has none: the
    # reference computes it there and never uses it)
    dense_emb = None
    if cfg.n_dense and "dense" in batch and cfg.mlp_dims:
        dense_emb = nn.dense(params["dense_proj"], batch["dense"].to(dt), dt)

    if cfg.interaction in ("fm", "fm-2way"):
        logit = logit + fm_ops.fm_interact(emb)
    elif cfg.interaction == "cin":
        cin_feat = _cin(params, emb, cfg).to(dt)
        logit = logit + nn.dense(params["cin_out"], cin_feat, dt)[..., 0].float()

    if cfg.mlp_dims:
        flat = emb.reshape(b, -1)
        if dense_emb is not None:
            flat = torch.cat([flat, dense_emb], dim=-1)
        deep = nn.mlp(params["mlp"], flat, n_layers=len(cfg.mlp_dims) + 1)
        logit = logit + deep[..., 0].float()
    return logit


def loss_fn(params: dict, batch: dict, cfg: RecsysConfig, mesh=None) -> torch.Tensor:
    """Mean binary cross-entropy of the f32 logits against ``labels``, in
    the stable form ``max(l, 0) - l y + log1p(exp(-|l|))``. On a ``mesh``:
    the global mean, with the gradient of this rank's share."""
    logit = forward(params, batch, cfg, mesh)
    y = batch["labels"].float()
    per = torch.clamp(logit, min=0) - logit * y + torch.log1p(torch.exp(-logit.abs()))
    if mesh is None:
        return torch.mean(per)
    n = per.shape[0] * sh.axis_count(mesh, "batch")
    local = per.sum()
    value = comm.psum(local.detach(), mesh, sh.mesh_axes(mesh, "batch")) / n
    return fsdp.objective(value, local / (n * fsdp.replication(mesh, ("batch",))))


def serve(params: dict, batch: dict, cfg: RecsysConfig, mesh=None) -> torch.Tensor:
    """Click probabilities (B,) f32: the sigmoid of :func:`forward`. On a
    ``mesh`` (no grad): ``params`` this rank's blocks, ``batch`` its data
    rows, whose probabilities come back; ``fm_interact`` runs once, on the
    rank's rows."""
    if mesh is None:
        return torch.sigmoid(forward(params, batch, cfg))
    with torch.no_grad():
        return torch.sigmoid(forward(params, batch, cfg, mesh))


# -------------------------------------------------------- retrieval scoring
def _top_k(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """The k best (score, id) pairs, by score descending and id ascending
    (``lax.top_k``'s rule when ``ids`` ascend): a stable descending sort."""
    top, idx = torch.sort(scores, descending=True, stable=True)
    return top[:k], ids[idx[:k]]


def score_candidates(query_emb: torch.Tensor, cand_embs: torch.Tensor, k: int = 100,
                     mesh=None, n_valid: int | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """retrieval_cand shape: one query vs n_candidates, f32 mat-vec + top-k.

    Returns (scores (k,) f32 descending, ids (k,) int32). Equal scores rank
    by lower index (the reference's ``lax.top_k`` rule): a stable descending
    sort. Candidates at or past ``n_valid`` score -inf.

    On a ``mesh``: ``cand_embs`` is this rank's block of the candidates,
    split over the flat ``candidates`` grid. The mat-vec and a top-k are
    local; only the k (score, global id) pairs of each block cross (an
    all_gather), merged by score descending, then global id ascending. Every
    rank returns the same result."""
    scores = cand_embs.float() @ query_emb.float()
    n = scores.shape[0]
    axes = () if mesh is None else sh.mesh_axes(mesh, "candidates")
    ids = torch.arange(n, device=scores.device) + (0 if mesh is None else
                                                  sh.index_along(mesh, axes) * n)
    if n_valid is not None:
        scores = torch.where(ids < n_valid, scores, torch.full_like(scores, -math.inf))
    top, idx = _top_k(scores, ids, k)
    if mesh is not None:
        every = comm.all_gather(idx, mesh, axes)
        order = torch.argsort(every, stable=True)                  # global id ascending
        top, idx = _top_k(comm.all_gather(top, mesh, axes)[order], every[order], k)
    return top, idx.to(torch.int32)
