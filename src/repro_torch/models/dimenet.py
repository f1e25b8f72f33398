"""DimeNet (Gasteiger et al., arXiv:2003.03123): directional message passing
(port of ``repro.models.dimenet``), with both of the reference's triplet
paths, on one device or (training: ``forward``/``loss_fn`` with ``mesh=``)
over a mesh of ranks.

Basis (n_radial x n_spherical = 6 x 7 = 42 at the published width):
    basis(t=(k,j,i)) = rbf(d_kj) (x) P_l(cos theta_kji),   l = 0..L-1
with rbf_n(d) = sqrt(2/c) sin(n pi d / c) / d (DimeNet's Bessel radial
basis) and P_l the Legendre polynomials.

Triplet paths:
  * "gather"     -- the paper's: per triplet, gather the source edge's
                    message, combine it with the basis and add it into the
                    target edge (``index_add_``).
  * "factorized" -- P_l(u.v) expands through monomial features phi_p with
                    (u.v)^p = <phi_p(u), phi_p(v)> exactly, so the triplet
                    sum becomes (A) an edge -> node sum of
                    x_kj (x) rbf_kj (x) phi(u_kj) into an (N, nb R W) buffer
                    and (B) a node -> edge gather contracted with phi(u_ji):
                    O(E), no triplet arrays.

Parameters are the reference's tree (``node_in.w``, ``edge_in.w``,
``blocks.*`` stacked (B, ...), ``out_node.w``, ``out_final.w``); a forward
splits the stack once with ``unbind``, so gradients reach the stacked
leaves. ``param_axes`` replicates every leaf, as the reference's.

On a mesh: the edges (each chunk's ``ce``) split over ``data`` and the
triplets over (data, model); nodes and params are whole on every rank
(``distributed/fsdp.py`` sums the params' gradients). The factorized path
splits the node buffer's width over ``model`` (its ``n_bilinear`` channels:
rank j holds channels j nb/M onwards): pass A adds this rank's edges into
its width slice, psummed over ``data``; pass B contracts the slice on this
rank's edges and the channels are all-gathered over ``model``. The gather
path gathers the edges' messages over ``data``, adds this rank's triplets
into every edge, and reduce-scatters them back to the edges' ranks (summed
over ``model``). The edges' outputs into the nodes are psummed over
``data``, so every rank then computes the same node outputs and loss, and
differentiates 1 / N of it.

Sum orders (the contractions are written as broadcasts and reductions, not
as cuBLAS calls, so an edge's value does not depend on how the edges are
chunked):
  * pass A: contrib = (x_nb (x) rbf) (x) phi, each product rounded to the
    compute dtype, as the reference's pairwise einsum, added into the node
    buffer with ``index_put_(accumulate=True)``: on the CPU one by one in
    edge order, as the reference's ``.at[].add``; on the card each node's
    contributions (sorted by node, in edge order) summed in f32, then added
    once;
  * pass B: each degree block's <g, phi> is an f32 sum over its monomials of
    products in the compute dtype (exact in f32; in bf16 the reference's
    dot keeps the products in f32), rounded to the compute dtype; the
    Legendre matrix is an f32 sum over p; the basis-weight contraction an
    f32 sum over (r, l);
  * the other scatters (the gather path's ``agg``, the node outputs, the
    ``graph_reg`` pooling) are ``index_add_`` in the compute dtype. On the
    CPU they add in index order; on the card in bf16 they are atomics in no
    fixed order, so the card's bf16 result is not bitwise reproducible.

Dtypes as the reference: positions, unit vectors and rbf in f32; x, phi
and the products in ``compute_dtype``; the outputs cast to f32.

Remat: with ``cfg.remat`` and grad on, each interaction block runs under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` (the
reference's ``jax.checkpoint(nothing_saveable)``). Passes A and B are
each one autograd Function over the edge chunks that saves its inputs only
and recomputes a chunk's intermediates in its backward, so the backward
holds one chunk's intermediates and one node-buffer gradient at a time.
Neither changes a value.
"""
from __future__ import annotations

import dataclasses
import math
from math import factorial
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.distributed import comm, fsdp
from repro_torch.distributed import sharding as sh
from repro_torch.models import nn


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    d_feat: int = 128           # input node-feature width
    n_out: int = 1              # classes (node task) or 1 (graph regression)
    task: str = "graph_reg"     # "graph_reg" | "node_class"
    triplet_impl: str = "gather"   # "gather" | "factorized"
    edge_chunks: int = 1        # factorized path: edges streamed in this many chunks
    remat: bool = True          # checkpoint each interaction block
    compute_dtype: Any = torch.bfloat16


# ------------------------------------------------------------------- bases
def _legendre_coeffs(l_max: int) -> np.ndarray:
    """(l_max, l_max) matrix C with P_l(x) = sum_p C[l, p] x^p."""
    c = np.zeros((l_max, l_max))
    for l in range(l_max):
        coefs = np.polynomial.legendre.leg2poly([0.0] * l + [1.0])
        c[l, : len(coefs)] = coefs
    return c


def _monomial_exponents(p_max: int) -> list[list[tuple[int, int, int]]]:
    out = []
    for p in range(p_max):
        out.append([(a, b, p - a - b) for a in range(p + 1) for b in range(p + 1 - a)])
    return out


def _ipow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x ** n for an int n >= 0 by binary exponentiation (``lax.integer_pow``'s
    products, so the bits are the reference's)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return torch.ones_like(x) if acc is None else acc


def monomial_features(u: torch.Tensor, p_max: int) -> torch.Tensor:
    """u: (..., 3) unit vectors -> (..., W), W = sum_p C(p+2, 2), such that
    <phi(u), phi(v)> restricted to the degree-p block equals (u.v)^p."""
    feats = []
    for p, exps in enumerate(_monomial_exponents(p_max)):
        for (a, b, cc) in exps:
            w = factorial(p) / (factorial(a) * factorial(b) * factorial(cc))
            sw = torch.tensor(math.sqrt(w), dtype=u.dtype, device=u.device)
            feats.append(sw * _ipow(u[..., 0], a) * _ipow(u[..., 1], b) * _ipow(u[..., 2], cc))
    return torch.stack(feats, dim=-1)


def _monomial_block_slices(p_max: int) -> list[slice]:
    sl, off = [], 0
    for exps in _monomial_exponents(p_max):
        sl.append(slice(off, off + len(exps)))
        off += len(exps)
    return sl


def bessel_rbf(d: torch.Tensor, n_radial: int, cutoff: float) -> torch.Tensor:
    """DimeNet's radial basis sqrt(2/c) sin(n pi d / c) / d (f32), zero past
    the cutoff; d is clamped at 1e-6."""
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)
    d = torch.clamp(d, min=1e-6)[..., None]
    scale = torch.sqrt(torch.tensor(2.0 / cutoff, dtype=torch.float32, device=d.device))
    rbf = scale * torch.sin(n * math.pi * d / cutoff) / d
    return torch.where(d <= cutoff, rbf, 0.0)


def legendre_angular(cos_t: torch.Tensor, l_max: int) -> torch.Tensor:
    """P_l(cos theta) for l = 0..l_max-1 by the recurrence."""
    outs = [torch.ones_like(cos_t), cos_t]
    for l in range(2, l_max):
        outs.append(((2 * l - 1) * cos_t * outs[-1] - (l - 1) * outs[-2]) / l)
    return torch.stack(outs[:l_max], dim=-1)


# --------------------------------------------------------------------- init
def param_table(cfg: DimeNetConfig) -> dict:
    """The params tree with ``(shape, init scale)`` leaves: the reference's
    shapes and N(0, 1) scales."""
    h, nb, B = cfg.d_hidden, cfg.n_bilinear, cfg.n_blocks
    s = 1.0 / math.sqrt(h)
    d_edge = 2 * h + cfg.n_radial
    return {
        "node_in": {"w": ((cfg.d_feat, h), 1.0 / math.sqrt(cfg.d_feat))},
        "edge_in": {"w": ((d_edge, h), 1.0 / math.sqrt(d_edge))},
        "blocks": {
            "w_src": ((B, h, nb), s),                                   # project x_kj
            "w_sbf": ((B, cfg.n_radial * cfg.n_spherical, nb), 1.0),    # basis weights
            "w_bil": ((B, nb, h), 1.0 / math.sqrt(nb)),
            "w_self": ((B, h, h), s),
            "w_rbf": ((B, cfg.n_radial, h), 1.0),
            "w_out1": ((B, h, h), s),
            "w_out2": ((B, h, h), s),
        },
        "out_node": {"w": ((h, h), s)},
        "out_final": {"w": ((h, cfg.n_out), s)},
    }


def param_axes(cfg: DimeNetConfig) -> dict:
    """The params' logical axes: every leaf replicated (the stacked blocks
    on ``layers``)."""
    return {k: {n: ("layers",) + (None,) * (len(v[0]) - 1) for n, v in sub.items()}
            if k == "blocks" else {n: (None,) * len(v[0]) for n, v in sub.items()}
            for k, sub in param_table(cfg).items()}


def init(generator: torch.Generator | None, cfg: DimeNetConfig,
         device: str | torch.device = "cuda") -> dict:
    """Random f32 parameters with the reference's shapes and scales, drawn
    from ``generator`` (on ``device``) leaf by leaf in sorted-key order.
    ``device="meta"`` with no generator gives the shapes, allocating
    nothing."""
    dev = resolve_device(device)

    def walk(table):
        return {k: walk(v) if isinstance(v, dict) else
                torch.randn(v[0], generator=generator, device=dev).mul_(v[1])
                for k, v in sorted(table.items())}

    return walk(param_table(cfg))


# ------------------------------------------------------------- triplet core
def _pass_b_chunk(buf, sc, pc, x_rev, rbf_rev, legf, sign, w_t, sl):
    """One edge chunk of pass B: gather the node buffer at the chunk's
    sources, contract each degree block with phi(u_ji) (products in the
    compute dtype, an f32 sum over the block's monomials), apply the
    Legendre matrix (an f32 sum over p), subtract the k == i term if asked.
    Returns (g (ce, nb, R, W), pl (ce, nb, R, L)) in the buffer's dtype; the
    basis-weight contraction is the caller's."""
    ce = sc.shape[0]
    nb, n_radial, _ = w_t.shape
    dt = buf.dtype
    g = buf[sc].reshape(ce, nb, n_radial, pc.shape[-1])
    q = g * pc[:, None, None, :]
    powers = torch.stack([q[..., s].sum(-1, dtype=torch.float32) for s in sl]).to(dt)
    # (P, ce, nb, R): each block's powers contiguous; pl an f32 sum over p
    pl = (powers.float()[..., None] * legf.T[:, None, None, None, :]).sum(0).to(dt)
    if x_rev is not None:
        pl = pl - (x_rev[:, :, None, None] * rbf_rev[:, None, :, None]) * sign
    return g, pl


class _PassA(torch.autograd.Function):
    """Pass A over every edge chunk: the node buffer (N, nb R W) =
    sum over the edges into each node of x_nb (x) rbf (x) phi, one chunk's
    (ce, nb R W) contribution at a time, added in edge order.

    The scatter is ``index_put_(accumulate=True)``: on the card it sorts the
    chunk's destinations and sums each node's contributions in f32 before
    one add into the buffer (no per-element atomics; a node's contributions
    in edge order); on the CPU it adds them one by one in edge order.
    Saved: the inputs only (autograd's ``index_add_`` keeps each chunk's
    whole contribution for its backward: 8 KB an edge at the published
    width, every chunk of a block at once under remat's recompute). The
    backward gathers the buffer's gradient at each chunk's destinations and
    contracts it with phi, then with rbf: the cotangent's products in the
    compute dtype, each sum in f32, as autograd's of the same
    expressions."""

    @staticmethod
    def forward(ctx, x_nb, rbf_w, phi, dst, n_nodes):
        ctx.save_for_backward(x_nb, rbf_w, phi, dst)
        cch, ce, nb = x_nb.shape
        width = nb * rbf_w.shape[-1] * phi.shape[-1]
        buf = torch.zeros((n_nodes, width), dtype=x_nb.dtype, device=x_nb.device)
        for c in range(cch):
            xr = x_nb[c][:, :, None] * rbf_w[c][:, None, :]               # (ce, nb, R)
            buf.index_put_((dst[c],), (xr[..., None] * phi[c][:, None, None, :]).reshape(ce, width),
                           accumulate=True)
        return buf

    @staticmethod
    def backward(ctx, d_buf):
        x_nb, rbf_w, phi, dst = ctx.saved_tensors
        cch, ce, nb = x_nb.shape
        n_radial, wphi = rbf_w.shape[-1], phi.shape[-1]
        d_x = torch.empty_like(x_nb)
        for c in range(cch):
            dc = d_buf[dst[c]].reshape(ce, nb, n_radial, wphi)
            d_xr = (dc * phi[c][:, None, None, :]).sum(-1, dtype=torch.float32)   # (ce, nb, R)
            d_x[c] = (d_xr.to(x_nb.dtype) * rbf_w[c][:, None, :]).sum(-1, dtype=torch.float32) \
                .to(x_nb.dtype)
        return d_x, None, None, None, None


class _PassB(torch.autograd.Function):
    """Pass B over every edge chunk: agg (C, ce, nb) = sum_{r,l} pl * w_t
    per edge (an f32 sum, rounded to the buffer's dtype).

    The backward recomputes each chunk's intermediates and adds every
    chunk's node-buffer gradient into one (N, nb R W) tensor: autograd's own
    backward of ``buf[src]`` would allocate a whole zero buffer a chunk
    (19.7 GB each at ogb_products' nodes). Saved: the inputs only. The
    gradients are autograd's of the same expressions: each product's
    cotangent in f32, rounded to the compute dtype where the forward
    rounded; the basis weights' summed over the chunks' edges in f32."""

    @staticmethod
    def forward(ctx, buf, src, phi, x_rev, rbf_rev, w_t, leg, sign, sl):
        ctx.save_for_backward(buf, src, phi, x_rev, rbf_rev, w_t, leg, sign)
        ctx.sl = sl
        legf, wf = leg.float(), w_t.float()
        out = []
        for c in range(src.shape[0]):
            _, pl = _pass_b_chunk(buf, src[c], phi[c], None if x_rev is None else x_rev[c],
                                  None if rbf_rev is None else rbf_rev[c], legf, sign, w_t, sl)
            out.append((pl.float() * wf).sum((-2, -1)).to(buf.dtype))
        return torch.stack(out)

    @staticmethod
    def backward(ctx, d_agg):
        buf, src, phi, x_rev, rbf_rev, w_t, leg, sign = ctx.saved_tensors
        sl = ctx.sl
        dt = buf.dtype
        need_buf, need_rev, need_w = (ctx.needs_input_grad[i] for i in (0, 3, 5))
        d_buf = torch.zeros_like(buf) if need_buf else None
        d_rev = torch.zeros_like(x_rev) if need_rev else None
        d_w = torch.zeros(w_t.shape, dtype=torch.float32, device=w_t.device) if need_w else None
        legf, wf = leg.float(), w_t.float()
        blk = torch.tensor([p for p, s in enumerate(sl) for _ in range(s.stop - s.start)],
                           device=buf.device)            # monomial -> its degree block
        for c in range(src.shape[0]):
            xr = None if x_rev is None else x_rev[c]
            rr = None if rbf_rev is None else rbf_rev[c]
            g, pl = _pass_b_chunk(buf, src[c], phi[c], xr, rr, legf, sign, w_t, sl)
            da = d_agg[c].float()[:, :, None, None]                       # (ce, nb, 1, 1)
            if need_w:
                d_w += (da * pl.float()).sum(0)
            d_pl = (da * wf).to(dt)                                       # (ce, nb, R, L)
            if need_rev:
                dq = (-(d_pl * sign)).sum(-1)                             # (ce, nb, R)
                d_rev[c] = (dq * rr[:, None, :]).sum(-1)
            if need_buf:
                d_pw = (d_pl.float()[..., None] * legf).sum(-2).to(dt)      # (ce, nb, R, P)
                d_g = d_pw.index_select(-1, blk) * phi[c][:, None, None, :]
                d_buf.index_put_((src[c],), d_g.reshape(src.shape[1], -1), accumulate=True)
        return (d_buf, None, None, d_rev, None, None if d_w is None else d_w.to(dt),
                None, None, None)


def _factorized_block(x_nb, rbf, phi, w_sbf, edge_src, edge_dst, edge_mask, n_nodes,
                      cfg: DimeNetConfig, edge_reverse=None, mesh=None):
    """Factorized triplet aggregation of one interaction block: for every
    edge ji,
        agg_ji = sum_{k in N(j)} x_kj *_nb [w_sbf . (rbf_kj (x) P_l(u_kj . u_ji))]
    through the monomial factorization. With ``edge_reverse`` (the edge id
    of each edge's reverse, -1 for none) the k == i backtracking triplet is
    subtracted exactly: P_l(-1) = (-1)^l. Edge arrays arrive (C, ce, ...)
    and are streamed chunk by chunk: one (ce, nb R W) contribution exists
    at a time. Returns (C, ce, nb). On a ``mesh`` the edges are this rank's
    (``edge_reverse`` holds global edge ids) and the width is split over
    ``model`` (module docstring)."""
    cch, ce, nb = x_nb.shape
    n_radial, l_max = cfg.n_radial, cfg.n_spherical
    x_nb = x_nb * edge_mask[..., None]
    dt, dev = x_nb.dtype, x_nb.device
    rbf_w = rbf.to(dt)
    w_t = w_sbf.reshape(n_radial, l_max, nb).to(dt).permute(2, 0, 1)   # (nb, R, L)
    leg = torch.tensor(_legendre_coeffs(l_max), dtype=dt, device=dev)
    sign = torch.tensor([(-1.0) ** l for l in range(l_max)], dtype=dt, device=dev)
    x_all, rbf_all = x_nb, rbf_w               # every edge's (for the reverse ids)
    if mesh is not None:
        data, width = sh.mesh_axes(mesh, "edges"), sh.mesh_axes(mesh, "d_ff")
        if edge_reverse is not None:
            x_all = comm.all_gather(x_nb, mesh, data, dim=1)
            rbf_all = comm.all_gather(rbf_w, mesh, data, dim=1)
        nbw = nb // sh.axis_count(mesh, "d_ff")
        if nbw * sh.axis_count(mesh, "d_ff") != nb:
            raise ValueError(f"n_bilinear {nb} does not split over {width}")
        lo = sh.index_along(mesh, width) * nbw
        chan = slice(lo, lo + nbw)
        x_nb, x_all, w_t = x_nb[..., chan], x_all[..., chan], w_t[chan]

    # pass A: node buffer A[j] = sum_{kj} x_kj (x) rbf_kj (x) phi(u_kj)
    buf = _PassA.apply(x_nb, rbf_w, phi, edge_dst, n_nodes)
    if mesh is not None:
        buf = comm.psum(buf, mesh, data)

    # pass B: per edge ji gather A[src] and contract with phi(u_ji)
    x_rev = rbf_rev = None
    if edge_reverse is not None:
        rev = edge_reverse.reshape(cch * ce).long()
        rc = torch.clamp(rev, min=0)
        x_rev = (x_all.reshape(-1, x_nb.shape[-1])[rc] * (rev >= 0).to(dt)[:, None]
                 ).reshape(cch, ce, -1)
        rbf_rev = rbf_all.reshape(-1, n_radial)[rc].reshape(cch, ce, n_radial)
    agg = _PassB.apply(buf, edge_src, phi, x_rev, rbf_rev, w_t, leg, sign,
                       _monomial_block_slices(l_max))
    if mesh is not None:
        agg = comm.all_gather(agg, mesh, width, dim=-1)
    return agg


# ------------------------------------------------------------------ forward
def _unstack(blocks: dict) -> list[dict]:
    split = {k: w.unbind(0) for k, w in blocks.items()}
    n = len(next(iter(split.values())))
    return [{k: split[k][i] for k in split} for i in range(n)]


def forward(params, batch, cfg: DimeNetConfig, mesh=None) -> torch.Tensor:
    """batch keys: node_feat (N, F), pos (N, 3), edge_src/edge_dst (E,) or
    (C, ce) pre-chunked, edge_mask likewise, [edge_reverse like edge_src],
    [triplet_kj/triplet_ji/triplet_mask (T,) for "gather"], [graph_ids (N,),
    labels (G,), node_mask (N,) for "graph_reg"]. Returns (G, n_out) f32
    for "graph_reg", (N, n_out) f32 node logits otherwise. On a ``mesh``
    the edge and triplet arrays are this rank's blocks (edge ids stay
    global) and every rank returns the whole output."""
    dt = cfg.compute_dtype
    if mesh is not None:
        params = sh.tree_map_axes(lambda t, ax, name: fsdp.use(t, mesh, ax), params,
                                  param_axes(cfg))
        data = sh.mesh_axes(mesh, "edges")
    pos = batch["pos"].float()
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    emask = batch["edge_mask"].to(dt)
    if src.dim() == 1:
        src, dst, emask = src[None], dst[None], emask[None]
    n_nodes = batch["node_feat"].shape[0]
    cch, ce = src.shape
    n_edges = cch * ce
    h = cfg.d_hidden
    dev = pos.device

    h_n = nn.dense(params["node_in"], batch["node_feat"], dt)            # (N, h)
    vec = pos[dst] - pos[src]                                            # (C, ce, 3)
    d = torch.sqrt(torch.clamp(torch.sum(vec * vec, dim=-1), min=1e-12))
    u = (vec / d[..., None]).float()                                     # unit kj direction
    rbf = bessel_rbf(d, cfg.n_radial, cfg.cutoff)                        # (C, ce, R)
    x = nn.dense(params["edge_in"], torch.cat([h_n[src], h_n[dst], rbf.to(dt)], dim=-1),
                 dt) * emask[..., None]                                  # (C, ce, h)

    gather = cfg.triplet_impl == "gather"
    if gather:
        t_kj, t_ji = batch["triplet_kj"].long(), batch["triplet_ji"].long()
        t_mask = batch["triplet_mask"].to(dt)
        u_all, rbf_all = u, rbf
        if mesh is not None:                # the triplets' edges may be anyone's
            u_all = comm.all_gather(u, mesh, data, dim=1)
            rbf_all = comm.all_gather(rbf, mesh, data, dim=1)
        u_flat = u_all.reshape(-1, 3)
        rbf_flat = rbf_all.reshape(u_flat.shape[0], -1)
        cos_t = torch.sum(u_flat[t_kj] * u_flat[t_ji], dim=-1)
        ang = legendre_angular(cos_t, cfg.n_spherical)                   # (T, L)
        basis = (rbf_flat[t_kj][:, :, None] * ang[:, None, :]).reshape(t_kj.shape[0], -1).to(dt)
    elif cfg.triplet_impl == "factorized":
        phi = monomial_features(u, cfg.n_spherical).to(dt)               # (C, ce, W)
        edge_reverse = batch.get("edge_reverse")
    else:
        raise ValueError(f"triplet_impl {cfg.triplet_impl!r}")
    dst_flat = dst.reshape(-1)
    rbf_dt = rbf.to(dt)

    def block(x, node_out, bp):
        x_nb = x @ bp["w_src"].to(dt)                                    # (C, ce, nb)
        if gather:
            bw = basis @ bp["w_sbf"].to(dt)                              # (T, nb)
            x_all = x_nb if mesh is None else comm.all_gather(x_nb, mesh, data, dim=1)
            x_nb_flat = x_all.reshape(-1, x_nb.shape[-1])
            agg = torch.zeros(x_nb_flat.shape, dtype=dt, device=dev).index_add_(
                0, t_ji, x_nb_flat[t_kj] * bw * t_mask[:, None]).reshape(x_all.shape)
            if mesh is not None:
                agg = comm.reduce_scatter(agg, mesh, data, dim=1)
                agg = comm.psum(agg, mesh, tuple(a for a in mesh.axis_names if a not in data))
        else:
            agg = _factorized_block(x_nb, rbf, phi, bp["w_sbf"], src, dst, emask, n_nodes,
                                    cfg, edge_reverse=edge_reverse, mesh=mesh)
        upd = agg @ bp["w_bil"].to(dt)                                   # (C, ce, h)
        x = F.silu(x @ bp["w_self"].to(dt) + (rbf_dt @ bp["w_rbf"].to(dt)) * x + upd) \
            * emask[..., None]
        # output block: edges -> dst nodes
        n_part = torch.zeros((n_nodes, h), dtype=dt, device=dev).index_add_(
            0, dst_flat, F.silu(x @ bp["w_out1"].to(dt)).reshape(n_edges, h))
        if mesh is not None:
            n_part = comm.psum(n_part, mesh, data)
        return x, node_out + n_part @ bp["w_out2"].to(dt)

    node_out = torch.zeros((n_nodes, h), dtype=dt, device=dev)
    ck = cfg.remat and torch.is_grad_enabled()
    for bp in _unstack(params["blocks"]):
        x, node_out = checkpoint(block, x, node_out, bp, use_reentrant=False) if ck else \
            block(x, node_out, bp)
    node_h = F.silu(nn.dense(params["out_node"], node_out, dt))
    out = nn.dense(params["out_final"], node_h, dt)                      # (N, n_out)

    if cfg.task == "graph_reg":
        n_graphs = batch["labels"].shape[0]      # labels are per graph
        mask = batch.get("node_mask")
        if mask is not None:                     # the product in f32, rounded on the add
            out = (out.float() * mask.float()[:, None]).to(dt)
        pooled = torch.zeros((n_graphs, cfg.n_out), dtype=dt, device=dev).index_add_(
            0, batch["graph_ids"].long(), out)
        return pooled.float()
    return out.float()                                                   # node logits


def loss_fn(params, batch, cfg: DimeNetConfig, mesh=None) -> torch.Tensor:
    """``graph_reg``: mean squared error against the per-graph labels;
    ``node_class``: the mean over ``label_mask`` (default all ones) of the
    gold class's negative log-softmax. On a ``mesh`` every rank computes the
    whole loss and differentiates 1 / N of it."""
    out = forward(params, batch, cfg, mesh)
    if cfg.task == "graph_reg":
        loss = torch.mean((out[:, 0] - batch["labels"].float()) ** 2)
    else:
        mask = batch.get("label_mask")
        mask = torch.ones(out.shape[0], device=out.device) if mask is None else mask.float()
        logp = F.log_softmax(out, dim=-1)
        gold = torch.gather(logp, -1, batch["labels"][:, None].long())[:, 0]
        loss = -torch.sum(gold * mask) / torch.clamp(torch.sum(mask), min=1.0)
    if mesh is None:
        return loss
    return fsdp.objective(loss, loss / math.prod(mesh.shape.values()))
