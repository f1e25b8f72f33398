"""Quantization config, codecs and the shared decode-and-score math (port of
``repro.quant.quantization``).

int8 (scalar, per-dim asymmetric)
    ``codes (n, d) int8`` + ``scale (d,) f32`` + ``zero (d,) f32``;
    ``x_hat = codes * scale + zero``, in exactly that order (multiply, then
    add, two roundings: the CUDA kernels decode with ``__fmul_rn`` and
    ``__fadd_rn`` so the compiler cannot contract them into one FMA).

pq (product quantization)
    ``d`` split into ``m`` subspaces; each row stored as ``m`` uint8 indices
    into per-subspace codebooks ``(m, 256, d/m) f32`` trained by seeded Lloyd
    iterations. Scoring gathers from a per-query table of query-to-centroid
    partial scores (:func:`pq_lut`, once per query tile).

Memory: the reference forms ``(n, m, 256)`` f32 distance blocks in encode
and in the Lloyd assignment (32.8 GB at n = 1M, m = 32) and a ``(n, 256)``
one-hot per subspace for the centroid sums. Here both run over row blocks of
``ROWS_PER_BLOCK`` and the sums are an ``index_add_`` over the assignment,
accumulated in float64 so that the f32 centroids do not depend on the order
in which CUDA's atomics add (short of a sum landing exactly on an f32
rounding boundary).

Quantized distances are approximations; searches over codes finish with an
exact-f32 rerank tail (``Quantization.rerank_k``) in ``core/search.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.kernels.beam_score.ref import lane_sum, score_block

MODES = ("f32", "bf16", "int8", "pq")
PQ_CENTROIDS = 256
ROWS_PER_BLOCK = 16384    # rows per (rows, m, 256) distance block: 512 MiB at m = 32

# int8 code range is symmetric [-127, 127] (254 steps): -128 stays unused,
# so |decode error| <= scale / 2 uniformly.
_INT8_STEPS = 254.0
_INT8_HALF = 127.0


@dataclasses.dataclass(frozen=True)
class Quantization:
    """How the corpus is stored and scored.

    ``mode``: ``"f32"``, ``"bf16"`` (half-width gathers, the ``gram_dtype``
    path), ``"int8"`` or ``"pq"``. ``m``: PQ subspace count (``d % m == 0``).
    ``pq_iters`` / ``pq_seed``: Lloyd iterations and the seed of the centroid
    init. ``rerank_k``: width of the exact-f32 rerank tail of coded searches
    (0 disables; otherwise at least the search's ``topk``)."""

    mode: str = "f32"
    m: int = 16
    pq_iters: int = 8
    pq_seed: int = 0
    rerank_k: int = 64

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"quant.mode {self.mode!r} not in {MODES}")
        if self.m < 1:
            raise ValueError(f"quant.m must be >= 1, got {self.m}")
        if self.pq_iters < 1:
            raise ValueError(f"quant.pq_iters must be >= 1, got {self.pq_iters}")
        if self.rerank_k < 0:
            raise ValueError(f"quant.rerank_k must be >= 0, got {self.rerank_k}")

    @property
    def is_coded(self) -> bool:
        """True when the corpus is stored as codes (int8 / pq)."""
        return self.mode in ("int8", "pq")


class QuantizedCorpus(NamedTuple):
    """The coded corpus. int8: ``codes (n, d) int8``, ``scale (d,)``,
    ``zero (d,)`` f32. pq: ``codes (n, m) uint8``, ``codebooks (m, 256,
    d/m) f32``. Unused fields are ``None``."""

    codes: Any
    scale: Any = None
    zero: Any = None
    codebooks: Any = None

    @property
    def mode(self) -> str:
        return "pq" if self.codebooks is not None else "int8"


# ----------------------------------------------------------------- int8 codec
def encode_int8_rows(x: torch.Tensor, scale: torch.Tensor,
                     zero: torch.Tensor) -> torch.Tensor:
    """Encode rows against frozen ``scale``/``zero`` (round half to even,
    as ``jnp.round``)."""
    q = torch.round((x.float() - zero) / scale)
    return torch.clamp(q, -_INT8_HALF, _INT8_HALF).to(torch.int8)


def quantize_int8(x: torch.Tensor, valid: torch.Tensor | None = None) -> QuantizedCorpus:
    """Per-dim asymmetric int8: range from the (optionally masked) rows,
    codes for every row."""
    xf = x.float()
    if valid is None:
        lo = xf.amin(dim=0)
        hi = xf.amax(dim=0)
    else:
        v = valid.bool()[:, None]
        lo = torch.where(v, xf, float("inf")).amin(dim=0)
        hi = torch.where(v, xf, float("-inf")).amax(dim=0)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    hi = torch.where(torch.isfinite(hi), hi, 0.0)
    scale = torch.clamp(hi - lo, min=1e-8) / _INT8_STEPS
    zero = lo + _INT8_HALF * scale
    return QuantizedCorpus(codes=encode_int8_rows(xf, scale, zero), scale=scale, zero=zero)


def int8_decode(codes: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """``(..., d) int8 -> (..., d) f32``. Elementwise, so it commutes with row
    gathers."""
    return codes.float() * scale + zero


# ------------------------------------------------------------------- pq codec
def _check_pq_split(d: int, m: int) -> int:
    if d % m != 0:
        raise ValueError(f"pq requires d % m == 0, got d={d}, m={m}")
    return d // m


def _assign_block(xs: torch.Tensor, cb: torch.Tensor, csq: torch.Tensor) -> torch.Tensor:
    """(rows, m, dsub) x (m, 256, dsub) -> (rows, m) nearest-centroid index;
    ``||x||^2`` is constant per row and dropped from the argmin (first
    minimum on ties, as ``jnp.argmin``)."""
    dot = torch.einsum("nmd,mcd->nmc", xs, cb)
    return torch.argmin(csq[None] - 2.0 * dot, dim=2)


def pq_init(x: torch.Tensor, m: int, seed: int = 0) -> torch.Tensor:
    """Initial codebooks (m, 256, d/m): the rows ``perm[i % n]`` of a seeded
    permutation (torch's random numbers; distinct rows when n >= 256)."""
    n, d = x.shape
    dsub = _check_pq_split(d, m)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    perm = torch.randperm(n, generator=gen, device=x.device)
    idx = perm[torch.arange(PQ_CENTROIDS, device=x.device) % n]
    return x.float()[idx].reshape(PQ_CENTROIDS, m, dsub).transpose(0, 1).contiguous()


def pq_lloyd(x: torch.Tensor, cents: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` Lloyd steps per subspace from the codebooks ``cents``
    (m, 256, d/m). An empty cluster keeps its centroid."""
    n, d = x.shape
    m, kc, dsub = cents.shape
    _check_pq_split(d, m)
    xs = x.float().reshape(n, m, dsub)
    base = torch.arange(m, device=x.device) * kc
    for _ in range(iters):
        csq = torch.einsum("mcd,mcd->mc", cents, cents)
        sums = torch.zeros((m * kc, dsub), dtype=torch.float64, device=x.device)
        counts = torch.zeros((m * kc,), dtype=torch.float64, device=x.device)
        for s in range(0, n, ROWS_PER_BLOCK):
            blk = xs[s:s + ROWS_PER_BLOCK]
            idx = (_assign_block(blk, cents, csq) + base).reshape(-1)
            sums.index_add_(0, idx, blk.reshape(-1, dsub).double())
            counts += torch.bincount(idx, minlength=m * kc)
        counts = counts.view(m, kc, 1)
        mean = (sums.view(m, kc, dsub) / counts.clamp(min=1.0)).float()
        cents = torch.where(counts > 0, mean, cents)
    return cents


def train_pq(x: torch.Tensor, m: int, iters: int = 8, seed: int = 0) -> torch.Tensor:
    """Seeded Lloyd k-means per subspace -> codebooks (m, 256, d/m) f32."""
    return pq_lloyd(x, pq_init(x, m, seed), iters)


def encode_pq_rows(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(n, d) f32 x (m, 256, d/m) -> (n, m) uint8 nearest-centroid codes."""
    n, d = x.shape
    m, _, dsub = codebooks.shape
    _check_pq_split(d, m)
    cb = codebooks.float()
    csq = torch.einsum("mcd,mcd->mc", cb, cb)
    xs = x.float().reshape(n, m, dsub)
    out = torch.empty((n, m), dtype=torch.uint8, device=x.device)
    for s in range(0, n, ROWS_PER_BLOCK):
        out[s:s + ROWS_PER_BLOCK] = _assign_block(xs[s:s + ROWS_PER_BLOCK], cb, csq)
    return out


def decode_pq(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(..., m) uint8 -> (..., d) f32 centroid reconstruction."""
    m, _, dsub = codebooks.shape
    sub = codebooks[torch.arange(m, device=codes.device), codes.long()]  # (..., m, dsub)
    return sub.reshape(codes.shape[:-1] + (m * dsub,))


# ------------------------------------------------------- corpus-level helpers
def encode_corpus(x: torch.Tensor, quant: Quantization,
                  train_rows: torch.Tensor | None = None) -> QuantizedCorpus | None:
    """Encode the whole corpus under ``quant``; ``train_rows`` optionally
    restricts the range / codebook training to a row subset. ``None`` for
    the uncoded modes."""
    if quant.mode == "int8":
        if train_rows is None:
            return quantize_int8(x)
        ref = quantize_int8(train_rows)
        return QuantizedCorpus(codes=encode_int8_rows(x, ref.scale, ref.zero),
                               scale=ref.scale, zero=ref.zero)
    if quant.mode == "pq":
        cb = train_pq(x if train_rows is None else train_rows, quant.m, quant.pq_iters,
                      quant.pq_seed)
        return QuantizedCorpus(codes=encode_pq_rows(x, cb), codebooks=cb)
    return None


def encode_rows(x_new: torch.Tensor, qx: QuantizedCorpus) -> torch.Tensor:
    """Encode new rows into an existing code space."""
    if qx.mode == "int8":
        return encode_int8_rows(x_new, qx.scale, qx.zero)
    return encode_pq_rows(x_new, qx.codebooks)


def dequantize(qx: QuantizedCorpus) -> torch.Tensor:
    """Full decoded corpus ``x_hat`` (n, d) f32."""
    if qx.mode == "int8":
        return int8_decode(qx.codes, qx.scale, qx.zero)
    return decode_pq(qx.codes, qx.codebooks)


def prep_corpus(x: torch.Tensor, quant: Quantization
                ) -> tuple[torch.Tensor, QuantizedCorpus | None]:
    """Build-time corpus prep. Coded modes encode once and return ``(x_hat,
    qx)``: the graph is built over the decoded corpus, the geometry the coded
    search traverses. ``qx`` is returned only for int8, whose prune gathers
    code rows; PQ prunes over ``x_hat`` (symmetric code-to-code distances
    would double the quantization noise inside the RNG inequality).
    f32/bf16 pass through."""
    if not quant.is_coded:
        return x, None
    qx = encode_corpus(x, quant)
    return dequantize(qx), (qx if quant.mode == "int8" else None)


def corpus_bytes(qx: QuantizedCorpus | None, n: int, d: int) -> dict:
    """Per-row payload (codes) against the ``n*d*4`` f32 baseline, with the
    O(1) auxiliary parameters (scale/zero/codebooks) counted apart."""
    f32 = n * d * 4
    if qx is None:
        return {"f32_bytes": f32, "codes_bytes": f32, "aux_bytes": 0, "payload_ratio": 1.0}
    codes = qx.codes.numel() * qx.codes.element_size()
    aux = sum(a.numel() * a.element_size()
              for a in (qx.scale, qx.zero, qx.codebooks) if a is not None)
    return {"f32_bytes": f32, "codes_bytes": codes, "aux_bytes": aux,
            "payload_ratio": f32 / codes}


# ------------------------------------------------- shared decode+score math
def int8_score_block(codes: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                     q: torch.Tensor, metric: str) -> torch.Tensor:
    """(..., K, d) int8 code block x (..., d) queries -> (..., K) f32: decode
    (multiply, then add) and :func:`score_block`. No reassociated form (such
    as folding ``scale`` into the query for ip): the kernels decode in this
    order."""
    return score_block(int8_decode(codes, scale, zero), q.float(), metric)


def pq_lut(queries: torch.Tensor, codebooks: torch.Tensor, metric: str
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-query lookup tables ``(lut_a (B, m, 256), lut_b (m, 256), qsq
    (B,))``: l2 ``lut_a = max(|q_s|^2 + |C_sc|^2 - 2 q_s.C_sc, 0)``; ip
    ``lut_a = -q_s.C_sc``; cos ``lut_a`` the raw dots, ``lut_b = |C_sc|^2``,
    ``qsq = |q|^2``."""
    bsz = queries.shape[0]
    m, _, dsub = codebooks.shape
    qf = queries.float()
    qs = qf.reshape(bsz, m, dsub)
    cb = codebooks.float()
    # a query's tables sum in lane_sum's fixed order, whatever the batch
    dot = lane_sum(qs[:, :, None, :] * cb[None])
    csq = torch.einsum("mcd,mcd->mc", cb, cb)
    zq = torch.zeros((bsz,), dtype=torch.float32, device=queries.device)
    if metric == "l2":
        qsq_s = lane_sum(qs * qs)
        lut_a = torch.clamp(qsq_s[..., None] + csq[None] - 2.0 * dot, min=0.0)
        return lut_a, torch.zeros_like(csq), zq
    if metric == "ip":
        return -dot, torch.zeros_like(csq), zq
    if metric == "cos":
        return dot, csq, lane_sum(qf * qf)
    raise ValueError(f"unknown metric {metric!r}")


def pq_score_codes(codes: torch.Tensor, lut_a: torch.Tensor, lut_b: torch.Tensor,
                   qsq: torch.Tensor, metric: str) -> torch.Tensor:
    """(B, K, m) codes + :func:`pq_lut` tables -> (B, K) f32 distances, by
    gather-and-add; cos normalises with the 1e-12 guards of
    :func:`score_block`."""
    c = codes.long()[..., None]                                   # (B, K, m, 1)
    full = (*codes.shape, lut_a.shape[-1])
    acc = torch.gather(lut_a.unsqueeze(-3).expand(full), -1, c)[..., 0].sum(-1)
    if metric in ("l2", "ip"):
        return acc
    vsq = torch.gather(lut_b.expand(full), -1, c)[..., 0].sum(-1)  # |x_hat|^2
    qn = torch.clamp(torch.sqrt(qsq), min=1e-12)[..., None]
    vn = torch.clamp(torch.sqrt(vsq), min=1e-12)
    return 1.0 - acc / (qn * vn)
