"""Plain per-dimension 8-bit scalar quantization (SQ8), in float64, written
from the codec's published rule and not from the program.

Per dimension j, over every row of the corpus: ``lo_j`` and ``hi_j`` its
least and largest value; ``scale_j = max(hi_j - lo_j, 1e-8) / 254``;
``zero_j = lo_j + 127 scale_j``. A value v encodes to ``round((v - zero_j) /
scale_j)``, halves to even, clamped to [-127, 127] (254 symmetric steps,
-128 unused), and a code c decodes to ``c scale_j + zero_j``.

A program that computes the same rule in float32 rounds ``scale``, ``zero``
and the quotient once more each; a value whose quotient lies within that
rounding of a half step (a tie of the float64 rule) may land on either
neighbouring code. :func:`far_codes` allows that one step and no more.
"""
from __future__ import annotations

import torch

STEPS = 254.0
HALF = 127.0
ROW_BLOCK = 65536


def fit(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(scale, zero), float64 (d,), of the corpus ``x`` (n, d). A least or
    largest value is one of the rows' own, so it is exact in any precision."""
    lo = x.amin(dim=0).double()
    hi = x.amax(dim=0).double()
    scale = (hi - lo).clamp(min=1e-8) / STEPS
    return scale, lo + HALF * scale


def encode(rows: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """int64 codes (m, d) of ``rows`` (m, d)."""
    q = torch.round((rows.double() - zero) / scale)
    return q.clamp(-HALF, HALF).long()


def decode(codes: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """float64 rows (n, d) of ``codes`` (n, d), one block of rows at a time
    (no float64 temporary beyond the result)."""
    out = torch.empty(codes.shape, dtype=torch.float64, device=codes.device)
    for s in range(0, codes.shape[0], ROW_BLOCK):
        out[s:s + ROW_BLOCK] = codes[s:s + ROW_BLOCK].double() * scale + zero
    return out


def far_codes(got: torch.Tensor, want: torch.Tensor) -> int:
    """Entries of ``got`` more than one step from ``want`` (a tie of the rule
    may round to either neighbour; see the module's note)."""
    return int(((got.long() - want.long()).abs() > 1).sum())


def far_rows(codes: torch.Tensor, x: torch.Tensor, rows: torch.Tensor, scale: torch.Tensor,
             zero: torch.Tensor) -> int:
    """:func:`far_codes` of the program's ``codes`` at ``rows`` against the
    encode of those rows of ``x``, one block of rows at a time."""
    return sum(far_codes(codes[r], encode(x[r], scale, zero)) for r in rows.split(ROW_BLOCK))
