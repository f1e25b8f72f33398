"""Fused gather + candidate Gram + RNG prune: wrappers of
``csrc/rng_prune.cu`` (an f32/bf16 corpus, or int8 codes decoded in
registers) and their plain versions.

The kernel reads the corpus by id itself, so one launch covers all rows: the
(rows, M, d) gathered block never exists (64 GiB at n = 1M, M = d = 128).
Rows of up to 128 candidates go to ``csrc/rng_prune.cu``, wider ones (up to
256) to the same kernel's wider instance in ``csrc/rng_prune_wide.cu``.
Its warps take rows from two counters (one per pass: rows of more than 32
candidates, then the rest): the wrapper allocates them, the launch zeroes
them on its stream.
The plain versions gather ``chunk`` rows at a time.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, _build, metric_code
from repro_torch.kernels import spec as K
from repro_torch.kernels.rng_prune.ref import rng_prune_ref

MAX_M_BUILD = 128    # rows csrc/rng_prune.cu takes (RNN-Descent's capacity)
MAX_M = 256          # rows csrc/rng_prune_wide.cu takes (NSG-style's C = 132)
MAX_M_INT8 = 128     # rows rng_prune_int8 takes


def _check(x, ids, dists, flags, dtypes=(torch.float32, torch.bfloat16)):
    if x.dim() != 2 or x.dtype not in dtypes:
        raise ValueError(f"x must be (n, d) of {dtypes}, got {tuple(x.shape)} {x.dtype}")
    if ids.dim() != 2 or ids.dtype != torch.int32:
        raise ValueError(f"ids must be (R, M) int32, got {tuple(ids.shape)} {ids.dtype}")
    if dists.shape != ids.shape or dists.dtype != torch.float32:
        raise ValueError("dists must be float32 with the shape of ids")
    if flags.shape != ids.shape or flags.dtype != torch.uint8:
        raise ValueError("flags must be uint8 with the shape of ids")
    devs = {t.device for t in (x, ids, dists, flags)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must share one device, got {devs}")


def rng_prune(x: torch.Tensor, ids: torch.Tensor, dists: torch.Tensor,
              flags: torch.Tensor | None = None, metric: str = "l2",
              chunk: int = 512):
    """Returns (keep u8, red_w i32, red_d f32), each (R, M).

    ``ids`` rows are distance-sorted candidate lists of R vertices (-1 pad),
    ``dists`` their distances, ``flags`` 1 = "new" (None: all new, plain
    Algorithm 3). Old-old pairs are exempt. ``x`` may be bfloat16 (the gather
    reads half the bytes; the Gram accumulates in f32). On CPU tensors this
    runs :func:`rng_prune_plain`; on CUDA tensors the kernel, which reads an
    id outside [0, n) as padding instead of faulting."""
    if flags is None:
        flags = torch.ones_like(ids, dtype=torch.uint8)
    metric_code(metric)
    _check(x, ids, dists, flags)
    if x.device.type == "cpu":
        return rng_prune_plain(x, ids, dists, flags, metric, chunk)
    return _launch(x, ids, dists, flags, metric)


def rng_prune_plain(x, ids, dists, flags=None, metric: str = "l2", chunk: int = 512):
    """Plain PyTorch version: gather ``chunk`` rows' candidates, f32 Gram,
    scan (:func:`rng_prune_ref`)."""
    if flags is None:
        flags = torch.ones_like(ids, dtype=torch.uint8)
    outs = [rng_prune_ref(ids[s:s + chunk], dists[s:s + chunk], flags[s:s + chunk],
                          x[ids[s:s + chunk].clamp(min=0).long()], metric)
            for s in range(0, max(ids.shape[0], 1), chunk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _launch(x, ids, dists, flags, metric):
    r, m = ids.shape
    n, d = x.shape
    _check_launch(n, r, m)
    x, ids, dists, flags = (t.contiguous() for t in (x, ids, dists, flags))
    keep, red_w, red_d = _outputs(r, m, x.device)
    if r == 0 or m == 0:
        return keep, red_w, red_d
    counter = torch.empty(2, dtype=torch.int32, device=x.device)
    entry = "rng_prune" if m <= MAX_M_BUILD else "rng_prune_wide"
    rc = _build.load(entry, "ppppiiiiiippppp")(
        x.data_ptr(), ids.data_ptr(), dists.data_ptr(), flags.data_ptr(),
        n, d, r, m, metric_code(metric), int(x.dtype == torch.bfloat16),
        counter.data_ptr(), keep.data_ptr(), red_w.data_ptr(), red_d.data_ptr(),
        _build.stream_handle(x.device))
    _build.check(rc, entry)
    LAUNCHES["rng_prune"] += 1
    return keep, red_w, red_d


def _check_int8(codes, scale, zero, ids, dists, flags):
    _check(codes, ids, dists, flags, (torch.int8,))
    d = codes.shape[1]
    for name, t in (("scale", scale), ("zero", zero)):
        if t.shape != (d,) or t.dtype != torch.float32 or t.device != codes.device:
            raise ValueError(f"{name} must be ({d},) float32 on the device of the codes")


def rng_prune_int8(codes: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                   ids: torch.Tensor, dists: torch.Tensor,
                   flags: torch.Tensor | None = None, metric: str = "l2",
                   chunk: int = 512):
    """:func:`rng_prune` over an int8 corpus ``codes`` (n, d) with per-dim
    ``scale``/``zero`` (d,): candidate code rows are decoded after the
    gather (``codes * scale + zero``, two roundings), then the same Gram and
    scan. CPU tensors run :func:`rng_prune_int8_plain`; CUDA tensors the
    kernel, which reads an id outside [0, n) as padding."""
    if flags is None:
        flags = torch.ones_like(ids, dtype=torch.uint8)
    metric_code(metric)
    _check_int8(codes, scale, zero, ids, dists, flags)
    if codes.device.type == "cpu":
        return rng_prune_int8_plain(codes, scale, zero, ids, dists, flags, metric, chunk)
    return _launch_int8(codes, scale, zero, ids, dists, flags, metric)


def rng_prune_int8_plain(codes, scale, zero, ids, dists, flags=None, metric: str = "l2",
                         chunk: int = 512):
    """Plain PyTorch version: gather ``chunk`` rows' code rows, decode,
    f32 Gram, scan."""
    from repro_torch.quant.quantization import int8_decode
    if flags is None:
        flags = torch.ones_like(ids, dtype=torch.uint8)
    outs = []
    for s in range(0, max(ids.shape[0], 1), chunk):
        cid = ids[s:s + chunk]
        vecs = int8_decode(codes[cid.clamp(min=0).long()], scale, zero)
        outs.append(rng_prune_ref(cid, dists[s:s + chunk], flags[s:s + chunk], vecs, metric))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _outputs(r, m, device):
    return (torch.empty((r, m), dtype=torch.uint8, device=device),
            torch.empty((r, m), dtype=torch.int32, device=device),
            torch.empty((r, m), dtype=torch.float32, device=device))


def _check_launch(n, r, m, max_m=MAX_M):
    if m > max_m:
        raise ValueError(f"candidate rows of M={m} exceed the kernel's limit of M <= {max_m}")
    if n >= 2**31 or r >= 2**31:
        raise ValueError("n and R must fit int32")


def _launch_int8(codes, scale, zero, ids, dists, flags, metric):
    r, m = ids.shape
    n, d = codes.shape
    _check_launch(n, r, m, MAX_M_INT8)
    codes, scale, zero, ids, dists, flags = (
        t.contiguous() for t in (codes, scale, zero, ids, dists, flags))
    keep, red_w, red_d = _outputs(r, m, codes.device)
    if r == 0 or m == 0:
        return keep, red_w, red_d
    counter = torch.empty(2, dtype=torch.int32, device=codes.device)
    rc = _build.load("rng_prune_int8", "ppppppiiiiippppp", source="rng_prune")(
        codes.data_ptr(), scale.data_ptr(), zero.data_ptr(), ids.data_ptr(),
        dists.data_ptr(), flags.data_ptr(), n, d, r, m, metric_code(metric),
        counter.data_ptr(), keep.data_ptr(), red_w.data_ptr(), red_d.data_ptr(),
        _build.stream_handle(codes.device))
    _build.check(rc, "rng_prune_int8")
    LAUNCHES["rng_prune_int8"] += 1
    return keep, red_w, red_d


# ------------------------------------------------------------ launch shapes
# csrc/rng_prune.cuh's layout: WARPS warps a block, a row each at a time;
# each warp's shared region holds NSLOT slots of 32 candidates x DC
# elements (f32; bf16 and int8 land raw and widen into two f32 tiles) and
# five 32 NB-word vectors plus one 32 NB-byte vector of the row.
_WARPS, _DC, _NSLOT = 4, 32, 4
_SLOT = 32 * _DC
_ITEMSIZE = {"f32": 4, "bf16": 2, "int8": 1}


def _warp_bytes(dtype: str, nb: int) -> int:
    fbuf = (_NSLOT if dtype == "f32" else 2) * _SLOT * 4
    raw = 0 if dtype == "f32" else _NSLOT * _SLOT * _ITEMSIZE[dtype]
    return fbuf + raw + 5 * 32 * nb * 4 + 32 * nb


def kernel_spec(d: int, rows: int, m: int, dtype: str = "f32", sms: int = K.H100_SMS,
                label: str = "") -> K.LaunchSpec:
    """The launch :func:`rng_prune` (``dtype`` "f32"/"bf16") or
    :func:`rng_prune_int8` ("int8") makes for ``rows`` rows of ``m``
    candidates over a corpus of width ``d``: persistent blocks of 4 warps,
    as many as ``sms`` SMs hold at the claimed residency (3 blocks an SM for
    rows of up to 128, 2 for the wide instance), each opting in to its
    dynamic shared memory."""
    if dtype not in _ITEMSIZE:
        raise ValueError(f"unknown dtype {dtype!r}: expected one of {tuple(_ITEMSIZE)}")
    limit = MAX_M_INT8 if dtype == "int8" else MAX_M
    if not 1 <= m <= limit:
        raise ValueError(f"m={m} outside the kernel's 1..{limit}")
    wide = m > MAX_M_BUILD
    nb = 8 if wide else 4
    entry = ("rng_prune_int8" if dtype == "int8" else
             "rng_prune_wide" if wide else "rng_prune")
    per_sm = 2 if wide else 3
    instance = {"f32": 0, "bf16": 1, "int8": 2}[dtype]
    problem = (d, rows, m) if dtype == "int8" else (d, rows, m, int(dtype == "bf16"))
    t = {"f32": "float", "bf16": "__nv_bfloat16", "int8": "int8_t"}[dtype]
    return K.LaunchSpec(
        name=f"{entry}[{dtype}]@{label or f'{rows}x{m},d={d}'}", entry=entry,
        source="rng_prune_wide" if wide else "rng_prune", instance=instance,
        instance_name=f"rng_prune_kernel<{t}, {nb}>", problem=problem,
        grid=(min(K.cdiv(rows, _WARPS), sms * per_sm), 1, 1), threads=32 * _WARPS,
        dyn_smem=_WARPS * _warp_bytes(dtype, nb) + (8 * d if dtype == "int8" else 0),
        opt_in=True, blocks_per_sm=per_sm, persistent=True)


def default_specs(sms: int = K.H100_SMS) -> list[K.LaunchSpec]:
    """The main path's prune launches and their edges: a 1M build's sweeps
    at d = 128 (SIFT1M) and 960 (GIST1M) and M = 128, NSG-style's rows of
    C = 132 candidates at 1M, the int8 build at both widths; a one-row
    launch; every instance (f32, bf16, int8; rows of <= 128 and <= 256)."""
    out = []
    for d in (128, 960):
        for dt in ("f32", "bf16", "int8"):
            out.append(kernel_spec(d, 1_000_000, 128, dt, sms, f"1M x 128, d={d}"))
    for dt in ("f32", "bf16"):
        out.append(kernel_spec(128, 1_000_000, 132, dt, sms, "NSG C=132, 1M x 128"))
        out.append(kernel_spec(960, 1_000_000, 256, dt, sms, "M=256 edge, 1M x 960"))
    out.append(kernel_spec(128, 1, 1, "f32", sms, "one row"))
    out.append(kernel_spec(960, 2**31 - 1, 128, "int8", sms, "rows = 2^31 - 1 edge"))
    return out
