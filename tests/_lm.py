"""Shared helpers of the transformer parity tests (JAX reference on the CPU
against the port): config pairs, converted weights, tolerances."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import dbrx_132b as j_dbrx
from repro.configs import deepseek_moe_16b as j_ds
from repro.configs import granite_20b as j_granite
from repro.configs import minitron_4b as j_min
from repro.configs import yi_34b as j_yi
from repro.models import transformer as T
from repro_torch import convert
from repro_torch.configs import dbrx_132b, deepseek_moe_16b, granite_20b, minitron_4b, yi_34b

PAIRS = {"minitron-4b": (j_min, minitron_4b), "granite-20b": (j_granite, granite_20b),
         "yi-34b": (j_yi, yi_34b), "dbrx-132b": (j_dbrx, dbrx_132b),
         "deepseek-moe-16b": (j_ds, deepseek_moe_16b)}
TOL = {"f32": (1e-5, 1e-4), "bf16": (3e-2, 6e-2)}     # (values, gradients)


def _cfgs(arch_id, precision="f32", **kw):
    jm, pm = PAIRS[arch_id]
    jcfg, pcfg = jm.SMOKE, pm.SMOKE
    if precision == "f32":
        kw = dict(kw, compute_dtype=None)
    jkw = {k: (jnp.float32 if k == "compute_dtype" else v) for k, v in kw.items()}
    pkw = {k: (torch.float32 if k == "compute_dtype" else v) for k, v in kw.items()}
    return dataclasses.replace(jcfg, **jkw), dataclasses.replace(pcfg, **pkw)


def _params(jcfg, pcfg, seed=0):
    params = jax.tree.map(np.asarray, T.init(jax.random.PRNGKey(seed), jcfg)[0])
    return params, convert.transformer_params_from_numpy(params, pcfg, "cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, what=""):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    lim = tol * float(np.abs(w).max()) + 1e-30
    err = float(np.abs(g - w).max())
    assert err <= lim, (what, err, lim)
