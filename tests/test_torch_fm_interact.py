"""Port parity: the FM second-order interaction (``kernels.fm_interact``)
against the reference's Pallas kernel (interpret mode on the CPU, as
``tests/test_kernels.py`` runs it) and its jnp oracle.

Both sides upcast to f32 and sum the same terms, possibly in another
order, so each row is held to 1e-5 of its magnitude bound
``0.5 * sum_d (sum_f |e_fd|)^2`` (both terms of the sum-square trick are at
most that), plus 1e-30 for all-zero rows. bf16 inputs are the same bits on
both sides (round-to-nearest-even from the same f32 draw).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fm_interact import fm_interact as jax_fm_interact
from repro.kernels.fm_interact import fm_interact_ref as jax_fm_interact_ref
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.fm_interact import ops as FM
from repro_torch.kernels.fm_interact.ref import fm_interact_ref

torch.set_num_threads(1)

SWEEP = [(4, 3, 8), (512, 39, 10), (1000, 40, 32), (64, 26, 128)]
TOL = 1e-5


def _emb(seed, shape, dtype):
    """The same input on both sides: (torch tensor, jnp array, f64 numpy)."""
    e = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(e)
    if dtype == "bf16":
        t = t.bfloat16()
        j = jnp.asarray(e).astype(jnp.bfloat16)
    else:
        j = jnp.asarray(e)
    return t, j, t.double().numpy()


def _scale(e64):
    return 0.5 * (np.abs(e64).sum(axis=1) ** 2).sum(axis=-1) + 1e-30


def _hold(got, want, e64):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)) / _scale(e64)
    assert err.max() <= TOL, f"error {err.max()} of the row scale > {TOL}"


@pytest.mark.parametrize("b,f,d", SWEEP)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fm_interact_matches_reference_kernel_and_oracle(b, f, d, dtype):
    t, j, e64 = _emb(b + f + d, (b, f, d), dtype)
    got = FM.fm_interact(t)
    assert got.shape == (b,) and got.dtype == torch.float32
    # on the CPU the wrapper is the plain version, bit for bit
    assert torch.equal(got, fm_interact_ref(t))
    _hold(got.numpy(), jax_fm_interact(j, tile_b=256), e64)
    _hold(got.numpy(), jax_fm_interact_ref(j), e64)


@pytest.mark.parametrize("b,f,d", [(16, 7, 5), (512, 39, 10)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fm_interact_matches_explicit_pairs(b, f, d, dtype):
    """Sum-square trick == the explicit sum over <v_i, v_j> pairs, in f64."""
    t, _, e64 = _emb(7 * b + f, (b, f, d), dtype)
    gram = np.einsum("bfd,bgd->bfg", e64, e64)            # every pair <e_f, e_g>
    explicit = 0.5 * (gram.sum(axis=(1, 2)) - np.trace(gram, axis1=1, axis2=2))
    _hold(FM.fm_interact(t).numpy(), explicit, e64)


def test_fm_interact_empty_batch_and_bad_inputs():
    before = dict(LAUNCHES)
    for dtype in (torch.float32, torch.bfloat16):
        out = FM.fm_interact(torch.zeros((0, 39, 10), dtype=dtype))
        assert out.shape == (0,) and out.dtype == torch.float32
    # the reference's Pallas wrapper cannot take B = 0 in interpret mode;
    # its oracle gives the same empty result
    assert jax_fm_interact_ref(jnp.zeros((0, 39, 10))).shape == (0,)
    with pytest.raises(ValueError):
        FM.fm_interact(torch.zeros((4, 10)))
    with pytest.raises(ValueError):
        FM.fm_interact(torch.zeros((4, 3, 10), dtype=torch.float64))
    with pytest.raises(ValueError):
        FM.fm_interact(torch.zeros((4, 0, 10)))
    assert LAUNCHES == before, "the CPU path launched a kernel"


def test_fm_interact_non_contiguous_input():
    t, _, _ = _emb(5, (40, 10, 6), "f32")
    view = t.transpose(1, 2)                               # (40, 6, 10), strided
    assert torch.equal(FM.fm_interact(view), FM.fm_interact(view.contiguous()))
