"""dimenet [arXiv:2003.03123]: n_blocks=6 d_hidden=128 n_bilinear=8
n_spherical=7 n_radial=6 cutoff=5. Per-shape d_feat/n_out/triplet_impl come
from the shape table (configs/base.GNN_SHAPES)."""
from repro_torch.configs.base import make_gnn_arch
from repro_torch.models.dimenet import DimeNetConfig

FULL = DimeNetConfig(
    name="dimenet", n_blocks=6, d_hidden=128, n_bilinear=8,
    n_spherical=7, n_radial=6,
)

SMOKE = DimeNetConfig(
    name="dimenet-smoke", n_blocks=2, d_hidden=32, n_bilinear=4,
    n_spherical=4, n_radial=3,
)

ARCH = make_gnn_arch("dimenet", FULL, SMOKE)
