"""xdeepfm [arXiv:1803.05170]: n_sparse=39 embed_dim=10 cin=200-200-200
mlp=400-400 interaction=cin (compressed interaction network)."""
from repro_torch.configs.base import criteo_vocab_sizes, make_recsys_arch
from repro_torch.models.recsys import RecsysConfig

FULL = RecsysConfig(
    name="xdeepfm", arch="xdeepfm", n_fields=39, embed_dim=10,
    vocab_sizes=criteo_vocab_sizes(39),
    mlp_dims=(400, 400), cin_dims=(200, 200, 200), interaction="cin",
)

SMOKE = RecsysConfig(
    name="xdeepfm-smoke", arch="xdeepfm", n_fields=6, embed_dim=8,
    vocab_sizes=criteo_vocab_sizes(6, reduced=True),
    mlp_dims=(32,), cin_dims=(16, 16), interaction="cin",
)

ARCH = make_recsys_arch("xdeepfm", FULL, SMOKE)
