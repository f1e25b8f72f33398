"""deepfm [arXiv:1703.04247]: n_sparse=39 embed_dim=10 mlp=400-400-400
interaction=fm (shared embeddings between FM and deep tower)."""
from repro_torch.configs.base import criteo_vocab_sizes, make_recsys_arch
from repro_torch.models.recsys import RecsysConfig

FULL = RecsysConfig(
    name="deepfm", arch="deepfm", n_fields=39, embed_dim=10,
    vocab_sizes=criteo_vocab_sizes(39),
    mlp_dims=(400, 400, 400), interaction="fm",
)

SMOKE = RecsysConfig(
    name="deepfm-smoke", arch="deepfm", n_fields=6, embed_dim=8,
    vocab_sizes=criteo_vocab_sizes(6, reduced=True),
    mlp_dims=(32, 16), interaction="fm",
)

ARCH = make_recsys_arch("deepfm", FULL, SMOKE)
