"""wide-deep [arXiv:1606.07792]: n_sparse=40 embed_dim=32 mlp=1024-512-256
interaction=concat. multi_hot=4 exercises the EmbeddingBag reduce."""
from repro_torch.configs.base import criteo_vocab_sizes, make_recsys_arch
from repro_torch.models.recsys import RecsysConfig

FULL = RecsysConfig(
    name="wide-deep", arch="wide_deep", n_fields=40, embed_dim=32,
    vocab_sizes=criteo_vocab_sizes(40), multi_hot=4,
    mlp_dims=(1024, 512, 256), interaction="concat",
)

SMOKE = RecsysConfig(
    name="wide-deep-smoke", arch="wide_deep", n_fields=6, embed_dim=8,
    vocab_sizes=criteo_vocab_sizes(6, reduced=True), multi_hot=4,
    mlp_dims=(32, 16), interaction="concat",
)

ARCH = make_recsys_arch("wide-deep", FULL, SMOKE)
