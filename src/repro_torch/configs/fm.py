"""fm [Rendle ICDM'10]: n_sparse=39 embed_dim=10, pairwise <v_i, v_j> x_i x_j
via the O(nk) sum-square trick (kernels/fm_interact)."""
from repro_torch.configs.base import criteo_vocab_sizes, make_recsys_arch
from repro_torch.models.recsys import RecsysConfig

FULL = RecsysConfig(
    name="fm", arch="fm", n_fields=39, embed_dim=10,
    vocab_sizes=criteo_vocab_sizes(39), interaction="fm-2way",
)

SMOKE = RecsysConfig(
    name="fm-smoke", arch="fm", n_fields=6, embed_dim=8,
    vocab_sizes=criteo_vocab_sizes(6, reduced=True), interaction="fm-2way",
)

ARCH = make_recsys_arch("fm", FULL, SMOKE)
