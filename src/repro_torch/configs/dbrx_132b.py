"""dbrx-132b [hf:databricks/dbrx-base]: 40L d_model=6144 48H (GQA kv=8)
d_ff=10752/expert, vocab=100352, MoE 16 experts top-4 (fine-grained)."""
from repro_torch.configs.base import make_lm_arch
from repro_torch.models.transformer import MoEConfig, TransformerConfig

FULL = TransformerConfig(
    name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=0, vocab=100352, d_head=128,
    moe=MoEConfig(n_experts=16, top_k=4, n_shared=0, d_ff=10752),
)

SMOKE = TransformerConfig(
    name="dbrx-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=0, vocab=512, d_head=16, q_chunk=16, ce_chunk=16,
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=0, d_ff=32, capacity_factor=2.0),
)

ARCH = make_lm_arch("dbrx-132b", FULL, SMOKE)
