"""glm4-9b [hf:THUDM/glm-4-9b]: 40L d_model=4096 32H (GQA kv=2)
d_ff=13696 vocab=151552, RoPE."""
from repro_torch.configs.registry import ArchSpec, _lm_cells, register
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="glm4-9b",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_head=128,
    d_ff=13696, vocab=151552, rope_theta=1e4,
)

SMOKE = TransformerConfig(
    name="glm4-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
    d_ff=128, vocab=256,
    q_chunk=16, kv_chunk=16, loss_chunk=16, remat=False,
)

register(ArchSpec(
    arch_id="glm4-9b", family="lm", config=FULL, smoke=SMOKE,
    cells=_lm_cells(),
))
