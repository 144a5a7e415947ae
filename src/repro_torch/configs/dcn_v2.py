"""dcn-v2 [arXiv:2008.13535]: 13 dense + 26 sparse fields, embed_dim=16,
3 cross layers, MLP 1024-1024-512. Criteo-like heavy-tailed vocab mix
(largest tables 10M rows => 47M embedding rows total; one card holds them
all)."""
from repro_torch.configs.registry import ArchSpec, _recsys_cells, register
from repro_torch.models.recsys.dcn_v2 import DCNConfig

VOCABS = tuple([10_000_000] * 4 + [1_000_000] * 6 + [100_000] * 8
               + [10_000] * 8)

FULL = DCNConfig(n_dense=13, n_sparse=26, embed_dim=16, n_cross_layers=3,
                 mlp_dims=(1024, 1024, 512), vocab_sizes=VOCABS)
SMOKE = DCNConfig(n_dense=13, n_sparse=4, embed_dim=8, n_cross_layers=2,
                  mlp_dims=(32, 16), vocab_sizes=(64, 32, 128, 16))

register(ArchSpec(arch_id="dcn-v2", family="recsys", config=FULL,
                  smoke=SMOKE, cells=_recsys_cells(),
                  notes="EmbeddingBag = take + segment_sum; tables "
                        "row-sharded on 'model'."))
