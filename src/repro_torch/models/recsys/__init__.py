"""RecSys models: the EmbeddingBag substrate and DCN-v2 (torch)."""
from repro_torch.models.recsys.embedding import (embedding_bag,
                                                 init_embedding_bag)
from repro_torch.models.recsys.dcn_v2 import (DCN, DCNConfig, dcn_forward,
                                              dcn_loss, dcn_retrieval_scores,
                                              init_dcn)

__all__ = ["init_embedding_bag", "embedding_bag", "DCN", "DCNConfig",
           "init_dcn", "dcn_forward", "dcn_loss", "dcn_retrieval_scores"]
