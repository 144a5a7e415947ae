"""Model zoo: the LM family (``models.transformer``, ``models.moe``), the
GNN families (``models.gnn``) and DCN-v2 (``models.recsys``) in torch,
with the shared building blocks (``models.common``) and the loader of
the JAX package's parameter trees (``models.convert``)."""
