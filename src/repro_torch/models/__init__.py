"""Model zoo: the GNN families (``models.gnn``) in torch, with the
shared building blocks (``models.common``) and the loader of the JAX
package's parameter trees (``models.convert``)."""
