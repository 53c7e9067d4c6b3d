"""GNN models and flax weight conversion."""
