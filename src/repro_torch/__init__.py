"""PyTorch port of the collaborative-reuse stream system (see README)."""
