"""Model configuration and the attention-only transformer the slice
serves."""
