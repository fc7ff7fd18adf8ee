"""Math ops on torch tensors."""
