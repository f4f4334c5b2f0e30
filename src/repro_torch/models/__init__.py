"""Model definitions of the port (dense transformer family)."""
