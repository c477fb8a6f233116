"""Model families of the port (dense transformer) and their serving caches."""
