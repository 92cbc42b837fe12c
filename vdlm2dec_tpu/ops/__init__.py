"""Device compute path: vectorised JAX ops for the VDL-M2 pipeline."""
