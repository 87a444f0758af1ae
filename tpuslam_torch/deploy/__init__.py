"""Deployment of the port: the multi-process smoke (`multihost_smoke`); the
image and compose file are `deploy/torch/` at the repository's root."""
