"""Configurations of the port (copies of the JAX package's ``configs``)."""
