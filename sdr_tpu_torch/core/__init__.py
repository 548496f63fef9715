"""Configs and keyed randomness of the port."""
