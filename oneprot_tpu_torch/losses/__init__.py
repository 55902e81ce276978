"""Contrastive losses of the port."""
