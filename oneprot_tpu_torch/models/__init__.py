"""Model layer of the port: ESM2, heads and encoders."""
