"""Training core of the port: optimizer and the packed train steps."""
