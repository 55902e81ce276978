"""Config composition, the YAML subset it reads, and the sweepers."""
