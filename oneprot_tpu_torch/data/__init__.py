"""Host-side data layer of the port (numpy only)."""
