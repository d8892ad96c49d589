"""Host-side topology and schedule machinery of the port (torch + numpy)."""
