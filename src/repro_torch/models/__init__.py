"""Model code of the port (dense-family transformer)."""
