"""Data streams of the port (``repro/data``): synthetic token batches, the
byte corpus of the character LM and the planted sparse teacher."""
