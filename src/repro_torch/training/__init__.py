"""Train and topology-update steps of the port (``repro/training``)."""
