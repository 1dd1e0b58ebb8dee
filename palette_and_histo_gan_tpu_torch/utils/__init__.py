"""Host-side helpers: the metrics writer and time formatting."""
