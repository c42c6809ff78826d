"""Front ends: the GTP engine."""
