"""Front ends: the GTP engine and the self-play CLI."""
