"""Host-facing agents over the port's nets."""
