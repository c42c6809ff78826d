"""Host-facing agents over the port's nets: the policy players and the
device-search player."""
