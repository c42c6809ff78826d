"""Runtime: the hard move deadline (:mod:`.deadline`), the pipelined
chunk dispatch (:mod:`.pipeline`), atomic file writes (:mod:`.atomic`),
retries (:mod:`.retries`), the training watchdog (:mod:`.watchdog`) and
the supervised worker fleet (:mod:`.supervisor`)."""
