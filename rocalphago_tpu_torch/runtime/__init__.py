"""Runtime: the hard move deadline (:mod:`.deadline`), the pipelined
chunk dispatch (:mod:`.pipeline`) and atomic file writes
(:mod:`.atomic`)."""
