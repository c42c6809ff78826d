"""Serving runtime: the hard move deadline (:mod:`.deadline`) and the
pipelined chunk dispatch (:mod:`.pipeline`)."""
