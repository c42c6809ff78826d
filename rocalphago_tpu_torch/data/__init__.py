"""Game records: the SGF reader and writer (:mod:`.sgf`)."""
