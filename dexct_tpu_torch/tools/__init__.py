"""Tools of the port that run on the card: the gather-rate probe
(:mod:`.bench_gather`), the default path's step time (:mod:`.bench_step`)
and K24's time cut after each phase (:mod:`.probe_dose3d`)."""
