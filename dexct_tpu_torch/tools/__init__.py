"""Tools of the port that run on the card: the gather-rate probe
(:mod:`.bench_gather`) and the default path's step time
(:mod:`.bench_step`)."""
