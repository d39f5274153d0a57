"""Tools of the port that run on the card: the gather-rate probe
(:mod:`.bench_gather`)."""
