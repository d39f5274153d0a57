"""Tools of the port that run on the card: the gather-rate probe
(:mod:`.bench_gather`), the 2-D paths' step time and synchronising calls
(:mod:`.bench_step`), K24's time cut after each phase
(:mod:`.probe_dose3d`), the probes of K18/K19, K21, K4 and K6
(:mod:`.probe_cone_adjoint`, :mod:`.probe_kb_adjoint`,
:mod:`.probe_fan_backproject`, :mod:`.probe_parallel_backproject`, whose
``--steps`` builds ``k6_steps.cu``), and K4's redesign steps
(:mod:`.probe_k4_steps` over ``k4_steps.cu``)."""
