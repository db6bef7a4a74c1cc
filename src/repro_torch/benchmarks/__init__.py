"""Benchmarks of the port, run on the card: the paper's Fig. 5 A/B
(``bench_mriq``) and the H100 spec's energy constants
(``calibrate_power``)."""
