"""The benchmark of `repro_torch` on one H100: `python3 bench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>` from the root of a
checkout.  Cells, configurations, traffic mixes and metrics are the entries
of `BENCHMARK.json` and the files they name under `bench/`."""
