"""The benchmark of ``repro_torch`` on one H100: one command runs one cell
(``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>``). Everything a cell needs is found by name from ``BENCHMARK.json``:
``configs/<config>.json``, ``mixes/<traffic>.json`` (whose ``kind`` names a
module in ``kinds/``), ``limits/<cell>.json`` and ``metrics/<metric>.py``."""
