"""portbench: the benchmark of ``karpenter_tpu_torch`` on one NVIDIA H100.

``BENCHMARK.json`` at the root of the repository names its cells; one run
of one cell is ``python -m portbench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (``run.py``). The yardstick lives here and
nowhere else: the general generator (``gen.py``) and its data
(``configs/``, ``traffic/``), the plain reference (``reference/``), the
peaks and the least time of a kernel (``roofline.py``), the reduction of
the profiler's trace (``devtrace.py``) and one reader per per-layer metric
(``metrics/``). Only ``system.py`` imports the program.
"""
