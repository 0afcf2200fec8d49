"""portbench: the benchmark of ``karpenter_tpu_torch`` on one NVIDIA H100.

``BENCHMARK.json`` at the root of the repository names its cells; one run
of one cell is ``python -m portbench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (``run.py``). The yardstick lives here and
nowhere else: the generators and their data (``gen.py``, ``fleet.py``,
``configs/``, ``traffic/``), the plain references (``reference/``), the
peaks and the least time of a kernel (``roofline.py``), the reduction of
the profiler's trace (``devtrace.py``) and one reader per per-layer metric
(``metrics/``). A traffic mix names its decision kind (``kinds/``:
provisioning, consolidation), which ties its generator, its program side
and its reference together. Only the program sides (``system.py``,
``disrupt.py``) and the readers of the program's own counters import the
program.
"""
