"""hydrobench: the benchmark of ``pydem_tpu_torch`` on one NVIDIA H100.

``python hydrobench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout; see ``run.py``.  Everything a
cell needs is data found by name: ``configs/<config>.json`` (with its entry
adapter ``entries/<entry>.py``), ``traffic/<traffic>.json`` (with its
terrain generator ``terrain/<kind>.py``) and one reader a per-layer metric,
``metrics/<name>.py``.
"""
