"""The benchmark of ``marlin_tpu_torch``: ``python3 portbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` (see
``harness.py``)."""
