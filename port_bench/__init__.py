"""The benchmark of ``r3m_tpu_torch`` on one NVIDIA H100: ``python3 port_bench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` (see README.md)."""
