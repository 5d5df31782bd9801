"""The benchmark of abismal_tpu_torch: python3 abismal_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>."""
