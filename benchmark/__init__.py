"""The benchmark of the PyTorch and CUDA port: one command, one cell, one
run (``python benchmark/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``).  Everything that measures or judges lives here; from the
port it takes only the system under test."""
