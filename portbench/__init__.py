"""The benchmark of the PyTorch/CUDA port (``repro_torch``): CORE object
serving and node repair on one H100, timed on the host's wall clock.
Run ``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the repository root."""
