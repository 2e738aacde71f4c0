"""The benchmark of the PyTorch and CUDA port (unicorn_torch): its harness,
traffic generators, per-layer metric readers, yardsticks and plain
reference. Run it as `python3 benchmark/run.py --workload <name> ...`."""
