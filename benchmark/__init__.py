"""The benchmark of speedy_tpu_torch on an NVIDIA H100: one cell of
BENCHMARK.json run once by ``python3 -m benchmark.run`` (harness.py), its
traffic and configurations as data files, its drivers and metric readers
found by name, and the yardstick the program cannot move: the frozen
counts and peaks, the trace reader, and the plain reference the check
compares against."""
