"""The benchmark of booster_gym_torch on NVIDIA H100s.

    python3 -m gymbench.run --workload NAME --seed N --seconds S --trace 0|1

runs one cell of BENCHMARK.json once, from the root of a checkout, and
prints one JSON line.  Everything here is found by name: a cell's
configuration in configs/<config>.json, its traffic in
traffic/<traffic>.json, its correctness limits in limits/<workload>.json,
each per-layer metric's reader in metrics/<metric>.py.  The yardstick
(the plain reference, the operation and byte counts, the peaks, the
profiler arithmetic and the comparisons) lives here and imports nothing of
the program: the program under test is booster_gym_torch, which the loop
in train.py drives through its public entry points.
"""
