"""The benchmark of palette_and_histo_gan_tpu_torch on an NVIDIA H100.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once. Everything that
belongs to one configuration, traffic mix, cell or per-layer metric is a
file of its own, found by the name BENCHMARK.json gives it:
configs/<config>.json, models/<model>.py for the model a configuration
names (its data, weights, reference steps, FLOP count and what the harness
hands the program and reads back), traffic/<traffic>.json,
limits/<cell>.json, metrics/<metric>.py, and entries/<entry>.py for the
program's entry point that a traffic mix drives. counts/ holds the frozen
yardstick (FLOPs, peaks, the histogram's work, the range attribution, the
weight draw, the data generator), reference/ the plain float32 PyTorch
reference that decides `correct`.
"""
