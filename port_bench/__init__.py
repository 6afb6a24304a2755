"""The benchmark of the PyTorch and CUDA port (kgl_gene_tpu_torch) on the H100.

python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>
runs one cell of BENCHMARK.json once. The harness finds everything of a
cell by name: configs/<config>.json, traffic/<traffic>.json,
drivers/<driver>.py and metrics/<metric>.py (or metrics/<the metric's
name up to its first dot>.py). reference/ is the plain
reference that decides `correct`; it imports nothing of the port.
"""
