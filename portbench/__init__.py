"""The benchmark of the PyTorch and CUDA port (vqcpcb_tpu_torch): one cell
a run, `python portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`, as BENCHMARK.json at the root of the checkout names them."""
