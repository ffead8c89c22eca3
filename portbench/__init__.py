"""The benchmark of the PyTorch/CUDA port (``s3shuffle_tpu_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on one card; ``portbench/README.md``
says how the harness finds configurations, traffic mixes and metrics by
name. Nothing here imports the JAX package.
"""
