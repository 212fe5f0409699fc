"""The benchmark of the PyTorch and CUDA port (`pose2mesh_release_tpu_torch`):
`python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`."""
